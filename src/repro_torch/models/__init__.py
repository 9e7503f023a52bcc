"""The dense decoder family, ported (norms, MLP, rope, attention with KV
caches, the layer stack and the decode/prefill entry points)."""
