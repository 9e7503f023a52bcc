"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — M-RoPE, dynamic
resolution.  The vision frontend is a stub: the batch's ``vis_embeds``
(precomputed patch embeddings) overwrite the leading positions, and its
``mrope_positions`` carry the t/h/w streams.  Copied from the JAX
package's config.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    rope="mrope",
    rope_theta=1_000_000.0,
    frontend="vision",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-72b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
        vocab=256, head_dim=8, rope="mrope", frontend="vision",
    )
