"""Whisper-tiny [arXiv:2212.04356; unverified].

4L (enc + dec) d_model=384 6H d_ff=1536 vocab=51865 — encoder-decoder; the
conv frame frontend is a stub: ``input_specs`` feeds precomputed frame
embeddings to the encoder (per the assignment spec).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    norm="layernorm",
    act="gelu_plain",
    rope="none",          # learned/sinusoidal absolute positions
    encoder_decoder=True,
    frontend="audio",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        norm="layernorm", act="gelu_plain", rope="none",
        encoder_decoder=True, frontend="audio",
    )
