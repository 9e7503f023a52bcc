"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b; unverified].

24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352 — partial rotary
(25% of head dims), LayerNorm.  Copied from the JAX package's config.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    head_dim=64,
    norm="layernorm",
    act="silu",
    rope="partial25",
    rope_theta=10_000.0,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-1.6b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=8, d_ff=160, vocab=256,
        norm="layernorm", rope="partial25",
    )
