"""ChatGLM3-6B [arXiv:2406.12793; hf].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 — RoPE applied to half
the head dims ("2d" RoPE), GQA.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    rope="half",
    rope_theta=10_000.0,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="chatglm3-6b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab=256,
        rope="half",
    )
