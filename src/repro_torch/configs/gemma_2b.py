"""Gemma-2B [arXiv:2403.08295; hf].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000 — GeGLU, head_dim=256,
tied + sqrt(d)-scaled embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=256000,
    head_dim=256,
    norm="rmsnorm",
    act="gelu",
    rope="full",
    rope_theta=10_000.0,
    tie_embeddings=True,
    scale_embeddings=True,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="gemma-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=256, vocab=512,
        head_dim=16, act="gelu", tie_embeddings=True, scale_embeddings=True,
    )
