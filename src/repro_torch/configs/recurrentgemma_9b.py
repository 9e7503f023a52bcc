"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000 — RG-LRU + local
attention in a 1:2 (attn : recurrent) pattern, window 2048.  Sub-quadratic →
runs the ``long_500k`` cell.

38 layers = 12 full (rec, rec, attn) triples + 2 trailing recurrent layers.
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    norm="rmsnorm",
    act="gelu",
    rope="full",
    window=2048,
    tie_embeddings=True,
    scale_embeddings=True,
    rglru=RGLRUConfig(lru_width=4096, d_conv=4,
                      block_pattern=("rec", "rec", "attn")),
    subquadratic=True,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=256,
        head_dim=16, act="gelu", window=32, tie_embeddings=True,
        scale_embeddings=True,
        rglru=RGLRUConfig(lru_width=64, d_conv=4,
                          block_pattern=("rec", "rec", "attn")),
        subquadratic=True,
    )
