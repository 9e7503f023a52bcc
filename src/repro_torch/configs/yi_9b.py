"""Yi-9B [arXiv:2403.04652; hf] — llama-arch GQA.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    rope="full",
    rope_theta=10_000.0,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="yi-9b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab=256,
    )
