"""Mamba2-1.3B [arXiv:2405.21060; unverified].

48L d_model=2048 (attention-free) vocab=50280, ssm_state=128 — SSD
(state-space duality), expand=2 (d_inner=4096), head_dim=64 (64 SSD heads),
conv4.  Sub-quadratic → runs the ``long_500k`` cell.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,           # no attention heads
    n_kv_heads=1,
    d_ff=0,              # no MLP — SSD block only
    vocab=50280,
    head_dim=64,
    norm="rmsnorm",
    rope="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    attn_free=True,
    subquadratic=True,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-1.3b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, d_ff=0, vocab=256,
        rope="none", tie_embeddings=True,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=16),
        attn_free=True, subquadratic=True,
    )
