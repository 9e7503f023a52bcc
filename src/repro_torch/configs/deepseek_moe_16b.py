"""DeepSeek-MoE-16B [arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base].

28L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=102400, fine-grained
MoE: 2 shared + 64 routed top-6; the first layer is dense (d_ff 10944, the
published width).  Copied from the JAX package's config.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                # dense first layer hidden size
    vocab=102400,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    rope="full",
    moe=MoEConfig(
        n_experts=64, n_shared=2, top_k=6, expert_d_ff=1408,
        capacity_factor=1.25, first_dense_layers=1,
    ),
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192, vocab=256,
        moe=MoEConfig(n_experts=8, n_shared=1, top_k=2, expert_d_ff=48,
                      first_dense_layers=1),
    )
