"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1
plus one shared expert per layer; early-fusion multimodal frontend stubbed
(``vis_embeds`` as a prefix; rotary stays ``full``).  Copied from the JAX
package's config.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    rope="full",
    rope_theta=500_000.0,
    frontend="vision",
    moe=MoEConfig(n_experts=16, n_shared=1, top_k=1, expert_d_ff=8192,
                  capacity_factor=1.25),
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="llama4-scout-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128, vocab=256,
        frontend="vision",
        moe=MoEConfig(n_experts=4, n_shared=1, top_k=1, expert_d_ff=128),
    )
