from repro_torch.configs.base import (
    ARCH_IDS,
    ArchConfig,
    MoEConfig,
    RGLRUConfig,
    SHAPES,
    ShapeConfig,
    SparsityConfig,
    SSMConfig,
    get_config,
    get_smoke_config,
)

__all__ = [
    "ARCH_IDS", "ArchConfig", "MoEConfig", "RGLRUConfig", "SHAPES",
    "ShapeConfig", "SparsityConfig", "SSMConfig", "get_config",
    "get_smoke_config",
]
