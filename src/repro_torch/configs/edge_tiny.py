"""edge-tiny: the 1-layer edge-class profile of the JAX package's
``benchmarks/bench_sparse_e2e.py::_edge_tiny_config`` — a config where
per-token host overhead dominates device compute.  It is already tiny, so
its smoke config is itself."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(name="edge-tiny", family="dense", n_layers=1,
                    d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
                    vocab=128, norm="rmsnorm")


def smoke_config() -> ArchConfig:
    return CONFIG
