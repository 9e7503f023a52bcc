"""Serving: the continuous-batching engine over the fused decode block."""
from repro_torch.serve.engine import (Request, ServeEngine, decode_exec_config,
                                      shape_exec_config)

__all__ = ["Request", "ServeEngine", "decode_exec_config",
           "shape_exec_config"]
