"""Parameter trees from the reference's numpy form into the port's.

The JAX package's parameter tree, turned into nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), becomes the same tree of torch
tensors on ``device``.  bf16 leaves (ml_dtypes arrays) cross bit for bit
through an int16 view, without importing ml_dtypes.  A quantized leaf (the
reference's ``QuantizedLinear`` named tuple of numpy arrays) becomes the
port's ``QuantizedLinear`` with an int8 payload and float32 scales.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quant.quantize import QuantizedLinear


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Mapping, device="cuda"):
    """Nested dict of numpy arrays → the same nested dict of tensors."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if getattr(x, "_fields", None) == ("q", "scale"):
            return QuantizedLinear(
                q=tensor_from_numpy(np.asarray(x.q, np.int8), dev),
                scale=tensor_from_numpy(np.asarray(x.scale, np.float32), dev))
        return tensor_from_numpy(np.asarray(x), dev)
    return conv(tree)
