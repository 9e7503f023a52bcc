"""Parameter and optimizer-state trees between the reference's numpy form
and the port's.

The JAX package's parameter tree, turned into nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), becomes the same tree of torch
tensors on ``device``.  bf16 leaves (ml_dtypes arrays) cross bit for bit
through an int16 view, without importing ml_dtypes.  A quantized leaf (the
reference's ``QuantizedLinear`` named tuple of numpy arrays) becomes the
port's ``QuantizedLinear`` with an int8 payload and float32 scales.

The other way (``params_to_numpy``, ``opt_state_to_numpy``), tensors
become numpy arrays; a bf16 tensor comes back widened to float32 (exact:
numpy has no bfloat16 of its own), and casting it to bfloat16 gives its
bits back.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quant.quantize import QuantizedLinear
from repro_torch.train.optimizer import OptState


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


def opt_state_from_numpy(state, device="cuda") -> OptState:
    """The reference's ``OptState`` (step, mu, nu), turned into numpy
    (``jax.tree.map(np.asarray, state)``), as the port's."""
    dev = resolve_device(device)
    step, mu, nu = state
    return OptState(
        step=tensor_from_numpy(np.asarray(step, np.int32), dev),
        mu=params_from_numpy(mu, dev), nu=params_from_numpy(nu, dev))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(tree):
    """Nested dict of tensors → the same nested dict of numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)


def opt_state_to_numpy(state: OptState):
    """The port's ``OptState`` as (step, mu, nu) of numpy arrays, the
    fields of the reference's."""
    return (tensor_to_numpy(state.step), params_to_numpy(state.mu),
            params_to_numpy(state.nu))
