"""Plain PyTorch versions of the kernels (the JAX package's
``kernels/ref.py`` oracles).  The wrappers run these for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""
from __future__ import annotations

from typing import Optional

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with float32 accumulation (plain version of every
    ``flex_matmul`` stationarity)."""
    return torch.matmul(a.float(), b.float())


def block_sparse_matmul_ref(a: torch.Tensor, b: torch.Tensor, meta,
                            scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain version of the two-sided block-sparse matmul: blocks outside
    the combined bitmap are zeroed (skipped, not approximated), then one
    dense float32 product — equal to the dense product whenever the bitmaps
    come from the data.  ``scale`` (N,) marks an int8 ``b`` payload: the
    product of the masked payload is scaled once per output column."""
    tm, tk = meta.a_bitmap.shape
    tn = meta.b_bitmap.shape[1]
    bm, bk, bn = a.shape[0] // tm, a.shape[1] // tk, b.shape[1] // tn
    a_mask = meta.a_bitmap.repeat_interleave(bm, 0).repeat_interleave(bk, 1)
    b_mask = meta.b_bitmap.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    a_z = torch.where(a_mask, a, torch.zeros((), dtype=a.dtype,
                                             device=a.device))
    b_z = torch.where(b_mask, b, torch.zeros((), dtype=b.dtype,
                                             device=b.device))
    out = torch.matmul(a_z.float(), b_z.float())
    if scale is not None:
        out = out * scale.float()[None, :]
    return out


def int8_matmul_ref(a: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """The reference's oracle of the int8-weight matmul: dequantize to
    float32, then one float32 product."""
    w = q.float() * scale.float()[None, :]
    return torch.matmul(a.float(), w)


def int8_matmul_plain(a: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain version in the kernel's own order: the unscaled float32
    product of the int8 payload, scaled once per output column.  The
    scales are K-invariant, so this is ``int8_matmul_ref``'s function up to
    float32 rounding."""
    return torch.matmul(a.float(), q.float()) * scale.float()[None, :]
