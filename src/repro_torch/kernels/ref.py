"""Plain PyTorch versions of the kernels (the JAX package's
``kernels/ref.py`` oracles).  The wrappers run these for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with float32 accumulation (plain version of every
    ``flex_matmul`` stationarity)."""
    return torch.matmul(a.float(), b.float())


def block_sparse_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                            meta) -> torch.Tensor:
    """Plain version of the two-sided block-sparse matmul: blocks outside
    the combined bitmap are zeroed (skipped, not approximated), then one
    dense float32 product — equal to the dense product whenever the bitmaps
    come from the data."""
    tm, tk = meta.a_bitmap.shape
    tn = meta.b_bitmap.shape[1]
    bm, bk, bn = a.shape[0] // tm, a.shape[1] // tk, b.shape[1] // tn
    a_mask = meta.a_bitmap.repeat_interleave(bm, 0).repeat_interleave(bk, 1)
    b_mask = meta.b_bitmap.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    a_z = torch.where(a_mask, a, torch.zeros((), dtype=a.dtype,
                                             device=a.device))
    b_z = torch.where(b_mask, b, torch.zeros((), dtype=b.dtype,
                                             device=b.device))
    return torch.matmul(a_z.float(), b_z.float())
