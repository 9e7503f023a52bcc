"""Blockwise (flash) attention on Hopper — causal and sliding window.

Wrapper of the CUDA kernel in ``csrc/flash_attention.cu``, which replaces
the JAX package's Pallas kernel ``_fa_kernel`` (src/repro/kernels/
flash_attention.py:25, launched at :84): the online softmax over kv blocks
with the running (m, l, acc) kept on chip, and the kv blocks that lie wholly
in the masked region (the future of a causal q block, or older than the
window) skipped — the CSB idea applied to the structural mask.

Layout: heads flattened by the caller — q (BH, Sq, hd), k / v (BH, Skv, hd),
contiguous, all float32 or all bfloat16; the output has q's type.  The
kernel's blocks are fixed at (64, 64): Sq and Skv must be multiples of 64
(ragged lengths are refused, as the reference's wrapper asserts
divisibility), Sq <= Skv (the last Sq positions query), hd 32, 64, 128 or 256.

CPU tensors take the plain version in the kernel's order
(``ref.flash_attention_plain``); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_plain

BQ = BKV = 64                      # the kernel's q and kv block rows
HEAD_DIMS = (32, 64, 128, 256)

# launches of the CUDA kernel (bumped only where it is launched)
LAUNCHES = {"flash_attention": 0}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, Sq, hd), k / v (BH, Skv, hd) → (BH, Sq, hd) in q's type."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)},"
                         f" v {tuple(v.shape)}")
    bh, sq, hd = q.shape
    skv = k.shape[1]
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v differ in type: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    code = build.dtype_code(q.dtype)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if sq % BQ or skv % BKV or sq > skv:
        raise ValueError(f"Sq={sq}, Skv={skv}: both must be multiples of "
                         f"{BQ} with Sq <= Skv")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     bq=BQ, bkv=BKV)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    out = torch.empty_like(q)
    err = build.library("flash_attention").fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
        skv, hd, int(causal), int(window), hd ** -0.5, code,
        build.stream_ptr(q.device))
    build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
