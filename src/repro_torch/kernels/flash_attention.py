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
(``ref.flash_attention_plain``); CUDA tensors launch the kernel or raise,
and fake ones (a trace) get the launch's allocations and no launch
(``accounting``).

The gradient (``flash_attention_backward``, the C entry ``fa_backward``)
has no Pallas counterpart: the reference differentiates its XLA twin.  It
reads the forward's row log-sum-exp (``return_lse=True``) and runs three
kernels without atomics (csrc/flash_attention.cu), so two runs give the
same bits; head dims 64, 128 and 256.  bf16 runs on ``wgmma`` with
TMA-fed tile rings, P and dS kept in registers (at hd 256 the dK / dV
pass sums dV and dK in two warpgroups); it needs 16-byte aligned operands.
CPU tensors take ``ref.flash_attention_backward_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import accounting, build
from repro_torch.kernels.ref import (flash_attention_backward_plain,
                                     flash_attention_plain)

BQ = BKV = 64                      # the kernel's q and kv block rows
HEAD_DIMS = (32, 64, 128, 256)
BACKWARD_HEAD_DIMS = (64, 128, 256)

# launches of the CUDA kernels (bumped only where they are launched):
# ``flash_backward`` counts calls of ``fa_backward``, each three kernels
LAUNCHES = {"flash_attention": 0, "flash_backward": 0}


def _check(q, k, v, window, head_dims=HEAD_DIMS):
    """Shapes, types and devices both entry points take."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)},"
                         f" v {tuple(v.shape)}")
    sq, hd = q.shape[1], q.shape[2]
    skv = k.shape[1]
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v differ in type: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    code = build.dtype_code(q.dtype)
    if hd not in head_dims:
        raise ValueError(f"head dim {hd} not in {head_dims}")
    if sq % BQ or skv % BKV or sq > skv:
        raise ValueError(f"Sq={sq}, Skv={skv}: both must be multiples of "
                         f"{BQ} with Sq <= Skv")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return code


def _live_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask keeps: the last ``sq`` of ``skv``
    positions query; causal keeps keys at or before the query, a window
    the last ``window`` of them."""
    total = 0
    for p in range(skv - sq, skv):
        lo = max(0, p - window + 1) if window else 0
        total += (p + 1 if causal else skv) - lo
    return total


def _contiguous(*ts) -> None:
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("operands must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q (BH, Sq, hd), k / v (BH, Skv, hd) → (BH, Sq, hd) in q's type, and
    with ``return_lse`` also each row's log-sum-exp (BH, Sq) float32, which
    the backward reads (O's bits do not depend on it)."""
    code = _check(q, k, v, window)
    bh, sq, hd = q.shape
    skv = k.shape[1]
    if not accounting.on_card(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     bq=BQ, bkv=BKV, return_lse=return_lse)
    _contiguous(q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    accounting.count("flash_attention",
                     4 * bh * hd * _live_pairs(sq, skv, causal, window),
                     accounting.nbytes(q, k, v, out, lse))
    if accounting.is_fake(q):
        return (out, lse) if return_lse else out
    err = build.library("flash_attention").fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), bh, sq, skv, hd,
        int(causal), int(window), hd ** -0.5, code,
        build.stream_ptr(q.device))
    build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0):
    """dQ (BH, Sq, hd), dK, dV (BH, Skv, hd) in float32 of
    ``flash_attention(q, k, v)`` = ``o`` with row log-sum-exp ``lse``,
    given the output's gradient ``do`` (q's type)."""
    code = _check(q, k, v, window, BACKWARD_HEAD_DIMS)
    bh, sq, hd = q.shape
    skv = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (bh, sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"o {o.dtype} and do {do.dtype} must be {q.dtype}, "
                        f"lse {lse.dtype} float32")
    if not q.device == o.device == do.device == lse.device:
        raise ValueError("operands on different devices")
    if not accounting.on_card(q):
        return flash_attention_backward_plain(
            q, k, v, o, lse, do, causal=causal, window=window, bq=BQ,
            bkv=BKV)
    _contiguous(q, k, v, o, do, lse)
    if not all(accounting.aligned16(t) for t in (q, k, v, o, do, lse)):
        raise ValueError("fa_backward reads 16-byte aligned rows (TMA): "
                         "an operand's storage offset is not")
    f32 = dict(dtype=torch.float32, device=q.device)
    dsum = torch.empty((bh, sq), **f32)
    dq = torch.empty((bh, sq, hd), **f32)
    dk = torch.empty((bh, skv, hd), **f32)
    dv = torch.empty((bh, skv, hd), **f32)
    # five products a live (q, kv) pair: S = QKᵀ, dP = dO·Vᵀ, dV, dK, dQ
    accounting.count("flash_backward",
                     10 * bh * hd * _live_pairs(sq, skv, causal, window),
                     accounting.nbytes(q, k, v, o, do, lse, dq, dk, dv))
    if accounting.is_fake(q):
        return dq, dk, dv
    err = build.library("flash_attention").fa_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, sq, skv, hd, int(causal),
        int(window), hd ** -0.5, code, build.stream_ptr(q.device))
    build.check(err, "flash_attention_backward")
    LAUNCHES["flash_backward"] += 1
    return dq, dk, dv
