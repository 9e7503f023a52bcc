"""Schedule-flexible dense matmul on Hopper — FlexNN's per-layer dataflow.

Wrappers of the CUDA kernels in ``csrc/flex_matmul.cu``, which replace the
JAX package's Pallas kernels ``_os_kernel`` (src/repro/kernels/
flex_matmul.py:52, launched at :102) and ``_revisit_kernel`` (:68, launched
at :118 weight-stationary and :133 input-stationary).  A ``MatmulSchedule``
descriptor picks the entry point and the (bm, bn, bk) blocks:

  output : one CUDA block per output-tile strip, K loop, accumulator in
           registers;
  weight : a block owns an N-strip, loops k holding its B tile in shared
           memory, then loops m, read-modify-writing a float32 output;
  input  : the mirror image over M-strips (A tile resident across n).

At decode (M = n_slots) all three are bound by device-memory bytes (the
weight read once).  CPU tensors take the plain version
(``ref.matmul_ref``); CUDA tensors launch a kernel or raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import matmul_ref

DEFAULT_BLOCKS = (128, 128, 128)

# launches of each CUDA entry point (bumped only where it is launched)
LAUNCHES = {"output": 0, "weight": 0, "input": 0}


def pad_to_blocks(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    """Zero-pad a 2-D operand up to block multiples (a no-op, and no copy,
    when it already is one).  Padding blocks are all-zero, so their bitmap
    bits are dead and the block-sparse path skips them."""
    p0 = (-x.shape[0]) % m0
    p1 = (-x.shape[1]) % m1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x


def _groups(own: int, other: int, device) -> int:
    """How many blocks share one strip's other axis so that a decode-shaped
    matmul (a single M-strip) still spreads over the card: about two
    blocks per SM in all, at most one per tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(other, (2 * sms) // max(own, 1)))


def _launch(a: torch.Tensor, b: torch.Tensor, stationarity: str, bm: int,
            bn: int, bk: int, out_dtype) -> torch.Tensor:
    if not a.is_contiguous():
        raise ValueError("A must be row-major contiguous")
    b_trans = build.b_layout(b)
    m, k = a.shape
    n = b.shape[1]
    tm, tn = m // bm, n // bn
    lib = build.library("flex_matmul")
    stream = build.stream_ptr(a.device)
    code = build.dtype_code(a.dtype)
    if stationarity == "output":
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
        err = lib.fm_output(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
                            k, bm, bn, bk, b_trans, code,
                            build.dtype_code(out_dtype), stream)
    elif stationarity in ("weight", "input"):
        # the revisit dataflows accumulate in a float32 output, cast after
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
        if stationarity == "weight":
            fn, groups = lib.fm_weight, _groups(tn, tm, a.device)
        else:
            fn, groups = lib.fm_input, _groups(tm, tn, a.device)
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, bm,
                 bn, bk, groups, b_trans, code, stream)
    else:
        raise ValueError(f"unknown stationarity {stationarity!r}")
    build.check(err, f"flex_matmul[{stationarity}]")
    LAUNCHES[stationarity] += 1
    return out.to(out_dtype)


def flex_matmul(a: torch.Tensor, b: torch.Tensor, *, schedule=None,
                out_dtype=None) -> torch.Tensor:
    """C[M, N] = A[M, K] @ B[K, N] under a FlexNN ``MatmulSchedule``.

    ``schedule`` carries (stationarity, bm, bn, bk); None uses the
    output-stationary default with 128³ blocks.  Blocks are clamped to the
    operand dims and the operands zero-padded to block multiples.  ``b``
    may be the transposed view of a row-major (N, K) matrix (the stored
    lm_head), which the kernels read in place."""
    if schedule is None:
        stationarity, (bm, bn, bk) = "output", DEFAULT_BLOCKS
    else:
        stationarity = schedule.stationarity
        bm, bn, bk = schedule.bm, schedule.bn, schedule.bk
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad operand shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device != b.device or a.dtype != b.dtype:
        raise ValueError(f"operands differ: {a.device}/{a.dtype} vs "
                         f"{b.device}/{b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    out_dtype = out_dtype or a.dtype
    ap = pad_to_blocks(a, bm, bk)
    bp = pad_to_blocks(b, bk, bn)
    if a.device.type == "cpu":
        if stationarity not in LAUNCHES:
            raise ValueError(f"unknown stationarity {stationarity!r}")
        out = matmul_ref(ap, bp).to(out_dtype)
    elif a.device.type == "cuda":
        out = _launch(ap, bp, stationarity, bm, bn, bk, out_dtype)
    else:
        raise ValueError(f"unsupported device {a.device}")
    return out[:m, :n]
