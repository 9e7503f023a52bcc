"""Dense int8-weight matmul on Hopper.

Wrapper of the CUDA kernel in ``csrc/int8_matmul.cu``, which replaces the
JAX package's Pallas kernel ``_int8_kernel`` (src/repro/kernels/
int8_matmul.py:24, launched at :57): C = A @ dequant(Q) with the int8 tiles
widened to float32 in registers and the per-output-channel scales applied
once to the float32 accumulator.  The weight stays int8 in device memory —
half the bf16 bytes a decode step reads.

CPU tensors take the plain version in the kernel's order
(``ref.int8_matmul_plain``); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flex_matmul import pad_to_blocks
from repro_torch.kernels.ref import int8_matmul_plain

# launches of the CUDA kernel (bumped only where it is launched)
LAUNCHES = {"int8_matmul": 0}


def int8_matmul(a: torch.Tensor, qw, *, bm: int = 128, bn: int = 128,
                bk: int = 128, out_dtype=None) -> torch.Tensor:
    """C[M, N] = A[M, K] @ dequant(qw) with per-N scales.

    ``qw`` is a ``quant.QuantizedLinear`` (q int8 (K, N), scale float32
    (N,)).  Blocks are clamped to the operand dims and the operands
    zero-padded to block multiples (the scale too), as the reference's
    ``int8_matmul`` does."""
    q, scale = qw.q, qw.scale
    if a.dim() != 2 or q.dim() != 2 or a.shape[1] != q.shape[0]:
        raise ValueError(f"bad operand shapes {tuple(a.shape)} @ "
                         f"{tuple(q.shape)}")
    build.dtype_code(q.dtype, (torch.int8,))
    if (scale.dtype != torch.float32 or scale.shape != (q.shape[1],)
            or not a.device == q.device == scale.device):
        raise ValueError(f"int8_matmul takes a float32 scale of shape "
                         f"({q.shape[1]},) on A's device; got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}, Q on "
                         f"{q.device}")
    m, k = a.shape
    n = q.shape[1]
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    out_dtype = out_dtype or a.dtype
    ap = pad_to_blocks(a, bm, bk)
    qp = pad_to_blocks(q, bk, bn)
    sp = pad_to_blocks(scale[None], 1, bn)[0]
    if a.device.type == "cpu":
        out = int8_matmul_plain(ap, qp, sp).to(out_dtype)
    elif a.device.type == "cuda":
        out = _launch(ap.contiguous(), qp, sp.contiguous(), bm, bn, bk,
                      out_dtype)
    else:
        raise ValueError(f"unsupported device {a.device}")
    return out[:m, :n]


def _launch(a, q, scale, bm, bn, bk, out_dtype) -> torch.Tensor:
    m, k = a.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = build.library("int8_matmul").i8_matmul(
        a.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n,
        k, bm, bn, bk, build.b_layout(q),
        build.dtype_code(a.dtype), build.dtype_code(out_dtype),
        build.stream_ptr(a.device))
    build.check(err, "int8_matmul")
    LAUNCHES["int8_matmul"] += 1
    return out
