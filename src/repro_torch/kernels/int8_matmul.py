"""Dense int8-weight matmul on Hopper.

Wrapper of the CUDA kernel in ``csrc/int8_matmul.cu``, which replaces the
JAX package's Pallas kernel ``_int8_kernel`` (src/repro/kernels/
int8_matmul.py:24, launched at :57): C = (A @ Q) * scale with the
per-output-channel scales applied once to the finished float32 sum.  The
weight stays int8 in device memory — half the bf16 bytes a decode step
reads.  A bf16 activation runs on the tensor cores (Q widened to bf16 in
shared memory, exactly) under ``flex_matmul.output_grid``'s plan, the
kernel and plan of the scaled block-sparse product, so the two agree bit
for bit; a float32 activation runs scalar float32 FMAs.

CPU tensors take the plain version in the kernel's order
(``ref.int8_matmul_plain``); CUDA tensors launch the kernel or raise, and
fake ones (a trace) get the launch's allocations and no launch
(``accounting``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import accounting, build
from repro_torch.kernels.flex_matmul import (count_launch, pad_to_blocks,
                                             tensor_core_operands)
from repro_torch.kernels.ref import int8_matmul_plain

# launches of the CUDA kernels (bumped only where they are launched):
# ``int8_matmul_sum`` adds (and scales) the segment partials of a split
# bf16 grid
LAUNCHES = {"int8_matmul": 0, "int8_matmul_sum": 0}


def int8_matmul(a: torch.Tensor, qw, *, bm: int = 128, bn: int = 128,
                bk: int = 128, out_dtype=None) -> torch.Tensor:
    """C[M, N] = A[M, K] @ dequant(qw) with per-N scales.

    ``qw`` is a ``quant.QuantizedLinear`` (q int8 (K, N), scale float32
    (N,)).  A bf16 A on CUDA takes the operands as they are (the
    tensor-core kernel zero-fills every edge) and Q row-major; otherwise
    blocks are clamped to the operand dims and the operands zero-padded to
    block multiples (the scale too), as the reference's ``int8_matmul``
    does."""
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
    card = accounting.on_card(a)
    if card and a.dtype == torch.bfloat16:
        return _launch_mma(a, q, scale.contiguous(), (bm, bn, bk), out_dtype)
    ap = pad_to_blocks(a, bm, bk)
    qp = pad_to_blocks(q, bk, bn)
    sp = pad_to_blocks(scale[None], 1, bn)[0]
    if not card and a.device.type == "cpu":
        out = int8_matmul_plain(ap, qp, sp).to(out_dtype)
    elif card:
        out = _launch(ap.contiguous(), qp, sp.contiguous(), bm, bn, bk,
                      out_dtype)
    else:
        raise ValueError(f"unsupported device {a.device}")
    return out[:m, :n]


def _launch_mma(a, q, scale, blocks, out_dtype) -> torch.Tensor:
    """The tensor-core kernel on the unpadded operands, under the plan of
    ``output_grid`` for the product's own (M, N, K)."""
    if build.b_layout(q):
        raise ValueError("the int8 tensor-core kernel reads Q row-major "
                         "(K, N), as quant.quantize_weight stores it")
    m, k = a.shape
    n = q.shape[1]
    a, lda, q, ldq, plan, ws = tensor_core_operands(a.contiguous(), q, m)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    accounting.count("int8_matmul", 2 * m * n * k,
                     accounting.nbytes(a[:, :k], q[:k, :n], scale, out))
    if accounting.is_fake(a):
        return out
    err = build.library("int8_matmul").i8_matmul(
        a.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, n, k, lda, ldq, *blocks,
        plan.rows, plan.segment, 0, build.dtype_code(a.dtype),
        build.dtype_code(out_dtype), build.stream_ptr(a.device))
    build.check(err, "int8_matmul")
    count_launch(LAUNCHES, "int8_matmul", plan)
    return out


def _launch(a, q, scale, bm, bn, bk, out_dtype) -> torch.Tensor:
    """The float32 tile kernel on operands padded to the blocks."""
    m, k = a.shape
    n = q.shape[1]
    b_trans = build.b_layout(q)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    accounting.count("int8_matmul", 2 * m * n * k,
                     accounting.nbytes(a, q, scale, out))
    if accounting.is_fake(a):
        return out
    err = build.library("int8_matmul").i8_matmul(
        a.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), None,
        m, n, k, k, k if b_trans else n, bm, bn, bk, 0, 0, b_trans,
        build.dtype_code(a.dtype), build.dtype_code(out_dtype),
        build.stream_ptr(a.device))
    build.check(err, "int8_matmul")
    LAUNCHES["int8_matmul"] += 1
    return out
