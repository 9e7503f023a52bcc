"""Two-sided block-sparse matmul — the CSB + CAG unit on Hopper.

Wrapper of the CUDA kernels in ``csrc/block_sparse.cu``, which replace the
JAX package's Pallas kernels ``_bs_kernel`` (src/repro/kernels/
block_sparse.py:49, launched at :114) and, for an int8 weight payload with
per-column scales, ``_bs_kernel_scaled`` (:69, launched at :155).  Each
CUDA block walks the compressed K-block lists (``BlockSparseMeta.kidx`` /
``kcnt``, built by ``core.sparsity``) of the output tiles it covers;
blocks where either operand is all-zero are never read nor multiplied, and
a tile with no live block writes zeros.  A bf16 activation runs on the
tensor cores, the kernel and launch plan (``flex_matmul.output_grid``) of
bf16 ``fm_output`` — or, over an int8 payload widened to bf16 in shared
memory, of bf16-activation ``i8_matmul`` — so each pair agrees bit for
bit; a float32 activation runs scalar float32 FMAs.  At decode the kernel
is bound by device-memory bytes (the live weight blocks), so the skipped
blocks — and, quantized, the int8 bytes — are the saving.

Over a leading expert axis — the MoE expert contraction (E, C, K) @
(E, K, N) under per-expert lists — a bf16 activation with C <= 16 (every
decode step) is one launch over all E experts, the grid's y axis picking
the expert, where the reference unrolls E Pallas launches; each expert's
result is bit-equal to its own launch.

CPU tensors take the plain version (``ref.block_sparse_matmul_ref``); CUDA
tensors launch a kernel or raise, and fake ones (a trace) get the launch's
allocations and no launch (``accounting``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import accounting, build
from repro_torch.kernels.flex_matmul import (OS_SKINNY_ROWS, count_launch,
                                             tensor_core_operands)
from repro_torch.kernels.ref import (block_sparse_expert_matmul_ref,
                                     block_sparse_matmul_ref, meta_at)

# launches of each CUDA kernel (bumped only where it is launched):
# ``*_sum`` adds (and, scaled, scales) the segment partials of a split
# bf16 grid; ``*_experts`` the expert-batched launches
LAUNCHES = {"block_sparse": 0, "block_sparse_sum": 0,
            "block_sparse_scaled": 0, "block_sparse_scaled_sum": 0,
            "block_sparse_experts": 0, "block_sparse_experts_sum": 0,
            "block_sparse_scaled_experts": 0,
            "block_sparse_scaled_experts_sum": 0}


def block_sparse_matmul(a: torch.Tensor, b: torch.Tensor, meta, *,
                        out_dtype=None, scale: Optional[torch.Tensor] = None,
                        rows: Optional[int] = None) -> torch.Tensor:
    """C = A @ B skipping CSB-dead (A-block, B-block) pairs.

    ``a`` (M, K) and ``b`` (K, N) must be block multiples of the metadata's
    bitmaps (pad first); ``b`` may be the transposed view of a row-major
    (N, K) matrix.  ``scale`` (N,) float32 marks ``b`` as an int8 payload:
    C = (A @ B) * scale, the scale applied once to the finished sum; with a
    bf16 A on CUDA the payload must be row-major.
    ``rows``: only A's first ``rows`` rows are the product's (the rest pad
    them to the blocks); C then has ``rows`` rows, and the bf16 kernels'
    launch plan follows that count, as ``fm_output``'s and
    ``int8_matmul``'s follow the unpadded M, so each pair agrees bit for
    bit whatever the blocks pad.
    Returns ``out_dtype`` (default: ``a.dtype``), computed with a float32
    accumulator.

    With a leading expert axis — ``a`` (E, M, K), ``b`` (E, K, N)
    row-major, ``scale`` (E, N), metadata whose tensors carry E in front
    (kidx (E, tm, tn, max_nnz), kcnt (E, tm, tn), bitmaps (E, tm, tk) and
    (E, tk, tn)) — C[e] = A[e] @ B[e]: on CUDA a bf16 activation with
    rows <= 16 is one launch over all experts, each expert bit-equal to
    its own launch; the wide regime and a float32 activation run the 2-D
    launch expert by expert.

    Dead must mean zero: every (A-block, B-block) pair that the metadata
    leaves out of a tile's list must have an all-zero A-block or B-block,
    as ``core.sparsity`` builds the lists from the operands.  The bf16
    kernel multiplies, over each CTA's output tile (16 or 128 rows by 128
    columns), the K-blocks live in any CSB tile it overlaps, so a block
    listed dead for one tile but live for a neighbour enters both; it adds
    exact zeros only if it is zero.  Nothing here checks that (it would
    read every block)."""
    out_dtype = out_dtype or a.dtype
    experts = a.dim() == 3
    lead = tuple(a.shape[:-2])
    tm, tk = meta.a_bitmap.shape[-2:]
    tn = meta.b_bitmap.shape[-1]
    if (a.dim() not in (2, 3) or b.dim() != a.dim()
            or tuple(b.shape[:-2]) != lead or a.shape[-1] != b.shape[-2]):
        raise ValueError(f"bad operand shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    bm, bk, bn = m // tm, k // tk, n // tn
    if bm * tm != m or bk * tk != k or bn * tn != n:
        raise ValueError(f"operands {tuple(a.shape)} @ {tuple(b.shape)} are "
                         f"not block multiples of the ({tm}, {tk}) x "
                         f"({tk}, {tn}) bitmaps")
    if experts and (tuple(meta.a_bitmap.shape[:-2]) != lead
                    or tuple(meta.b_bitmap.shape[:-2]) != lead):
        raise ValueError(f"metadata of bitmaps {tuple(meta.a_bitmap.shape)}"
                         f" / {tuple(meta.b_bitmap.shape)} is not per "
                         f"expert for {lead[0]} experts")
    rows = m if rows is None else rows
    if not 0 < rows <= m:
        raise ValueError(f"rows={rows} outside A's {m} rows")
    if scale is None:
        if a.device != b.device or a.dtype != b.dtype:
            raise ValueError(f"operands differ: {a.device}/{a.dtype} vs "
                             f"{b.device}/{b.dtype}")
    else:
        build.dtype_code(b.dtype, (torch.int8,))
        if (tuple(scale.shape) != lead + (n,) or scale.dtype != torch.float32
                or not scale.is_contiguous()
                or not a.device == b.device == scale.device):
            raise ValueError(f"a scaled product takes a contiguous float32 "
                             f"scale of shape {lead + (n,)} on A's device; "
                             f"got {scale.dtype} {tuple(scale.shape)} on "
                             f"{scale.device}, B on {b.device}")
    card = accounting.on_card(a)
    if not card and a.device.type == "cpu":
        ref = (block_sparse_expert_matmul_ref if experts
               else block_sparse_matmul_ref)
        return ref(a, b, meta, scale).to(out_dtype)[..., :rows, :]
    if not card:
        raise ValueError(f"unsupported device {a.device}")
    if experts and (a.dtype != torch.bfloat16 or rows > OS_SKINNY_ROWS):
        # one product a launch: the wide regime, the scalar float32 kernel
        return torch.stack([block_sparse_matmul(
            a[i], b[i], meta_at(meta, i), out_dtype=out_dtype,
            scale=None if scale is None else scale[i], rows=rows)
            for i in range(lead[0])])
    kidx, kcnt = meta.kidx, meta.kcnt
    if (tuple(kidx.shape) != lead + (tm, tn, meta.max_nnz)
            or tuple(kcnt.shape) != lead + (tm, tn)
            or kidx.dtype != torch.int32 or kcnt.dtype != torch.int32
            or not kidx.is_contiguous() or not kcnt.is_contiguous()
            or kidx.device != a.device or kcnt.device != a.device):
        raise ValueError("kidx/kcnt must be contiguous int32 tensors of "
                         f"shapes {lead + (tm, tn, meta.max_nnz)} and "
                         f"{lead + (tm, tn)} on {a.device}")
    if not a.is_contiguous():
        raise ValueError("A must be row-major contiguous")
    b_trans = build.b_layout(b)
    codes = (build.dtype_code(a.dtype), build.dtype_code(out_dtype))
    ws, m_run, plan = None, m, None
    args = (k, k if b_trans else n, bm, bn, bk, meta.max_nnz, 0, 0)
    strides = (0, 0)
    if a.dtype == torch.bfloat16:           # the tensor cores: rows only
        if scale is not None and b_trans:
            raise ValueError("the int8 tensor-core kernel reads the payload "
                             "row-major (K, N)")
        m_run = rows
        a, lda, b, ldb, plan, ws = tensor_core_operands(a, b, rows)
        args = (lda, ldb, bm, bn, bk, meta.max_nnz, plan.rows, plan.segment)
        strides = (a.shape[-2] * lda, b.shape[-2] * ldb)
    out = torch.empty(lead + (m_run, n), dtype=out_dtype, device=a.device)
    e = lead[0] if experts else 1
    # the dense product's work: how many blocks are live is the data's,
    # read on the card only by a sync
    accounting.count("block_sparse" if scale is None
                     else "block_sparse_scaled", 2 * e * m_run * n * k,
                     e * (m_run * k * a.element_size() + k * n
                          * b.element_size()) + accounting.nbytes(out, scale))
    if accounting.is_fake(a):
        return out[..., :rows, :]
    lib = build.library("block_sparse")
    common = (out.data_ptr(), None if ws is None else ws.data_ptr(),
              kidx.data_ptr(), kcnt.data_ptr(), m_run, n, k, *args,
              b_trans, *codes, lead[0] if experts else 1, *strides,
              tm * tn * meta.max_nnz, tm * tn, build.stream_ptr(a.device))
    if scale is None:
        err = lib.bs_matmul(a.data_ptr(), b.data_ptr(), *common)
        key = "block_sparse"
    else:
        err = lib.bs_matmul_scaled(a.data_ptr(), b.data_ptr(),
                                   scale.data_ptr(), *common)
        key = "block_sparse_scaled"
    key += "_experts" if experts else ""
    build.check(err, f"block_sparse_matmul[{key}]")
    if plan is None:
        LAUNCHES[key] += 1
    else:                         # with its segment sum, if it has one
        count_launch(LAUNCHES, key, plan)
    return out[..., :rows, :]
