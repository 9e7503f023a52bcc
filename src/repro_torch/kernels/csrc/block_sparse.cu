// Two-sided block-sparse matmul for Hopper (sm_90a) — the CSB + CAG unit.
//
//   bs_matmul         replaces the Pallas TPU kernel ``_bs_kernel``
//                     (src/repro/kernels/block_sparse.py:49, launched at :114
//                     by ``_block_sparse_matmul``):
//                     C[i, j] = sum over s < kcnt[i, j] of
//                               A[i, kidx[i, j, s]] @ B[kidx[i, j, s], j]
//                     with a float32 accumulator, written as out_dtype.
//   bs_matmul_scaled  replaces ``_bs_kernel_scaled`` (block_sparse.py:69,
//                     launched at :155 by ``_block_sparse_matmul_scaled``):
//                     the same sum over an int8 B payload, and the finished
//                     sum scaled once by the per-column float32 ``scale``.
//
// The TPU's sequential max_nnz grid axis becomes a loop inside the block:
// each CUDA block reads the CSB lists of the output tiles it covers and
// stages only the K ranges some of them list; a tile with kcnt == 0 reads
// no operand and writes zeros (the TPU kernel instead clamped to
// max(kcnt, 1) and MAC'd one dead block).  bm may be any size >= 1: at
// decode bm = M = n_slots = 4, rows are masked.
//
// Which kernel runs where, and what bounds it on the H100:
//   * bf16-activation ``bs_matmul`` and ``bs_matmul_scaled`` run on the
//     tensor cores: the output-stationary template of ``os_mma.cuh`` that
//     bf16 ``fm_output`` and ``i8_matmul`` run, under the same plan
//     (``output_grid``, kernels/flex_matmul.py) — mma.sync with K in
//     segments of 256 at M <= 16, wgmma on 128 x 128 tiles above; the int8
//     payload is staged as int8 and widened to bf16 in shared memory
//     (exact), and its scale multiplies the finished sum once.  A chunk of
//     64 K is multiplied when it holds an element of a live block of a
//     covered tile and skipped otherwise; a dead block's products are exact
//     zeros (dead must mean an all-zero operand block, as the lists are
//     built; quantization keeps zeros), so the result equals the dense
//     product's (``fm_output``, ``i8_matmul``) bit for bit, and the
//     all-live run's, whatever the blocks.
//   * float32-activation ``bs_matmul`` and ``bs_matmul_scaled`` are scalar
//     float32 FMAs on ``tile.cuh``: one CUDA block per 256-wide column
//     strip of each (bm, bn) output tile, synchronous staging, K ascending
//     (so the scaled kernel equals float32 ``i8_matmul`` bit for bit).
// At decode M = 4 every weight element fetched feeds 4 FMAs, two orders of
// magnitude under the card's ~295 FLOP/byte balance point, so the floor is
// the live weight blocks over 3.35 TB/s: skipping dead weight blocks is the
// lever the CSB list pulls, and the int8 payload halves the bytes of each
// live block again.  At prefill (M = 8192) the live blocks' operations
// bound it.
#include "os_mma.cuh"
#include "tile.cuh"

// float32: the scalar tile kernel on contiguous operands (``lda`` = k,
// ``ldb`` = n, or k when ``b_trans``; ``ws`` null, ``rows`` and ``seg`` 0);
// bf16: the tensor-core kernel of os_mma.cuh under the plan of
// ``output_grid``, as ``fm_output`` runs it (``ws``: the segment partials).
// ``experts`` products of one shape (the MoE expert contraction (E, m, k)
// @ (E, k, n), bf16, skinny regime, B row-major) run in one launch, the
// grid's y axis over the experts: expert e's A starts ``ea`` elements after
// expert e-1's, its B ``eb`` after, its CSB lists ``ekidx`` / ``ekcnt``
// after; its output (m, n) and its (segments, m, n) partials follow the
// previous expert's.  Each expert equals its own launch bit for bit.  A
// single product passes ``experts`` 1 (the strides are then unread).
extern "C" int bs_matmul(const void* a, const void* b, void* out, float* ws,
                         const int* kidx, const int* kcnt, int m, int n,
                         int k, int lda, int ldb, int bm, int bn, int bk,
                         int max_nnz, int rows, int seg, int b_trans,
                         int in_dtype, int out_dtype, int experts,
                         long long ea, long long eb, long long ekidx,
                         long long ekcnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == rt::kBF16) {
    osm::OsArgs p{static_cast<const __nv_bfloat16*>(a),
                  static_cast<const __nv_bfloat16*>(b),
                  out, ws, kidx, kcnt, m, n, k, lda, ldb, bm, bn, bk,
                  max_nnz, rows, seg};
    osm::set_experts(p, experts, ea, eb, ekidx, ekcnt);
    return osm::launch<true>(p, b_trans, out_dtype, s);
  }
  if (experts != 1 || ws || rows || seg || lda != k ||
      ldb != (b_trans ? k : n))
    return (int)cudaErrorInvalidValue;
  const rt::TileArgs t{a, b, nullptr, out, kidx, kcnt, m, n, k,
                       bm, bn, bk, max_nnz, b_trans};
  return rt::dispatch_tile<true, false>(t, in_dtype, out_dtype, s);
}

// ``bs_matmul`` over an int8 payload ``q`` with per-column ``scale``: the
// same arguments and routes (bf16 A on the tensor cores, Q row-major);
// expert e's scales (n,) follow expert e-1's.
extern "C" int bs_matmul_scaled(const void* a, const void* q,
                                const float* scale, void* out, float* ws,
                                const int* kidx, const int* kcnt, int m,
                                int n, int k, int lda, int ldb, int bm,
                                int bn, int bk, int max_nnz, int rows,
                                int seg, int b_trans, int in_dtype,
                                int out_dtype, int experts, long long ea,
                                long long eb, long long ekidx,
                                long long ekcnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == rt::kBF16) {
    osm::OsArgs p{static_cast<const __nv_bfloat16*>(a), q, out, ws,
                  kidx, kcnt, m, n, k, lda, ldb, bm, bn, bk, max_nnz,
                  rows, seg, scale};
    osm::set_experts(p, experts, ea, eb, ekidx, ekcnt);
    return osm::launch<true, int8_t>(p, b_trans, out_dtype, s);
  }
  if (experts != 1 || ws || rows || seg || lda != k ||
      ldb != (b_trans ? k : n))
    return (int)cudaErrorInvalidValue;
  const rt::TileArgs t{a, q, scale, out, kidx, kcnt, m, n, k,
                       bm, bn, bk, max_nnz, b_trans};
  return rt::dispatch_tile<true, true>(t, in_dtype, out_dtype, s);
}
