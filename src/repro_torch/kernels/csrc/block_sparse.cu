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
//                     the same sum over an int8 B payload, widened to float32
//                     in registers, and the accumulator scaled once by the
//                     per-column float32 ``scale`` before the write.
//
// Design: one CUDA block per 256-wide column strip of each (bm, bn) output
// tile (the TPU's sequential max_nnz grid axis becomes a loop inside the
// block); the block reads its tile's kcnt / kidx and stages each live
// (A, B) block pair through shared memory.  A tile with kcnt == 0 reads no
// operand and writes zeros (the TPU kernel instead clamped to max(kcnt, 1)
// and MAC'd one dead block).
// bm may be any size >= 1: at decode bm = M = n_slots = 4, rows are masked.
//
// What bounds it on the H100: device-memory bytes.  At decode M = 4 every
// weight element fetched feeds 4 FMAs, two orders of magnitude under the
// card's ~295 FLOP/byte balance point, so the kernel's floor is the live
// weight blocks over 3.35 TB/s; skipping dead weight blocks is the lever
// the CSB list pulls, and the int8 payload halves the bytes of each live
// block again.  Staging moves 16 bytes per thread, so an int8 block moves
// 16 elements per load.  This first version is FMA-only with synchronous
// staging; wgmma/TMA pipelining is later work.
#include "tile.cuh"

extern "C" int bs_matmul(const void* a, const void* b, void* out,
                         const int* kidx, const int* kcnt, int m, int n,
                         int k, int bm, int bn, int bk, int max_nnz,
                         int b_trans, int in_dtype, int out_dtype,
                         void* stream) {
  const rt::TileArgs t{a, b, nullptr, out, kidx, kcnt, m, n, k,
                       bm, bn, bk, max_nnz, b_trans};
  return rt::dispatch_tile<true, false>(t, in_dtype, out_dtype,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" int bs_matmul_scaled(const void* a, const void* q,
                                const float* scale, void* out,
                                const int* kidx, const int* kcnt, int m,
                                int n, int k, int bm, int bn, int bk,
                                int max_nnz, int b_trans, int in_dtype,
                                int out_dtype, void* stream) {
  const rt::TileArgs t{a, q, scale, out, kidx, kcnt, m, n, k,
                       bm, bn, bk, max_nnz, b_trans};
  return rt::dispatch_tile<true, true>(t, in_dtype, out_dtype,
                                       static_cast<cudaStream_t>(stream));
}
