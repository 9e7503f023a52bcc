// Dense int8-weight matmul for Hopper (sm_90a).
//
//   i8_matmul  replaces the Pallas TPU kernel ``_int8_kernel``
//              (src/repro/kernels/int8_matmul.py:24, launched at :57 by
//              ``_int8_matmul``): C = (A @ Q) * scale with A (M, K) float32
//              or bfloat16, Q (K, N) int8 and a float32 scale per output
//              column, applied once to the finished sum, as the TPU kernel
//              does at its last K step.
//
// Which kernel runs where, and what bounds it on the H100:
//   * bf16 A runs on the tensor cores: the output-stationary template of
//     ``os_mma.cuh`` with B an int8 payload, under the plan of
//     ``output_grid`` (kernels/flex_matmul.py), as bf16 ``fm_output`` runs
//     it.  Q travels and is staged as int8 (16 elements per 16-byte copy:
//     half the bf16 weight's bytes) and is widened to bf16 in shared memory
//     — exact, |q| <= 127 — before mma.sync (M <= 16, K in segments of 256
//     summed by a second kernel, which also scales) or wgmma (M > 16, TMA
//     loads, the scale in the epilogue).  At decode (M = n_slots = 4) each
//     weight byte feeds 4 products, so the int8 bytes bound it; at prefill
//     (M = 8192) the operations do.
//   * float32 A stays on ``tile.cuh``'s scalar float32 FMAs (no TF32), Q
//     staged as int8 and widened in registers.
// Both share their K order with ``bs_matmul_scaled`` (block_sparse.cu: the
// same template and plan for bf16, the same tile loop for float32), so a
// dense run and a block-sparse run of the same quantized weight agree bit
// for bit.
#include "os_mma.cuh"
#include "tile.cuh"

// float32 A: the scalar tile kernel on operands padded to the blocks
// (``lda`` = k, ``ldb`` = n, or k when ``b_trans``; ``ws`` null, ``rows``
// and ``seg`` 0); bf16 A: the tensor-core kernel under the plan of
// ``output_grid`` (``ws``: the segment partials; Q row-major).
extern "C" int i8_matmul(const void* a, const void* q, const float* scale,
                         void* out, float* ws, int m, int n, int k, int lda,
                         int ldb, int bm, int bn, int bk, int rows, int seg,
                         int b_trans, int in_dtype, int out_dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == rt::kBF16) {
    const osm::OsArgs p{static_cast<const __nv_bfloat16*>(a), q, out, ws,
                        nullptr, nullptr, m, n, k, lda, ldb, bm, bn, bk, 0,
                        rows, seg, scale};
    return osm::launch<false, int8_t>(p, b_trans, out_dtype, s);
  }
  if (ws || rows || seg || lda != k || ldb != (b_trans ? k : n))
    return (int)cudaErrorInvalidValue;
  const rt::TileArgs t{a, q, scale, out, nullptr, nullptr, m, n, k,
                       bm, bn, bk, 0, b_trans};
  return rt::dispatch_tile<false, true>(t, in_dtype, out_dtype, s);
}
