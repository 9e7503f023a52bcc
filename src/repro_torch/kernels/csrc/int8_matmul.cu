// Dense int8-weight matmul for Hopper (sm_90a).
//
//   i8_matmul  replaces the Pallas TPU kernel ``_int8_kernel``
//              (src/repro/kernels/int8_matmul.py:24, launched at :57 by
//              ``_int8_matmul``): C = (A @ Q) * scale with A (M, K) float32
//              or bfloat16, Q (K, N) int8 and a float32 scale per output
//              column; the operands arrive padded to block multiples.
//
// Design: the output-stationary tile kernel of ``tile.cuh`` (one CUDA block
// per 256-wide strip of each (bm, bn) output tile, K loop, float32
// accumulator in registers), with Q staged through shared memory as int8 —
// 16 elements per 16-byte load — widened to float32 in registers, and the
// scale applied once to the accumulator in the epilogue, as the TPU kernel
// does at its last K step.
// It shares its summation order with ``bs_matmul_scaled`` (K ascending per
// output element), so a dense run and a block-sparse run of the same
// quantized weight agree bit for bit.
//
// What bounds it on the H100 at decode (M = n_slots = 4): device-memory
// bytes — each weight byte feeds 4 FMAs.  The int8 payload is half the
// bf16 weight's bytes.  FMA-only with synchronous staging; wgmma/TMA is
// later work.
#include "tile.cuh"

extern "C" int i8_matmul(const void* a, const void* q, const float* scale,
                         void* out, int m, int n, int k, int bm, int bn,
                         int bk, int b_trans, int in_dtype, int out_dtype,
                         void* stream) {
  const rt::TileArgs t{a, q, scale, out, nullptr, nullptr, m, n, k,
                       bm, bn, bk, 0, b_trans};
  return rt::dispatch_tile<false, true>(t, in_dtype, out_dtype,
                                        static_cast<cudaStream_t>(stream));
}
