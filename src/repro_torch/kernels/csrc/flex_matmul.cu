// Schedule-flexible dense matmul for Hopper (sm_90a): one entry point per
// stationarity, chosen per site by the descriptor table (FlexNN's dataflow
// per layer).
//
//   fm_output  replaces ``_os_kernel`` (src/repro/kernels/flex_matmul.py:52,
//              launched at :102): one CUDA block per 256-wide strip of
//              each (bm, bn) output tile, K-loop with the float32
//              accumulator in registers.
//   fm_weight  replaces ``_revisit_kernel`` under the weight-stationary grid
//              (flex_matmul.py:68, launched at :118): a block owns an N-strip
//              (and a group of M-blocks), loops k, holds its B tile in shared
//              memory, then loops m, read-modify-writing a float32 output.
//   fm_input   replaces ``_revisit_kernel`` under the input-stationary grid
//              (launched at :133): the mirror image over M-strips — the A
//              tile stays in shared memory across the block's n loop.
//
// The TPU runs its grid in order on one core; Hopper runs blocks in
// parallel, so the sequential grid axes become loops inside a block, and
// each block updates only output tiles it owns: no atomics, deterministic
// results.  The strip groups (grid.y) exist so that a decode-shaped matmul
// (M = 4, one M-strip) still spreads over the card.
//
// What bounds them on the H100 at decode (M = n_slots = 4): device-memory
// bytes — the weight is read once at 4 FMAs per element.  The revisit
// variants add the float32 output traffic of one read-modify-write per
// K-block.  FMA-only with synchronous staging; wgmma/TMA is later work.
#include "tile.cuh"

namespace rt {

// Weight-stationary: block (blockIdx.x = j, blockIdx.y = group) owns N-strip
// j and the M-blocks i = group, group + groups, ...
template <typename T, class C>
__global__ void __launch_bounds__(kThreads)
ws_kernel(const T* __restrict__ A, const T* __restrict__ B,
          float* __restrict__ out, int M, int N, int K, int bm, int bn, int bk,
          int b_trans) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  T* Bres = reinterpret_cast<T*>(As + C::TM * kTK);
  const int j = blockIdx.x, tm = M / bm, tk = K / bk;
  const int ldb = b_trans ? K : N;
  const int ldb_s = round_up(bn, C::TN), kres = round_up(bk, kTK);
  for (int kb = 0; kb < tk; ++kb) {
    const T* bsrc = b_trans ? B + (size_t)j * bn * ldb + kb * bk
                            : B + (size_t)kb * bk * ldb + j * bn;
    __syncthreads();
    stage_b(Bres, ldb_s, kres, ldb_s, bsrc, ldb, b_trans, bk, bn);
    for (int i = blockIdx.y; i < tm; i += gridDim.y) {
      for (int m0 = 0; m0 < bm; m0 += C::TM) {
        const int mrows = min(C::TM, bm - m0), gm = i * bm + m0;
        for (int n0 = 0; n0 < bn; n0 += C::TN) {
          const int ncols = min(C::TN, bn - n0);
          float acc[C::RM][C::RN];
          zero_acc<C>(acc);
          for (int kk = 0; kk < bk; kk += kTK) {
            const int kc = min(kTK, bk - kk);
            __syncthreads();
            stage_a(As, C::TM, C::TM, kTK,
                    A + (size_t)gm * K + kb * bk + kk, K, mrows, kc);
            __syncthreads();
            mac<T, C>(acc, As, C::TM, Bres + kk * ldb_s + n0, ldb_s, kc);
          }
          store<float, C>(out + (size_t)gm * N + j * bn + n0, N, acc, mrows,
                          ncols, kb > 0);
        }
      }
    }
  }
}

// Input-stationary: block (blockIdx.x = i, blockIdx.y = group) owns M-strip
// i and the N-blocks j = group, group + groups, ...
template <typename T, class C>
__global__ void __launch_bounds__(kThreads)
is_kernel(const T* __restrict__ A, const T* __restrict__ B,
          float* __restrict__ out, int M, int N, int K, int bm, int bn, int bk,
          int b_trans) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda_s = round_up(bm, C::TM), kres = round_up(bk, kTK);
  float* Ares = reinterpret_cast<float*>(smem);
  T* Bs = reinterpret_cast<T*>(Ares + (size_t)lda_s * kres);
  const int i = blockIdx.x, tn = N / bn, tk = K / bk;
  const int ldb = b_trans ? K : N;
  for (int kb = 0; kb < tk; ++kb) {
    __syncthreads();
    stage_a(Ares, lda_s, lda_s, kres, A + (size_t)i * bm * K + kb * bk, K,
            bm, bk);
    for (int j = blockIdx.y; j < tn; j += gridDim.y) {
      for (int m0 = 0; m0 < bm; m0 += C::TM) {
        const int mrows = min(C::TM, bm - m0), gm = i * bm + m0;
        for (int n0 = 0; n0 < bn; n0 += C::TN) {
          const int ncols = min(C::TN, bn - n0), gn = j * bn + n0;
          float acc[C::RM][C::RN];
          zero_acc<C>(acc);
          for (int kk = 0; kk < bk; kk += kTK) {
            const int kc = min(kTK, bk - kk), gk = kb * bk + kk;
            const T* bsrc = b_trans ? B + (size_t)gn * ldb + gk
                                    : B + (size_t)gk * ldb + gn;
            __syncthreads();
            stage_b(Bs, C::TN, kTK, C::TN, bsrc, ldb, b_trans, kc, ncols);
            __syncthreads();
            mac<T, C>(acc, Ares + kk * lda_s + m0, lda_s, Bs, C::TN, kc);
          }
          store<float, C>(out + (size_t)gm * N + gn, N, acc, mrows, ncols,
                          kb > 0);
        }
      }
    }
  }
}

template <typename T, class C>
size_t ws_smem(int bn, int bk) {
  return (size_t)C::TM * kTK * sizeof(float) +
         (size_t)round_up(bk, kTK) * round_up(bn, C::TN) * sizeof(T);
}

template <typename T, class C>
size_t is_smem(int bm, int bk) {
  return (size_t)round_up(bm, C::TM) * round_up(bk, kTK) * sizeof(float) +
         (size_t)kTK * C::TN * sizeof(T);
}

template <typename T, class C, bool kWeight>
int launch_revisit(const void* a, const void* b, float* out, int m, int n,
                   int k, int bm, int bn, int bk, int groups, int b_trans,
                   cudaStream_t stream) {
  const size_t smem = kWeight ? ws_smem<T, C>(bn, bk) : is_smem<T, C>(bm, bk);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kern = kWeight ? ws_kernel<T, C> : is_kernel<T, C>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(kWeight ? n / bn : m / bm, groups);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(a),
                                          static_cast<const T*>(b), out, m, n,
                                          k, bm, bn, bk, b_trans);
  return (int)cudaGetLastError();
}

template <bool kWeight>
int dispatch_revisit(const void* a, const void* b, float* out, int m, int n,
                     int k, int bm, int bn, int bk, int groups, int b_trans,
                     int in_dtype, cudaStream_t s) {
  const bool skinny = bm <= Skinny::TM;
  if (in_dtype == kF32) {
    if (skinny)
      return launch_revisit<float, Skinny, kWeight>(a, b, out, m, n, k, bm,
                                                    bn, bk, groups, b_trans, s);
    return launch_revisit<float, Square, kWeight>(a, b, out, m, n, k, bm, bn,
                                                  bk, groups, b_trans, s);
  }
  if (in_dtype == kBF16) {
    if (skinny)
      return launch_revisit<__nv_bfloat16, Skinny, kWeight>(
          a, b, out, m, n, k, bm, bn, bk, groups, b_trans, s);
    return launch_revisit<__nv_bfloat16, Square, kWeight>(
        a, b, out, m, n, k, bm, bn, bk, groups, b_trans, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace rt

extern "C" int fm_output(const void* a, const void* b, void* out, int m,
                         int n, int k, int bm, int bn, int bk, int b_trans,
                         int in_dtype, int out_dtype, void* stream) {
  const rt::TileArgs t{a, b, nullptr, out, nullptr, nullptr, m, n, k,
                       bm, bn, bk, 0, b_trans};
  return rt::dispatch_tile<false, false>(t, in_dtype, out_dtype,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int fm_weight(const void* a, const void* b, float* out, int m,
                         int n, int k, int bm, int bn, int bk, int groups,
                         int b_trans, int in_dtype, void* stream) {
  return rt::dispatch_revisit<true>(a, b, out, m, n, k, bm, bn, bk, groups,
                                    b_trans, in_dtype,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int fm_input(const void* a, const void* b, float* out, int m,
                        int n, int k, int bm, int bn, int bk, int groups,
                        int b_trans, int in_dtype, void* stream) {
  return rt::dispatch_revisit<false>(a, b, out, m, n, k, bm, bn, bk, groups,
                                     b_trans, in_dtype,
                                     static_cast<cudaStream_t>(stream));
}
