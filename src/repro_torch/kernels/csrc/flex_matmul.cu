// Schedule-flexible dense matmul for Hopper (sm_90a): one entry point per
// stationarity, chosen per site by the descriptor table (FlexNN's dataflow
// per layer).
//
//   fm_output  replaces ``_os_kernel`` (src/repro/kernels/flex_matmul.py:52,
//              launched at :102): each CUDA block owns an output tile and
//              loops over K with the float32 accumulator in registers.
//   fm_weight  replaces ``_revisit_kernel`` under the weight-stationary grid
//              (flex_matmul.py:68, launched at :118): per K-block, a block
//              holds a B tile in shared memory while M rows stream past it,
//              and the float32 output gathers one partial per K-block,
//              ``out = ((p0 + p1) + p2) + ...`` (the reference's
//              ``o_ref += part``).
//   fm_input   replaces ``_revisit_kernel`` under the input-stationary grid
//              (launched at :133): the mirror image over M-strips — the A
//              tile stays in shared memory across the block's n loop.
//
// The TPU runs its grid in order on one core; Hopper runs blocks in
// parallel, so the sequential grid axes become loops inside a block, and
// each block updates only output tiles it owns: no atomics, deterministic
// results.
//
// Which kernel runs where, and what bounds it on the H100:
//   * bf16 ``fm_output`` runs on the tensor cores: the output-stationary
//     template of ``os_mma.cuh``, shared with bf16 ``bs_matmul``
//     (block_sparse.cu), under the plan of ``output_grid``
//     (kernels/flex_matmul.py) — mma.sync with K in segments of 256 at
//     M <= 16 (decode: bound by the weight's bytes), wgmma on 128 x 128
//     tiles above (prefill: bound by operations).  Each element's K order
//     is fixed by K alone (os_mma.cuh), so the dense table and the plan
//     agree bit for bit.
//   * bf16 ``fm_weight`` runs on the tensor cores too (``mma.cuh``): a block
//     owns a 128-wide N-strip; per K-block it stages the (bk x 128) B tile
//     once with cp.async and streams the rows past it in 16- or 64-row A
//     chunks through a two-stage cp.async ring, mma.sync on bf16 with
//     float32 accumulators.  Two grids, chosen by ``weight_grid``:
//       split   (small M: decode, M = 4, one M-tile; 22-44 strips would
//               leave most of 132 SMs idle): one block per (strip, K-block)
//               writes its partial into a float32 workspace (tk, M, N);
//               ``ws_kernel_sum`` then adds the partials in K-block order —
//               the same adds, in the same order, as the serial
//               read-modify-write;
//       owning  (large M: prefill, where that workspace would take
//               gigabytes): a block owns (strip, M-tile group), loops
//               K-blocks outer and its M-tiles inner, read-modify-writing
//               the float32 output.
//     At decode the weight's bytes bound it; at prefill the dataflow's own
//     float32 traffic, (2·tk − 1)·M·N·4 bytes, does (PERF.md).
//   * ``fm_input`` (bf16 and float32) and every float32 instantiation are
//     scalar float32 FMAs on ``tile.cuh`` with synchronous staging; the
//     revisit variants add the float32 output traffic of one
//     read-modify-write per K-block.
#include "mma.cuh"
#include "os_mma.cuh"
#include "tile.cuh"

namespace rt {

// Weight-stationary, float32: block (blockIdx.x = j, blockIdx.y = group)
// owns N-strip j and the M-blocks i = group, group + groups, ...
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
  void (*kern)(const T*, const T*, float*, int, int, int, int, int, int, int);
  if constexpr (kWeight)
    kern = ws_kernel<T, C>;
  else
    kern = is_kernel<T, C>;
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
  if constexpr (!kWeight) {   // bf16 fm_weight runs on the tensor cores
    if (in_dtype == kBF16) {
      if (skinny)
        return launch_revisit<__nv_bfloat16, Skinny, kWeight>(
            a, b, out, m, n, k, bm, bn, bk, groups, b_trans, s);
      return launch_revisit<__nv_bfloat16, Square, kWeight>(
          a, b, out, m, n, k, bm, bn, bk, groups, b_trans, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Weight-stationary, bf16 on the tensor cores.  Block (blockIdx.x = strip)
// owns output columns [128·strip, 128·strip + 128).  ``split``: it computes
// the partial of K-block blockIdx.y for every row into ws[kb] (M x N);
// otherwise it owns the TMR-row M-tiles blockIdx.y, blockIdx.y + gridDim.y,
// ... and walks every K-block, adding each partial into ``out``.
template <int TMR, bool BT>
__global__ void __launch_bounds__(mma::kThreads)
ws_kernel_mma(const __nv_bfloat16* __restrict__ A,
              const __nv_bfloat16* __restrict__ B, float* __restrict__ out,
              float* __restrict__ ws, int M, int N, int K, int bk, int split) {
  using mma::bf16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = round_up(bk, mma::kKC), nkc = kpad / mma::kKC;
  bf16* Bs = reinterpret_cast<bf16*>(smem);          // kpad x 128
  bf16* As = Bs + (size_t)kpad * mma::kTN;           // 2 x (TMR x 64)
  const int n0 = blockIdx.x * mma::kTN, ncols = min(mma::kTN, N - n0);
  const int tk = K / bk, mtiles = (M + TMR - 1) / TMR;
  const int kb0 = split ? blockIdx.y : 0, kb1 = split ? blockIdx.y + 1 : tk;
  const int t0 = split ? 0 : blockIdx.y, dt = split ? 1 : gridDim.y;
  const int ntiles = t0 < mtiles ? (mtiles - 1 - t0) / dt + 1 : 0;
  const int steps = ntiles * nkc;                    // (M-tile, chunk) pairs
  const int ldb = BT ? K : N;
  const bool vec_a = K % 8 == 0 && bk % 8 == 0 && mma::aligned16(A);
  const bool vec_b = (BT ? K % 8 == 0 && bk % 8 == 0 : N % 8 == 0) &&
                     mma::aligned16(B);

  auto stage = [&](int step, int kb) {
    const int m0 = (t0 + (step / nkc) * dt) * TMR;
    const int kk = (step % nkc) * mma::kKC;
    mma::stage_a<TMR>(As + (step & 1) * TMR * mma::kKC,
                      A + (size_t)m0 * K + (size_t)kb * bk + kk, K,
                      min(TMR, M - m0), min(mma::kKC, bk - kk), vec_a);
  };

  for (int kb = kb0; kb < kb1; ++kb) {
    float* dst = split ? ws + (size_t)kb * M * N : out;
    const bool add = !split && kb > 0;
    const bf16* bsrc = BT ? B + (size_t)n0 * ldb + (size_t)kb * bk
                          : B + (size_t)kb * bk * ldb + n0;
    __syncthreads();             // the last K-block's readers are done
    mma::stage_b<BT>(Bs, bsrc, ldb, bk, ncols, kpad, vec_b);
    if (steps > 0) stage(0, kb);
    mma::cp_async_commit();
    mma::Acc<TMR> acc;
    mma::zero_acc<TMR>(acc);
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) {
        stage(s + 1, kb);
        mma::cp_async_commit();
        mma::cp_async_wait<1>();
      } else {
        mma::cp_async_wait<0>();
      }
      __syncthreads();
      const int chunk = s % nkc;
      mma::mac_chunk<TMR, BT>(acc, As + (s & 1) * TMR * mma::kKC, Bs, kpad,
                              chunk * mma::kKC);
      if (chunk == nkc - 1) {
        const int m0 = (t0 + (s / nkc) * dt) * TMR;
        mma::store_acc<TMR>(dst + (size_t)m0 * N + n0, N, acc,
                            min(TMR, M - m0), ncols, add);
        mma::zero_acc<TMR>(acc);
      }
      __syncthreads();           // A buffer (s & 1) is restaged at s + 2
    }
  }
}

// out[i] = ((ws[0][i] + ws[1][i]) + ws[2][i]) + ...: the split grid's
// partials added in K-block order, one rounding per add.
__global__ void ws_kernel_sum(const float* __restrict__ ws,
                              float* __restrict__ out, int mn, int tk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = ws[i];
  for (int kb = 1; kb < tk; ++kb) s = __fadd_rn(s, ws[(size_t)kb * mn + i]);
  out[i] = s;
}

template <int TMR, bool BT>
int launch_ws_mma(const void* a, const void* b, float* out, float* ws, int m,
                  int n, int k, int bk, int gx, int gy, int split,
                  cudaStream_t stream) {
  const size_t smem = mma::ws_smem_bytes(TMR, bk);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kern = ws_kernel_mma<TMR, BT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(gx, gy), mma::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), out, ws, m, n, k, bk, split);
  if (split) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int mn = m * n;
    ws_kernel_sum<<<(mn + 255) / 256, 256, 0, stream>>>(ws, out, mn, k / bk);
  }
  return (int)cudaGetLastError();
}

// bf16 fm_weight: the grid (gx, gy), ``split`` and the M-tile rows come
// from ``weight_grid``; the checks here refuse anything else.
inline int dispatch_ws_mma(const void* a, const void* b, float* out,
                           float* ws, int m, int n, int k, int bk, int gx,
                           int gy, int split, int rows, int b_trans,
                           cudaStream_t s) {
  if (bk <= 0 || k % bk || gx != (n + mma::kTN - 1) / mma::kTN || gy <= 0 ||
      (split ? ws == nullptr || gy != k / bk : gy > (m + rows - 1) / rows))
    return (int)cudaErrorInvalidValue;
  if (rows == 16)
    return b_trans ? launch_ws_mma<16, true>(a, b, out, ws, m, n, k, bk, gx,
                                             gy, split, s)
                   : launch_ws_mma<16, false>(a, b, out, ws, m, n, k, bk, gx,
                                              gy, split, s);
  if (rows == 64)
    return b_trans ? launch_ws_mma<64, true>(a, b, out, ws, m, n, k, bk, gx,
                                             gy, split, s)
                   : launch_ws_mma<64, false>(a, b, out, ws, m, n, k, bk, gx,
                                              gy, split, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace rt

// float32: the scalar tile kernel on contiguous operands (``lda`` = k,
// ``ldb`` = n, or k when ``b_trans``; ``ws`` null, ``rows`` and ``seg`` 0);
// bf16: the tensor-core kernel of os_mma.cuh under the plan of
// ``output_grid``: ``rows`` and ``seg``, and ``ws`` the (segments, m, n)
// float32 partials when there is more than one segment.
extern "C" int fm_output(const void* a, const void* b, void* out, float* ws,
                         int m, int n, int k, int lda, int ldb, int bm, int bn,
                         int bk, int rows, int seg, int b_trans, int in_dtype,
                         int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == rt::kBF16) {
    const osm::OsArgs p{static_cast<const __nv_bfloat16*>(a),
                        static_cast<const __nv_bfloat16*>(b),
                        out, ws, nullptr, nullptr, m, n, k, lda, ldb, bm,
                        bn, bk, 0, rows, seg};
    return osm::launch<false>(p, b_trans, out_dtype, s);
  }
  if (ws || rows || seg || lda != k || ldb != (b_trans ? k : n))
    return (int)cudaErrorInvalidValue;
  const rt::TileArgs t{a, b, nullptr, out, nullptr, nullptr, m, n, k,
                       bm, bn, bk, 0, b_trans};
  return rt::dispatch_tile<false, false>(t, in_dtype, out_dtype, s);
}

// float32: (gx, gy) = (n / bn, strip groups) of the scalar kernel, ``ws``,
// ``split`` and ``rows`` unused; bf16: the tensor-core grid of
// ``weight_grid``, with ``ws`` the (k / bk, m, n) float32 workspace of a
// split grid.
extern "C" int fm_weight(const void* a, const void* b, float* out, float* ws,
                         int m, int n, int k, int bm, int bn, int bk, int gx,
                         int gy, int split, int rows, int b_trans,
                         int in_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == rt::kBF16)
    return rt::dispatch_ws_mma(a, b, out, ws, m, n, k, bk, gx, gy, split,
                               rows, b_trans, s);
  if (in_dtype != rt::kF32 || gx != n / bn) return (int)cudaErrorInvalidValue;
  return rt::dispatch_revisit<true>(a, b, out, m, n, k, bm, bn, bk, gy,
                                    b_trans, in_dtype, s);
}

extern "C" int fm_input(const void* a, const void* b, float* out, int m,
                        int n, int k, int bm, int bn, int bk, int groups,
                        int b_trans, int in_dtype, void* stream) {
  return rt::dispatch_revisit<false>(a, b, out, m, n, k, bm, bn, bk, groups,
                                     b_trans, in_dtype,
                                     static_cast<cudaStream_t>(stream));
}
