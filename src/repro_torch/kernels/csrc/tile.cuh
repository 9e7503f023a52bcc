// Shared building blocks of the port's scalar matmul kernels (sm_90a, CUDA
// C++): ``tile_kernel`` runs float32-activation ``fm_output``,
// ``bs_matmul``, ``bs_matmul_scaled`` and ``i8_matmul`` (B float32, or an
// int8 payload), and its staging and FMA helpers serve float32
// ``fm_weight``, ``fm_input`` (float32 and bf16) and the float32 flash
// kernel.  bf16-activation ``fm_output``, ``bs_matmul``, ``i8_matmul`` and
// ``bs_matmul_scaled`` run on the tensor cores instead (``os_mma.cuh``),
// as do bf16 ``fm_weight`` and the bf16 flash kernel (``mma.cuh``).
// These kernels are bound by the weight's bytes at decode and, far from the
// card's peak, by their own FMA issue rate at prefill.
//
// Every kernel here computes C = A @ B (or a block-sparse part of it) with
// A (M, K) row-major and B (K, N) either row-major or given as the transpose
// of a row-major (N, K) matrix (``b_trans``: the stored (V, D) lm_head is
// read in place, never copied).  A is float32 (or bfloat16 in
// ``fm_input``); B is A's type, or an int8 payload with float32 per-column
// scales that the epilogue applies once to the accumulator (C = (A @ Q) *
// scale).  Products are plain FMAs in float32 registers (never TF32), bf16
// and int8 operands widened to float32 on the way from shared memory.
// Each block of 256 threads owns one TN-wide
// column strip of a (bm, bn) output tile and walks it in register sub-tiles:
//
//   Skinny  (bm <= 4, the decode path: M = n_slots): 4 x 256 sub-tile,
//           thread t owns column t and all four rows;
//   Square  (bm > 4): 64 x 64 sub-tile, 4 x 4 outputs per thread.
//
// A tile wider than TN is split over ceil(bn / TN) blocks, which read the
// same K-block list: at M = 4 a site has only N / bn tiles, and one block
// per tile would leave most of the card idle (bn = 512 gives 4 blocks at a
// 2048-wide site).
//
// K is staged through shared memory in chunks of kTK rows.  The order of
// summation inside a (bm, bn) output tile is fixed by the block list alone:
// blocks in list order, rows of a block ascending — so a block-sparse run
// and an all-live run of the same tile agree bit for bit (a dead block adds
// exact zeros).  The order does not depend on (bm, bn, bk) either, so two
// kernels on the same operands give the same bits whatever their blocks
// (float32 ``bs_matmul_scaled`` and ``i8_matmul``; float32 ``bs_matmul``
// and ``fm_output``).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rt {

constexpr int kThreads = 256;
constexpr int kTK = 64;                 // K rows per staged chunk
constexpr int kSmemLimit = 232448;      // dynamic shared memory per block

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);         // exact
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);           // round to nearest even
}
template <> __device__ __forceinline__ int8_t from_f<int8_t>(float x) {
  return static_cast<int8_t>(__float2int_rn(x));   // staging's zero fill
}

template <int TM_, int TN_, int RM_, int RN_>
struct Cfg {
  static constexpr int TM = TM_, TN = TN_, RM = RM_, RN = RN_;
  static constexpr int GY = TM / RM, GX = TN / RN;
  static_assert(GY * GX == kThreads, "sub-tile must map onto 256 threads");
};
using Skinny = Cfg<4, 256, 4, 1>;
using Square = Cfg<64, 64, 4, 4>;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Stage an (mpad rows x kpad cols) window of A into shared memory as float,
// k-major: As[k * lda_s + m].  Entries outside (mrows, kc) are zero.
template <typename T>
__device__ __forceinline__ void stage_a(float* As, int lda_s, int mpad,
                                        int kpad, const T* __restrict__ A,
                                        int lda, int mrows, int kc) {
  for (int idx = threadIdx.x; idx < mpad * kpad; idx += kThreads) {
    const int m = idx / kpad, k = idx % kpad;
    float v = 0.f;
    if (m < mrows && k < kc) v = to_f(A[(size_t)m * lda + k]);
    As[k * lda_s + m] = v;
  }
}

// Stage a (kpad x npad) window of B into shared memory in its own type,
// Bs[k * ldb_s + n].  ``B`` points at the window origin; element (k, n)
// lies at B[k * ldb + n], or at B[n * ldb + k] when ``trans``.  Entries
// outside (kc, nc) are zero.  Aligned windows move 16 bytes per thread.
template <typename T>
__device__ __forceinline__ void stage_b(T* Bs, int ldb_s, int kpad, int npad,
                                        const T* __restrict__ B, int ldb,
                                        bool trans, int kc, int nc) {
  constexpr int V = 16 / sizeof(T);
  const T zero = from_f<T>(0.f);
  const bool aligned = (reinterpret_cast<uintptr_t>(B) % 16 == 0) &&
                       (ldb % V == 0) && (ldb_s % V == 0);
  if (!trans) {
    if (aligned && npad % V == 0) {
      const int nv = npad / V;
      for (int idx = threadIdx.x; idx < kpad * nv; idx += kThreads) {
        const int k = idx / nv, n = (idx % nv) * V;
        uint4 u;
        T* t = reinterpret_cast<T*>(&u);
        if (k < kc && n + V <= nc) {
          u = *reinterpret_cast<const uint4*>(B + (size_t)k * ldb + n);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j)
            t[j] = (k < kc && n + j < nc) ? B[(size_t)k * ldb + n + j]
                                             : zero;
        }
        *reinterpret_cast<uint4*>(Bs + k * ldb_s + n) = u;
      }
    } else {
      for (int idx = threadIdx.x; idx < kpad * npad; idx += kThreads) {
        const int k = idx / npad, n = idx % npad;
        Bs[k * ldb_s + n] =
            (k < kc && n < nc) ? B[(size_t)k * ldb + n] : zero;
      }
    }
  } else {
    if (aligned && kpad % V == 0) {
      const int kv = kpad / V;
      for (int idx = threadIdx.x; idx < npad * kv; idx += kThreads) {
        const int n = idx / kv, k = (idx % kv) * V;
        uint4 u;
        T* t = reinterpret_cast<T*>(&u);
        if (n < nc && k + V <= kc) {
          u = *reinterpret_cast<const uint4*>(B + (size_t)n * ldb + k);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j)
            t[j] = (n < nc && k + j < kc) ? B[(size_t)n * ldb + k + j]
                                             : zero;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) Bs[(k + j) * ldb_s + n] = t[j];
      }
    } else {
      for (int idx = threadIdx.x; idx < kpad * npad; idx += kThreads) {
        const int n = idx / kpad, k = idx % kpad;
        Bs[k * ldb_s + n] =
            (k < kc && n < nc) ? B[(size_t)n * ldb + k] : zero;
      }
    }
  }
}

// acc += As[0:kc, sub-tile rows] x Bs[0:kc, sub-tile cols], k ascending.
// ``As`` / ``Bs`` point at the sub-tile origin inside their staged windows.
template <typename T, class C>
__device__ __forceinline__ void mac(float (&acc)[C::RM][C::RN],
                                    const float* As, int lda_s, const T* Bs,
                                    int ldb_s, int kc) {
  const int ty = threadIdx.x / C::GX, tx = threadIdx.x % C::GX;
  for (int k = 0; k < kc; ++k) {
    float a[C::RM], b[C::RN];
#pragma unroll
    for (int r = 0; r < C::RM; ++r) a[r] = As[k * lda_s + ty + r * C::GY];
#pragma unroll
    for (int c = 0; c < C::RN; ++c) b[c] = to_f(Bs[k * ldb_s + tx + c * C::GX]);
#pragma unroll
    for (int r = 0; r < C::RM; ++r)
#pragma unroll
      for (int c = 0; c < C::RN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <class C>
__device__ __forceinline__ void zero_acc(float (&acc)[C::RM][C::RN]) {
#pragma unroll
  for (int r = 0; r < C::RM; ++r)
#pragma unroll
    for (int c = 0; c < C::RN; ++c) acc[r][c] = 0.f;
}

// Write (or, with ``add``, accumulate into a float32 buffer) the sub-tile
// at ``out`` (row stride ldo), masked to (mrows, ncols).  ``scale`` (the
// sub-tile's first column of a per-column float32 vector, or null) scales
// the accumulator once: out = acc * scale[n].
template <typename To, class C>
__device__ __forceinline__ void store(To* out, int ldo,
                                      const float (&acc)[C::RM][C::RN],
                                      int mrows, int ncols, bool add,
                                      const float* scale = nullptr) {
  const int ty = threadIdx.x / C::GX, tx = threadIdx.x % C::GX;
#pragma unroll
  for (int r = 0; r < C::RM; ++r) {
    const int m = ty + r * C::GY;
#pragma unroll
    for (int c = 0; c < C::RN; ++c) {
      const int n = tx + c * C::GX;
      if (m < mrows && n < ncols) {
        To* p = out + (size_t)m * ldo + n;
        const float v = scale ? acc[r][c] * scale[n] : acc[r][c];
        *p = add ? from_f<To>(to_f(*p) + v) : from_f<To>(v);
      }
    }
  }
}

// Arguments of one tile launch (pointers untyped; the dispatch types them).
struct TileArgs {
  const void* a;
  const void* b;
  const float* scale;     // per-column scales of an int8 B, else null
  void* out;
  const int* kidx;        // CSB lists (sparse launches only)
  const int* kcnt;
  int m, n, k, bm, bn, bk, max_nnz, b_trans;
};

// Output tile kernel: block (blockIdx.y, blockIdx.x) owns the TN-wide
// column strip n0 of output tile (i, j) of shape (bm, bn) and sums
// A[i, kb] @ B[kb, j] there over the tile's K-block list — the CSB list
// kidx[i, j, :kcnt[i, j]] when kSparse, else every K-block in order — then
// scales it when ``scale`` is given.  A tile with an empty list reads
// nothing and writes zeros.
template <typename TA, typename TB, typename To, class C, bool kSparse>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
            const float* __restrict__ scale, To* __restrict__ out,
            const int* __restrict__ kidx, const int* __restrict__ kcnt,
            int M, int N, int K, int bm, int bn, int bk, int max_nnz,
            int b_trans) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  TB* Bs = reinterpret_cast<TB*>(As + C::TM * kTK);
  const int nsub = (bn + C::TN - 1) / C::TN;
  const int j = blockIdx.x / nsub, n0 = (blockIdx.x % nsub) * C::TN;
  const int i = blockIdx.y;
  const int tn = N / bn, tk = K / bk;
  const int ldb = b_trans ? K : N;
  int cnt = tk;
  const int* list = nullptr;
  if (kSparse) {
    cnt = kcnt[i * tn + j];
    list = kidx + ((size_t)i * tn + j) * max_nnz;
  }
  const int ncols = min(C::TN, bn - n0), gn = j * bn + n0;
  for (int m0 = 0; m0 < bm; m0 += C::TM) {
    const int mrows = min(C::TM, bm - m0), gm = i * bm + m0;
    float acc[C::RM][C::RN];
    zero_acc<C>(acc);
    for (int s = 0; s < cnt; ++s) {
      const int kb = kSparse ? list[s] : s;
      for (int kk = 0; kk < bk; kk += kTK) {
        const int kc = min(kTK, bk - kk), gk = kb * bk + kk;
        const TB* bsrc = b_trans ? B + (size_t)gn * ldb + gk
                                 : B + (size_t)gk * ldb + gn;
        __syncthreads();
        stage_a(As, C::TM, C::TM, kTK, A + (size_t)gm * K + gk, K, mrows,
                kc);
        stage_b(Bs, C::TN, kTK, C::TN, bsrc, ldb, b_trans, kc, ncols);
        __syncthreads();
        mac<TB, C>(acc, As, C::TM, Bs, C::TN, kc);
      }
    }
    store<To, C>(out + (size_t)gm * N + gn, N, acc, mrows, ncols, false,
                 scale ? scale + gn : nullptr);
  }
}

template <typename TB, class C>
inline size_t tile_smem() {
  return (size_t)C::TM * kTK * sizeof(float) +
         (size_t)kTK * C::TN * sizeof(TB);
}

// Launch ``tile_kernel`` for one (A, B, output) type triple.
template <typename TA, typename TB, typename To, class C, bool kSparse>
int launch_tile(const TileArgs& t, cudaStream_t stream) {
  const size_t smem = tile_smem<TB, C>();
  auto kern = tile_kernel<TA, TB, To, C, kSparse>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((t.n / t.bn) * ((t.bn + C::TN - 1) / C::TN), t.m / t.bm);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TA*>(t.a), static_cast<const TB*>(t.b), t.scale,
      static_cast<To*>(t.out), t.kidx, t.kcnt, t.m, t.n, t.k, t.bm, t.bn,
      t.bk, t.max_nnz, t.b_trans);
  return (int)cudaGetLastError();
}

// Output type and sub-tile for one (A, B) type pair: bm <= 4 selects the
// Skinny sub-tile.
template <typename TA, typename TB, bool kSparse>
int dispatch_out(const TileArgs& t, int out_dtype, cudaStream_t s) {
  const bool skinny = t.bm <= Skinny::TM;
  if (out_dtype == kF32)
    return skinny ? launch_tile<TA, TB, float, Skinny, kSparse>(t, s)
                  : launch_tile<TA, TB, float, Square, kSparse>(t, s);
  if (out_dtype == kBF16)
    return skinny ? launch_tile<TA, TB, __nv_bfloat16, Skinny, kSparse>(t, s)
                  : launch_tile<TA, TB, __nv_bfloat16, Square, kSparse>(t, s);
  return (int)cudaErrorInvalidValue;
}

// Type dispatch shared by the C entry points: ``in_dtype`` / ``out_dtype``
// are ``Dtype`` codes of A and of the output.  A is float32 (a bf16 A runs
// on the tensor cores, os_mma.cuh); B is float32, or scaled an int8
// payload with ``t.scale``.
template <bool kSparse, bool kScaled>
int dispatch_tile(const TileArgs& t, int in_dtype, int out_dtype,
                  cudaStream_t s) {
  if (kScaled != (t.scale != nullptr) || in_dtype != kF32)
    return (int)cudaErrorInvalidValue;
  if constexpr (kScaled)
    return dispatch_out<float, int8_t, kSparse>(t, out_dtype, s);
  else
    return dispatch_out<float, float, kSparse>(t, out_dtype, s);
}

}  // namespace rt
