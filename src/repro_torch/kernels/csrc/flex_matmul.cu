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
//              (launched at :133): the mirror image over M-tiles — per
//              K-block, a block holds an A tile in shared memory while the
//              N-strips stream past it, and the float32 output gathers the
//              same partials in the same K-block order.
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
//   * bf16 ``fm_input`` is its mirror image on the same tile
//     (``is_kernel_mma``): a block keeps one K-block of an M-tile of A
//     resident (swizzled, double-buffered so that the next one loads
//     early) and streams B past it in 64 x 128 chunks through a cp.async
//     ring, so shared memory bounds only A.  Two grids, chosen by
//     ``input_grid``:
//       split   (decode: one M-tile would leave most SMs idle): one block
//               per (K-block, strip group) writes its strips' partials into
//               the (tk, M, N) workspace, and ``is_kernel_sum`` adds them in
//               K-block order;
//       owning  (prefill): a block owns (M-tile, strip group) and walks the
//               K-blocks outer and its strips inner; the old float32 tile of
//               each strip is read into shared memory with cp.async while
//               the strip before it runs, so the read of the
//               read-modify-write lands behind that strip's products and
//               stores.
//     Each partial starts from zero and sums the K-block's 16-wide groups
//     ascending with the tile of ``fm_weight`` (mma::Warps, 16 or 64 rows
//     by M), and the partials are added in K-block order, one __fadd_rn
//     each: a forced input-stationary run equals a forced weight-stationary
//     one bit for bit.  Bound: the weight's bytes at decode; at prefill the
//     float32 read-modify-write, (2·tk − 1)·M·N·4 bytes, with B read once
//     per M-tile (PERF.md).
//   * Every float32 instantiation is scalar float32 FMAs on ``tile.cuh``
//     with synchronous staging (true float32, no TF32); the revisit
//     variants add the float32 output traffic of one read-modify-write per
//     K-block.
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

// Input-stationary, float32: block (blockIdx.x = i, blockIdx.y = group)
// owns M-strip i and the N-blocks j = group, group + groups, ...
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

// float32 only: bf16 runs on the tensor cores (dispatch_mma)
template <bool kWeight>
int dispatch_revisit(const void* a, const void* b, float* out, int m, int n,
                     int k, int bm, int bn, int bk, int groups, int b_trans,
                     cudaStream_t s) {
  if (bm <= Skinny::TM)
    return launch_revisit<float, Skinny, kWeight>(a, b, out, m, n, k, bm, bn,
                                                  bk, groups, b_trans, s);
  return launch_revisit<float, Square, kWeight>(a, b, out, m, n, k, bm, bn,
                                                bk, groups, b_trans, s);
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

// Input-stationary, bf16 on the tensor cores: the mirror image of
// ``ws_kernel_mma``.  A block walks a list of A blocks — TMR rows x one
// K-block, held in shared memory as kpad / 64 swizzled chunks, two buffers
// so that the next loads while this one is used — and for each, its
// strips blockIdx.y, blockIdx.y + gridDim.y, ... of 128 columns, streaming
// their B past it in 64 x 128 chunks.  Owning (``split`` 0): M-tile
// blockIdx.x, every K-block in order; each strip's partial is added into
// ``out`` (the first K-block stores it).  ``split``: K-block blockIdx.x of
// every M-tile; each partial goes to ws[kb] (M x N).
//
// One producer order, step u = (A block, strip, chunk), loaded ``depth``
// steps ahead into a ring of kRing B chunks, so the next strip's chunks
// and the next A block load while this strip finishes; depth <= the steps
// of one A block keeps each A buffer's next load after its last reader.  Owning, the old
// float32 tile of strip g (K-block > 0) is read with cp.async into buffer
// g % kOutTiles when strip g - ahead starts, so the read of the
// read-modify-write lands while ``ahead`` strips' products and stores
// run; ahead < the block's strip count, so that tile was written (by strip
// g - strips, one K-block earlier) before the read starts.  A block of one
// strip reads its old tile in the epilogue, after the write.
template <int TMR, bool BT>
__global__ void __launch_bounds__(mma::kThreads)
is_kernel_mma(const __nv_bfloat16* __restrict__ A,
              const __nv_bfloat16* __restrict__ B, float* __restrict__ out,
              float* __restrict__ ws, int M, int N, int K, int bk, int split) {
  using mma::bf16;
  using mma::kKC;
  using mma::kOutLd;
  using mma::kOutTiles;
  using mma::kRing;
  using mma::kTN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = round_up(bk, kKC), nkc = kpad / kKC;
  bf16* As = reinterpret_cast<bf16*>(smem);          // 2 x (TMR x kpad)
  bf16* Bs = As + 2 * (size_t)TMR * kpad;            // kRing x (64 x 128)
  float* Os = reinterpret_cast<float*>(Bs + kRing * kKC * kTN);
  const int strips = (N + kTN - 1) / kTN, tk = K / bk;
  const int gy = blockIdx.y, gn = gridDim.y;
  const int ns = gy < strips ? (strips - 1 - gy) / gn + 1 : 0;
  const int spa = ns * nkc;                          // steps per A block
  const int steps = (split ? (M + TMR - 1) / TMR : tk) * spa;
  const int ahead = split ? 0 : min(kOutTiles - 1, ns - 1);
  // an old tile read at the start of strip g lands by the epilogue of
  // strip g + ahead, (ahead + 1)·nkc - 1 steps on
  const int depth = min(min(kRing - 1, spa),
                        ahead > 0 ? (ahead + 1) * nkc - 1 : kRing);
  const int ldb = BT ? K : N;
  const bool vec_a = K % 8 == 0 && bk % 8 == 0 && mma::aligned16(A);
  const bool vec_b = (BT ? K % 8 == 0 && bk % 8 == 0 : N % 8 == 0) &&
                     mma::aligned16(B);
  const bool vec_o = N % 4 == 0 && mma::aligned16(out);

  // strip g (g = step / nkc): its M-tile origin, K-block and column origin
  auto where = [&](int g, int& m0, int& kb, int& n0) {
    const int blk = g / ns;
    m0 = (split ? blk : blockIdx.x) * TMR;
    kb = split ? blockIdx.x : blk;
    n0 = (gy + g % ns * gn) * kTN;
  };

  auto load = [&](int u) {
    int m0, kb, n0;
    where(u / nkc, m0, kb, n0);
    const int kk = u % nkc * kKC;
    if (u % spa == 0) {                              // a new A block
      bf16* dst = As + ((u / spa) & 1) * (size_t)TMR * kpad;
      for (int c = 0; c < nkc; ++c)
        mma::stage_a<TMR>(dst + c * TMR * kKC,
                          A + (size_t)m0 * K + (size_t)kb * bk + c * kKC, K,
                          min(TMR, M - m0), min(kKC, bk - c * kKC), vec_a);
    }
    const size_t k0 = (size_t)kb * bk + kk;
    mma::stage_b<BT>(Bs + (u % kRing) * kKC * kTN,
                     BT ? B + (size_t)n0 * ldb + k0 : B + k0 * ldb + n0, ldb,
                     min(kKC, bk - kk), min(kTN, N - n0), kKC, vec_b);
  };

  auto load_old = [&](int g) {                       // strip g's old tile
    int m0, kb, n0;
    where(g, m0, kb, n0);
    if (kb > 0)
      mma::stage_f32(Os + g % kOutTiles * TMR * kOutLd, kOutLd,
                     out + (size_t)m0 * N + n0, N, min(TMR, M - m0),
                     min(kTN, N - n0), vec_o);
  };

  for (int u = 0; u < depth; ++u) {
    load(u);
    mma::cp_async_commit();
  }
  mma::Acc<TMR> acc;
  mma::zero_acc<TMR>(acc);
  for (int t = 0; t < steps; ++t) {
    mma::cp_async_wait_n(depth - 1);                 // step t's group landed
    __syncthreads();                  // and step t - 1's readers are done
    if (t + depth < steps) load(t + depth);
    const int g = t / nkc, c = t % nkc;
    if (ahead > 0 && c == 0 && (t + ahead * nkc) < steps) load_old(g + ahead);
    mma::cp_async_commit();
    mma::mac_chunk<TMR, BT>(
        acc, As + ((t / spa) & 1) * (size_t)TMR * kpad + c * TMR * kKC,
        Bs + (t % kRing) * kKC * kTN, kKC, 0);
    if (c == nkc - 1) {
      int m0, kb, n0;
      where(g, m0, kb, n0);
      float* dst = split ? ws + (size_t)kb * M * N : out;
      mma::store_acc<TMR>(
          dst + (size_t)m0 * N + n0, N, acc, min(TMR, M - m0),
          min(kTN, N - n0), !split && kb > 0,
          ahead > 0 ? Os + g % kOutTiles * TMR * kOutLd : nullptr, kOutLd);
      mma::zero_acc<TMR>(acc);
    }
  }
}

// out[i] = ((ws[0][i] + ws[1][i]) + ws[2][i]) + ...: a split grid's
// partials added in K-block order, one rounding per add — the same adds,
// in the same order, as the owning grid's read-modify-write.
__device__ __forceinline__ void sum_partials(const float* __restrict__ ws,
                                             float* __restrict__ out, int mn,
                                             int tk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = ws[i];
  for (int kb = 1; kb < tk; ++kb) s = __fadd_rn(s, ws[(size_t)kb * mn + i]);
  out[i] = s;
}

__global__ void ws_kernel_sum(const float* __restrict__ ws,
                              float* __restrict__ out, int mn, int tk) {
  sum_partials(ws, out, mn, tk);
}

__global__ void is_kernel_sum(const float* __restrict__ ws,
                              float* __restrict__ out, int mn, int tk) {
  sum_partials(ws, out, mn, tk);
}

template <bool kWeight, int TMR, bool BT>
int launch_mma(const void* a, const void* b, float* out, float* ws, int m,
               int n, int k, int bk, int gx, int gy, int split,
               cudaStream_t stream) {
  const size_t smem = kWeight ? mma::ws_smem_bytes(TMR, bk)
                              : mma::is_smem_bytes(TMR, bk, split);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kern = kWeight ? ws_kernel_mma<TMR, BT> : is_kernel_mma<TMR, BT>;
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
    auto sum = kWeight ? ws_kernel_sum : is_kernel_sum;
    sum<<<(mn + 255) / 256, 256, 0, stream>>>(ws, out, mn, k / bk);
  }
  return (int)cudaGetLastError();
}

// bf16 fm_weight / fm_input: the grid (gx, gy), ``split`` and the M-tile
// rows come from ``weight_grid`` / ``input_grid``; the checks here refuse
// anything else.
template <bool kWeight>
int dispatch_mma(const void* a, const void* b, float* out, float* ws, int m,
                 int n, int k, int bk, int gx, int gy, int split, int rows,
                 int b_trans, cudaStream_t s) {
  if (bk <= 0 || k % bk || gy <= 0 || (rows != 16 && rows != 64))
    return (int)cudaErrorInvalidValue;
  const int strips = (n + mma::kTN - 1) / mma::kTN;
  const int mtiles = (m + rows - 1) / rows, tk = k / bk;
  if (split && ws == nullptr) return (int)cudaErrorInvalidValue;
  if (kWeight ? gx != strips || (split ? gy != tk : gy > mtiles)
              : rows != (m <= 16 ? 16 : 64) || gy > strips ||
                    gx != (split ? tk : mtiles))
    return (int)cudaErrorInvalidValue;
  if (rows == 16)
    return b_trans ? launch_mma<kWeight, 16, true>(a, b, out, ws, m, n, k,
                                                   bk, gx, gy, split, s)
                   : launch_mma<kWeight, 16, false>(a, b, out, ws, m, n, k,
                                                    bk, gx, gy, split, s);
  return b_trans ? launch_mma<kWeight, 64, true>(a, b, out, ws, m, n, k, bk,
                                                 gx, gy, split, s)
                 : launch_mma<kWeight, 64, false>(a, b, out, ws, m, n, k, bk,
                                                  gx, gy, split, s);
}

}  // namespace rt

// float32: the scalar tile kernel on contiguous operands (``lda`` = k,
// ``ldb`` = n, or k when ``b_trans``; ``ws`` null, ``rows`` and ``seg`` 0);
// bf16: the tensor-core kernel of os_mma.cuh under the plan of
// ``output_grid``: ``rows`` and ``seg``, and ``ws`` the (segments, m, n)
// float32 partials when there is more than one segment.  ``experts``
// products of one shape (the dense MoE expert contraction, bf16, skinny
// regime, B row-major or, under ``b_trans``, each expert's B the
// transpose of a row-major (n, k) matrix) run in one launch, the grid's y
// axis over the experts (expert e's A ``ea`` and B ``eb`` elements after
// expert e-1's, outputs and partials following each other), each equal to
// its own launch bit for bit; a single product passes ``experts`` 1.
extern "C" int fm_output(const void* a, const void* b, void* out, float* ws,
                         int m, int n, int k, int lda, int ldb, int bm, int bn,
                         int bk, int rows, int seg, int b_trans, int in_dtype,
                         int out_dtype, int experts, long long ea,
                         long long eb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == rt::kBF16) {
    osm::OsArgs p{static_cast<const __nv_bfloat16*>(a),
                  static_cast<const __nv_bfloat16*>(b),
                  out, ws, nullptr, nullptr, m, n, k, lda, ldb, bm,
                  bn, bk, 0, rows, seg};
    osm::set_experts(p, experts, ea, eb, 0, 0);
    return osm::launch<false>(p, b_trans, out_dtype, s);
  }
  if (experts != 1 || ws || rows || seg || lda != k ||
      ldb != (b_trans ? k : n))
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
    return rt::dispatch_mma<true>(a, b, out, ws, m, n, k, bk, gx, gy, split,
                                  rows, b_trans, s);
  if (in_dtype != rt::kF32 || gx != n / bn) return (int)cudaErrorInvalidValue;
  return rt::dispatch_revisit<true>(a, b, out, m, n, k, bm, bn, bk, gy,
                                    b_trans, s);
}

// float32: (gx, gy) = (m / bm, N-block groups) of the scalar kernel, ``ws``,
// ``split`` and ``rows`` unused; bf16: the tensor-core grid of
// ``input_grid``, with ``ws`` the (k / bk, m, n) float32 workspace of a
// split grid.
extern "C" int fm_input(const void* a, const void* b, float* out, float* ws,
                        int m, int n, int k, int bm, int bn, int bk, int gx,
                        int gy, int split, int rows, int b_trans,
                        int in_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == rt::kBF16)
    return rt::dispatch_mma<false>(a, b, out, ws, m, n, k, bk, gx, gy, split,
                                   rows, b_trans, s);
  if (in_dtype != rt::kF32 || gx != m / bm) return (int)cudaErrorInvalidValue;
  return rt::dispatch_revisit<false>(a, b, out, m, n, k, bm, bn, bk, gy,
                                     b_trans, s);
}

