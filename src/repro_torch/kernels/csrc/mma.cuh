// Tensor-core building blocks of the port's bf16 kernels (sm_90a, CUDA C++).
//
// Products are ``mma.sync.m16n8k16`` (one warp, fed by ``ldmatrix``) or
// ``wgmma.mma_async.m64n64k16`` (one warpgroup, A from registers, B from
// 128-byte-swizzled shared memory through a matrix descriptor), bf16
// operands and float32 accumulators; staging is 16-byte ``cp.async``; the
// flash kernel's producer/consumer ring adds ``mbarrier`` helpers.  The
// bf16 x bf16 products are exact in float32; the tensor core sums them in
// its own order, so results agree with a float32 FMA loop only to float32
// rounding (tolerances, never bits).
//
// The weight-stationary tile (``stage_a`` / ``stage_b`` / ``mac_chunk`` /
// ``store_acc``) computes a (TMR x 128) float32 block of C = A @ B for one
// K-block held in shared memory:
//
//   A  (M, K) row-major, staged in chunks of TMR rows x 64 columns;
//   B  (K, N) row-major, or the transpose of a row-major (N, K) matrix
//      (``BT``: the stored lm_head, read in place), staged whole for the
//      K-block: kpad x 128 (kpad = bk rounded up to 64);
//   TMR = 16 (M <= 16: the decode rows, zero-padded in shared memory, never
//      in device memory) or 64 (eight warps as 2 x 4 warp tiles of 32 x 32).
//
// Shared tiles are panels of 64 bf16 per row (128 bytes) whose 16-byte
// chunks are permuted by row % 8 (``swz64``), so the eight row addresses of
// an ldmatrix land in eight different bank groups.  Ragged edges (rows past
// M, columns past N or past the K-block) are zero in shared memory, and zero
// products leave a float32 sum unchanged.
//
// Used by ``fm_weight`` and ``fm_input`` (flex_matmul.cu, mma.sync: the
// same tile, so the two revisit dataflows agree bit for bit), by the bf16
// flash-attention kernel (wgmma, barrier and staging primitives), and by
// the output-stationary template of ``os_mma.cuh`` that bf16 ``fm_output``
// and ``bs_matmul`` and bf16-activation ``i8_matmul`` and
// ``bs_matmul_scaled`` share (its 16-row tile at M <= 16; its wgmma tile
// above).  Each mma.sync / wgmma k-step sums one 16-element K group into
// the float32 accumulator; ``os_mma.cuh`` issues them in one order fixed by
// K alone (groups from K offset 0 ascending, in segments of a constant
// length added in order), the invariant that keeps the dense and the
// block-sparse products bit-equal.  At decode (M = 4) these tiles are
// bound by the weight's bytes, at prefill (M = 8192) by the tensor cores'
// operations (``fm_weight`` and ``fm_input``: by their float32
// read-modify-write).  The swizzled panels (``swz64``) are the layout
// wgmma's 128-byte-swizzle descriptors and TMA's CU_TENSOR_MAP_SWIZZLE_128B
// use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // threads of a weight-stationary tile block
constexpr int kKC = 64;         // K columns of one staged A chunk
constexpr int kTN = 128;        // output columns of one block (its strip)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a · b for one 16 x 8 x 16 tile: ``a`` the row-major A fragment,
// (b0, b1) the column-major B fragment (PTX ISA, mma.m16n8k16 layouts).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and r[i] receives its fragment (``_t``: transposed).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two floats rounded to nearest even into one bf16x2 register (x low).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp_async_wait<n> for a count known only at run time (0 <= n <= 2).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n == 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make initialised barriers visible before any thread or copy uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}

// Wait until the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// wgmma (warpgroup matrix multiply): four warps issue one asynchronous
// 64 x N x 16 product, B from shared memory through a descriptor
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (PTX ISA
// "matrix descriptor"): start address, leading and stride byte offsets.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving register reads or writes of a wgmma's
// operands across wgmma.fence / wait_group, which do not name them (what
// CUTLASS's warpgroup_fence_operand does).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void pin(float (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) pin(d[i]);
}

// Hand registers back to the SM (``dec``) or take them (``inc``): every warp
// of the warpgroup runs the same instruction; N a multiple of 8 in [24, 256].
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Order this thread's generic-proxy shared-memory writes (st.shared,
// cp.async) before the async-proxy reads of a later wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64, float32, this warpgroup) += a (64 x 16 bf16, registers: each
// warp its 16 rows as an mma.m16n8k16 A fragment) · B (16 x 64 bf16 in
// shared memory, ``desc``); TB: B stored n-major (transposed) rather than
// k-major.
template <int TB>
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB),
        "r"(1));
}

// d (64 x 64, float32, this warpgroup) += A (64 x 16 bf16 in shared memory,
// k-major, ``da``) · B (16 x 64 bf16 in shared memory, ``db``); TB as for
// ``wgmma64``.  No A registers to keep intact while the product runs.  With
// ``acc`` 0 the product overwrites d instead (d's values are not read).
template <int TB>
__device__ __forceinline__ void wgmma64_ss(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

// Element offset of (row, col) in a panel of 64-element rows, the 16-byte
// chunks of each row permuted by row % 8.
__device__ __forceinline__ int swz64(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Eight consecutive elements: the first ``n`` from ``src`` (n may be <= 0),
// the rest zero, written as one 16-byte shared store.
__device__ __forceinline__ void store8(bf16* dst, const bf16* src, int n) {
  uint4 u;
  bf16* t = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = i < n ? src[i] : __float2bfloat16(0.f);
  *reinterpret_cast<uint4*>(dst) = u;
}

// Warp layout of a (TMR x 128) output tile over the 8 warps: WM x (8 / WM)
// warps, each owning MI m16 tiles by NI n8 tiles.
template <int TMR> struct Warps;
template <> struct Warps<16> { static constexpr int WM = 1, MI = 1, NI = 2; };
template <> struct Warps<64> { static constexpr int WM = 2, MI = 2, NI = 4; };

// Stage TMR rows x 64 columns of A (``A`` at the chunk's origin, row stride
// ``lda``) into ``As``; rows >= ``mrows`` and columns >= ``kc`` are zero.
// ``vec``: the chunk's rows are 16-byte aligned (cp.async).
template <int TMR>
__device__ __forceinline__ void stage_a(bf16* As, const bf16* __restrict__ A,
                                        int lda, int mrows, int kc, bool vec) {
  for (int c = threadIdx.x; c < TMR * 8; c += kThreads) {
    const int r = c >> 3, k8 = (c & 7) << 3;
    bf16* dst = As + swz64(r, k8);
    const bf16* src = A + (size_t)r * lda + k8;
    if (vec && r < mrows && k8 + 8 <= kc)
      cp_async16(smem_u32(dst), src);
    else
      store8(dst, src, r < mrows ? kc - k8 : 0);
  }
}

// Stage a K-block of B — kc rows of k, nc columns of n, at the tile origin
// ``B`` (element (k, n) at B[k * ldb + n], or at B[n * ldb + k] when BT) —
// into ``Bs`` as 64-wide panels: along n (BT false: 2 panels of kpad x 64)
// or along k (BT true: kpad / 64 panels of 128 x 64).  Zero outside.
template <bool BT>
__device__ __forceinline__ void stage_b(bf16* Bs, const bf16* __restrict__ B,
                                        int ldb, int kc, int nc, int kpad,
                                        bool vec) {
  if (!BT) {
    for (int c = threadIdx.x; c < kpad * (kTN / 8); c += kThreads) {
      const int k = c / (kTN / 8), n8 = (c % (kTN / 8)) * 8;
      bf16* dst = Bs + (n8 >> 6) * kpad * 64 + swz64(k, n8 & 63);
      const bf16* src = B + (size_t)k * ldb + n8;
      if (vec && k < kc && n8 + 8 <= nc)
        cp_async16(smem_u32(dst), src);
      else
        store8(dst, src, k < kc ? nc - n8 : 0);
    }
  } else {
    const int kch = kpad / 8;
    for (int c = threadIdx.x; c < kTN * kch; c += kThreads) {
      const int n = c / kch, k8 = (c % kch) * 8;
      bf16* dst = Bs + (k8 >> 6) * kTN * 64 + swz64(n, k8 & 63);
      const bf16* src = B + (size_t)n * ldb + k8;
      if (vec && n < nc && k8 + 8 <= kc)
        cp_async16(smem_u32(dst), src);
      else
        store8(dst, src, n < nc ? kc - k8 : 0);
    }
  }
}

template <int TMR>
using Acc = float[Warps<TMR>::MI][Warps<TMR>::NI][4];

template <int TMR>
__device__ __forceinline__ void zero_acc(Acc<TMR>& acc) {
#pragma unroll
  for (int i = 0; i < Warps<TMR>::MI; ++i)
#pragma unroll
    for (int j = 0; j < Warps<TMR>::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc += As (TMR x 64) · Bs[k0 : k0 + 64, 0 : 128] on the tensor cores.
template <int TMR, bool BT>
__device__ __forceinline__ void mac_chunk(Acc<TMR>& acc, const bf16* As,
                                          const bf16* Bs, int kpad, int k0) {
  using W = Warps<TMR>;
  constexpr int WN = 8 / W::WM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
#pragma unroll
  for (int ks = 0; ks < kKC / 16; ++ks) {
    uint32_t a[W::MI][4];
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi)
      ldsm_x4(a[mi], smem_u32(As + swz64(wm * W::MI * 16 + mi * 16 +
                                             (lane & 15),
                                         ks * 16 + (lane >> 4) * 8)));
    const int kr = k0 + ks * 16;
#pragma unroll
    for (int nb = 0; nb < W::NI / 2; ++nb) {
      uint32_t b[4];
      if (!BT) {
        const int n = wn * W::NI * 8 + nb * 16 + (lane >> 4) * 8;
        const int k = kr + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(b, smem_u32(Bs + (n >> 6) * kpad * 64 + swz64(k, n & 63)));
      } else {
        const int n = wn * W::NI * 8 + nb * 16 + (lane & 7) + (lane >> 4) * 8;
        const int k = kr + ((lane >> 3) & 1) * 8;
        ldsm_x4(b, smem_u32(Bs + (k >> 6) * kTN * 64 + swz64(n, k & 63)));
      }
#pragma unroll
      for (int mi = 0; mi < W::MI; ++mi) {
        mma_bf16(acc[mi][2 * nb], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * nb + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// Stage rows [0, mrows) x columns [0, ncols) of a float32 tile (``src`` at
// its origin, row stride ``ldg``) into ``dst`` (row stride ``lds``, a
// multiple of 4); other elements are left as they are.  ``vec``: ``src``'s
// rows are 16-byte aligned (cp.async, 16 bytes at a time).
__device__ __forceinline__ void stage_f32(float* dst, int lds,
                                          const float* __restrict__ src,
                                          int ldg, int mrows, int ncols,
                                          bool vec) {
  for (int c = threadIdx.x; c < mrows * (kTN / 4); c += kThreads) {
    const int r = c / (kTN / 4), c4 = (c % (kTN / 4)) * 4;
    float* d = dst + r * lds + c4;
    const float* s = src + (size_t)r * ldg + c4;
    if (vec && c4 + 4 <= ncols) {
      cp_async16(smem_u32(d), s);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c4 + i < ncols) d[i] = s[i];
    }
  }
}

// Write the tile's accumulators at ``out`` (its origin, row stride ``ldo``)
// masked to (mrows, ncols), or with ``add`` accumulate them into the float32
// values there: out = out + acc, one rounding per element.  With ``old``
// (shared memory, row stride ``ld_old``) the values added to are read
// there instead: out = old + acc.
template <int TMR>
__device__ __forceinline__ void store_acc(float* out, int ldo,
                                          const Acc<TMR>& acc, int mrows,
                                          int ncols, bool add,
                                          const float* old = nullptr,
                                          int ld_old = 0) {
  using W = Warps<TMR>;
  constexpr int WN = 8 / W::WM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN, g = lane >> 2, t = lane & 3;
  const bool pairs = (ldo & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * W::MI * 16 + mi * 16 + g + 8 * h;
      if (r >= mrows) continue;
#pragma unroll
      for (int ni = 0; ni < W::NI; ++ni) {
        const int c = wn * W::NI * 8 + ni * 8 + 2 * t;
        float* p = out + (size_t)r * ldo + c;
        const float* q = old ? old + r * ld_old + c : p;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (pairs && c + 1 < ncols) {
          float2 o = make_float2(v0, v1);
          if (add) {
            const float2 w = *reinterpret_cast<const float2*>(q);
            o.x = __fadd_rn(w.x, v0);
            o.y = __fadd_rn(w.y, v1);
          }
          *reinterpret_cast<float2*>(p) = o;
        } else {
          if (c < ncols) p[0] = add ? __fadd_rn(q[0], v0) : v0;
          if (c + 1 < ncols) p[1] = add ? __fadd_rn(q[1], v1) : v1;
        }
      }
    }
}

// Dynamic shared memory of a weight-stationary block: the B tile (kpad x
// 128) and a two-stage ring of A chunks (TMR x 64), all bf16.
__host__ __device__ inline size_t ws_smem_bytes(int tmr, int bk) {
  const int kpad = (bk + kKC - 1) / kKC * kKC;
  return ((size_t)kpad * kTN + 2 * (size_t)tmr * kKC) * sizeof(bf16);
}

// The input-stationary block's B ring (64 x 128 bf16 chunks), the float32
// output tiles an owning block reads ahead of their read-modify-write, and
// their row stride (a store_acc warp then reads 32 banks).
constexpr int kRing = 3;
constexpr int kOutTiles = 2;
constexpr int kOutLd = kTN + 8;

// Dynamic shared memory of an input-stationary block: two A blocks (TMR x
// kpad bf16: this one and the next), the ring and, owning, the float32
// output tiles (TMR x kOutLd).
__host__ __device__ inline size_t is_smem_bytes(int tmr, int bk, int split) {
  const int kpad = (bk + kKC - 1) / kKC * kKC;
  return (2 * (size_t)tmr * kpad + (size_t)kRing * kKC * kTN) * sizeof(bf16) +
         (split ? 0 : (size_t)kOutTiles * tmr * kOutLd * sizeof(float));
}

}  // namespace mma
