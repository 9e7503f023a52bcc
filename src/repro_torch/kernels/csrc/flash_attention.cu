// Blockwise (flash) attention for Hopper (sm_90a), causal and sliding window.
//
//   fa_forward  replaces the Pallas TPU kernel ``_fa_kernel``
//               (src/repro/kernels/flash_attention.py:25, launched at :84 by
//               ``_flash``): O = softmax(Q Kᵀ · hd^-0.5 + mask) V per head,
//               with q (BH, Sq, hd), k / v (BH, Skv, hd), float32 or bfloat16,
//               the running (m, l, acc) in float32 and O in q's type.  The
//               sequence ends are aligned (offset = Skv - Sq: the last Sq
//               positions query); masked scores are -1e30, never -inf.
//
// The TPU grid (bh, q-block, kv-block) runs its kv axis in order on one
// core, carrying (m, l, acc) in VMEM scratch.  Here a CUDA block owns q rows
// of one head and walks the kv tiles of 64 rows in ascending order inside
// the block; nothing carries between blocks.  Each 64-row q block visits
// exactly the kv tiles that ``_fa_kernel``'s liveness test keeps (causal:
// k_lo <= q_lo + 63; window: q_lo - (k_lo + 63) < window), so it makes the
// reference's sequence of online-softmax updates, whose order depends only
// on the 64-row kv tile.  The arithmetic is the reference's: scores summed
// in float32 then scaled, p = exp(s - m) with a true expf, alpha =
// exp(m_old - m_new), l = l·alpha + Σp (Σp of the float32 p), p rounded to
// V's type before the PV product, acc = acc·alpha + PV, O = acc /
// max(l, 1e-30); separate roundings are written with __fmul_rn / __fadd_rn
// so the compiler does not contract them into FMAs.  A row that has seen
// only masked keys gets p = 1 entries that the first real score wipes
// (alpha = 0), as in the reference.  Blocks run the heaviest causal q tiles
// first.
//
// What bounds it on the H100: at StableLM-1.6B's prefill cell (BH = 64,
// S = 4096, hd = 64, causal) the tensor-core work is 2·2·64·4096²·64 / 2 =
// 1.37e11 FLOPs, 0.139 ms at 989 TFLOP/s; the bytes (q, k, v, o in bf16,
// 134 MB) take 0.040 ms — so it is bound by operations, and behind them by
// the softmax: ~5.4e8 scores, each with a true expf and ~20 float32 ALU
// operations, which no tensor core does.
//
// bf16 (``fa_kernel_mma``, the prefill path): a block owns 128 q rows of one
// head — two consumer warpgroups of 64 rows, one reference q block each —
// plus one producer warp.  The producer streams each live 64-row K and V
// tile with cp.async into a three-stage shared-memory ring of 64-column
// panels, 128-byte swizzled as wgmma reads them; once a tile has landed it
// fences it for the async proxy and signals the stage's ``full`` mbarrier;
// consumers release a stage through its ``empty`` mbarrier.  S = Q·Kᵀ and
// P·V are wgmma.mma_async.m64n64k16 on bf16 with float32 accumulators, A
// from registers (q's fragments, loaded from shared memory with ldmatrix;
// P straight from the S accumulators, rounded to bf16, nearest even) and B
// from shared memory (K k-major, V n-major).  q's fragments are reloaded
// for every tile: ptxas does not keep a loop-carried register A operand of
// wgmma intact, and reused its registers for P (checked in the SASS).  Row
// max and sum are quad shuffles in the accumulator layout; the -1e30 mask
// is computed only on a warp's diagonal (or window edge) tiles.  A q block
// skips kv tiles dead under the reference's test (its warps still pass
// through the ring), so the 128-row block does not change the arithmetic;
// a last q tile of 64 rows runs its first warpgroup only.  hd 32 uses half
// of a panel (P·V's upper 32 columns are computed and dropped).  hd 256
// keeps the 64-row kv tile and the 128-row q block, so its order and
// arithmetic are those of the smaller heads; what changes is where q lives.
// Its fragments (64 registers) beside the accumulator (128) would pass the
// 168 registers a thread of this 9-warp block gets (three warps share each
// quarter of the register file), and q's padded rows with a three-stage
// ring would pass the 227 KB of shared memory, so q is staged once as four
// swizzled 64-column panels that S = Q·Kᵀ reads as wgmma's A descriptor,
// and the ring has two stages: 197,664 bytes in all.
//
// float32 (``fa_kernel``): the first version, kept as the reference's
// float32 arithmetic — one block of 256 threads per (bh, 64-row q tile),
// scalar float32 FMAs from shared memory, synchronous staging; thread
// (ty, tx) owns score rows ty + 16r and columns tx + 16c (r, c < 4).
#include "mma.cuh"
#include "os_mma.cuh"   // TMA: make_tmap, tma_load, bulk_load
#include "tile.cuh"

namespace fa {

constexpr int kBQ = 64;            // q rows of a reference q block
constexpr int kBKV = 64;           // kv rows per staged tile
constexpr int kThreads = 256;
constexpr int kGX = 16, kGY = 16;  // thread grid: tx = score column, ty = row
constexpr int kR = kBQ / kGY;      // rows per thread
constexpr int kC = kBKV / kGX;     // score columns per thread
constexpr int kLD = kBQ + 1;       // padded stride of the transposed tiles
constexpr float kNegInf = -1e30f;

static_assert(kBQ == kBKV, "the transposed q and k tiles share kLD");
static_assert(kGX * kGY == kThreads, "thread grid must cover the block");

template <int HD>
constexpr size_t smem_bytes() {
  // qs[HD][kLD] + ks[HD][kLD] + vs[kBKV][HD] + ps[kBQ][kLD], all float
  return sizeof(float) *
         ((size_t)2 * HD * kLD + (size_t)kBKV * HD + (size_t)kBQ * kLD);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// float32.  Block b = bh * nq + t owns rows [qi·64, qi·64 + 64) of head bh,
// where qi = nq - 1 - t (the longest causal kv range first).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ Q, const T* __restrict__ K,
          const T* __restrict__ V, T* __restrict__ O, float* __restrict__ LSE,
          int sq, int skv, int nq, int causal, int window, float scale) {
  constexpr int CO = HD / kGX;     // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);     // [HD][kLD], d-major
  float* ks = qs + HD * kLD;                      // [HD][kLD], d-major
  float* vs = ks + HD * kLD;                      // [kBKV][HD]
  float* ps = vs + kBKV * HD;                     // [kBQ][kLD]

  const int tid = threadIdx.x, ty = tid / kGX, tx = tid % kGX;
  const int bh = blockIdx.x / nq;
  const int qi = nq - 1 - blockIdx.x % nq;
  const int q_lo = qi * kBQ + (skv - sq);       // first absolute q position
  const T* q = Q + ((size_t)bh * sq + (size_t)qi * kBQ) * HD;
  const T* k = K + (size_t)bh * skv * HD;
  const T* v = V + (size_t)bh * skv * HD;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    qs[d * kLD + r] = rt::to_f(q[(size_t)r * HD + d]);
  }

  float m[kR], l[kR], acc[kR][CO];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[r][c] = 0.f;
  }

  const int nkv = skv / kBKV;
  for (int ki = 0; ki < nkv; ++ki) {
    const int k_lo = ki * kBKV;
    // the reference's block liveness (uniform over the block)
    if (causal && k_lo > q_lo + kBQ - 1) continue;
    if (window && q_lo - (k_lo + kBKV - 1) >= window) continue;

    __syncthreads();               // the last tile's readers are done
    for (int idx = tid; idx < kBKV * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      const size_t g = (size_t)(k_lo + j) * HD + d;
      ks[d * kLD + j] = rt::to_f(k[g]);
      vs[j * HD + d] = rt::to_f(v[g]);
    }
    __syncthreads();

    // s = (q · k) in float32, then scaled, then masked
    float s[kR][kC];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[kR], b[kC];
#pragma unroll
      for (int r = 0; r < kR; ++r) a[r] = qs[d * kLD + ty + r * kGY];
#pragma unroll
      for (int c = 0; c < kC; ++c) b[c] = ks[d * kLD + tx + c * kGX];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kC; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int qpos = q_lo + ty + r * kGY;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        s[r][c] = __fmul_rn(s[r][c], scale);
        const int kpos = k_lo + tx + c * kGX;
        bool ok = true;
        if (causal) ok = qpos >= kpos;
        if (window) ok = ok && (qpos - kpos) < window;
        if (!ok) s[r][c] = kNegInf;
      }
    }

    // online softmax update of (m, l); p rounded to V's type into ps
    float alpha[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int c = 1; c < kC; ++c) mx = fmaxf(mx, s[r][c]);
      const float m_new = fmaxf(m[r], row_max16(mx));
      alpha[r] = expf(__fsub_rn(m[r], m_new));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float p = expf(__fsub_rn(s[r][c], m_new));
        sum = __fadd_rn(sum, p);
        ps[(ty + r * kGY) * kLD + tx + c * kGX] = rt::to_f(rt::from_f<T>(p));
      }
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), row_sum16(sum));
      m[r] = m_new;
    }
    __syncthreads();               // ps is written by the row's 16 lanes

    // acc = acc·alpha + p @ v
    float pv[kR][CO];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < CO; ++c) pv[r][c] = 0.f;
#pragma unroll 8
    for (int j = 0; j < kBKV; ++j) {
      float a[kR], b[CO];
#pragma unroll
      for (int r = 0; r < kR; ++r) a[r] = ps[(ty + r * kGY) * kLD + j];
#pragma unroll
      for (int c = 0; c < CO; ++c) b[c] = vs[j * HD + tx + c * kGX];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < CO; ++c) pv[r][c] = fmaf(a[r], b[c], pv[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < CO; ++c)
        acc[r][c] = __fadd_rn(__fmul_rn(acc[r][c], alpha[r]), pv[r][c]);
  }

  T* o = O + ((size_t)bh * sq + (size_t)qi * kBQ) * HD;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < CO; ++c)
      o[(size_t)(ty + r * kGY) * HD + tx + c * kGX] =
          rt::from_f<T>(__fdiv_rn(acc[r][c], den));
    if (LSE != nullptr && tx == 0)
      LSE[(size_t)bh * sq + qi * kBQ + ty + r * kGY] =
          __fadd_rn(m[r], logf(l[r]));
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 128;      // q rows per CUDA block
constexpr int kConsumers = 8;      // warps of 16 q rows: two warpgroups
constexpr int kMmaThreads = (kConsumers + 1) * 32;   // + the producer warp
constexpr int kPanel = kBKV * 64;  // one 64-row x 64-column bf16 panel

// 64-column panels of a K or V tile (hd 32 uses half of one)
template <int HD>
constexpr int kPanels = HD < 64 ? 1 : HD / 64;

// hd 256: q is read by wgmma from shared memory (swizzled 128-row panels),
// not from registers, and the K/V ring has two stages, not three (three
// would take 265,264 bytes of shared memory; see the file's head)
template <int HD>
constexpr bool kQShared = HD > 128;
template <int HD>
constexpr int kStages = kQShared<HD> ? 2 : 3;   // K/V ring depth

template <int HD>
constexpr size_t mma_smem_bytes() {
  // 1 KB of alignment slack, kStages x (k, v) panels, q ([128][HD + 8], or
  // HD / 64 swizzled [128][64] panels), then the full / empty barriers
  return 1024 + sizeof(__nv_bfloat16) *
                    ((size_t)kStages<HD> * 2 * kPanels<HD> * kPanel +
                     (size_t)kMmaRows * (kQShared<HD> ? HD : HD + 8)) +
         2 * kStages<HD> * sizeof(uint64_t);
}

// Block b owns q rows [128·qt, 128·qt + 128) of head b % bh with
// qt = nq - 1 - b / bh (every head's longest causal kv ranges first).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 1)
fa_kernel_mma(const __nv_bfloat16* __restrict__ Q,
              const __nv_bfloat16* __restrict__ K,
              const __nv_bfloat16* __restrict__ V,
              __nv_bfloat16* __restrict__ O, float* __restrict__ LSE, int nbh,
              int sq, int skv, int nq, int causal, int window, float scale) {
  using mma::bf16;
  constexpr int LD = HD + 8;         // padded q rows: conflict-free ldmatrix
  constexpr int CH = HD / 8;         // 16-byte chunks per row
  constexpr int NP = kPanels<HD>;
  constexpr int NT = HD < 64 ? HD / 8 : 8;   // n8 tiles kept of a PV panel
  constexpr int ST = kStages<HD>;
  constexpr bool QS = kQShared<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled panels need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (mma::smem_u32(smem_raw) & 1023))
                                    & 1023);
  bf16* kvs = reinterpret_cast<bf16*>(smem);       // stage s: k then v
  bf16* qs = kvs + ST * 2 * NP * kPanel;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(qs + kMmaRows * (QS ? HD : LD));
  uint64_t* empty = full + ST;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x % nbh;
  const int row0 = (nq - 1 - blockIdx.x / nbh) * kMmaRows;
  const int halves = min(kMmaRows, sq - row0) / kBQ;   // 2, or 1 at the end
  const int offset = skv - sq;
  const int nkv = skv / kBKV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mma::mbar_init(mma::smem_u32(&full[s]), 32);
      mma::mbar_init(mma::smem_u32(&empty[s]), 4 * halves);
    }
    mma::fence_barrier_init();
  }
  const bf16* q = Q + ((size_t)bh * sq + row0) * HD;
  for (int c = threadIdx.x; c < halves * kBQ * CH; c += kMmaThreads) {
    const int r = c / CH, d = (c % CH) * 8;
    const int off = QS ? (d >> 6) * kMmaRows * 64 + mma::swz64(r, d & 63)
                       : r * LD + d;
    *reinterpret_cast<uint4*>(qs + off) =
        *reinterpret_cast<const uint4*>(q + (size_t)r * HD + d);
  }
  if (QS) mma::fence_proxy_async();   // wgmma reads q through the async proxy
  __syncthreads();

  // the reference's liveness of kv tile ki for q block h of this block
  auto live = [&](int ki, int h) {
    const int q_lo = row0 + h * kBQ + offset, k_lo = ki * kBKV;
    if (h >= halves) return false;
    if (causal && k_lo > q_lo + kBQ - 1) return false;
    if (window && q_lo - (k_lo + kBKV - 1) >= window) return false;
    return true;
  };

  if (warp == kConsumers) {
    // producer: the block's live kv tiles, in order, into the ring, as
    // 64-column panels swizzled like the tensor cores read them; a tile is
    // signalled once it has landed and been made visible to them
    const bf16* kg = K + (size_t)bh * skv * HD;
    const bf16* vg = V + (size_t)bh * skv * HD;
    int it = 0, pending = -1;
    for (int ki = 0; ki < nkv; ++ki) {
      if (!live(ki, 0) && !live(ki, 1)) continue;
      const int s = it % ST;
      mma::mbar_wait(mma::smem_u32(&empty[s]), ((it / ST) & 1) ^ 1);
      bf16* ks = kvs + s * 2 * NP * kPanel;
      bf16* vs = ks + NP * kPanel;
      const size_t g0 = (size_t)ki * kBKV * HD;
      for (int c = lane; c < kBKV * CH; c += 32) {
        const int r = c / CH, d = (c % CH) * 8;
        const int off = (d >> 6) * kPanel + mma::swz64(r, d & 63);
        mma::cp_async16(mma::smem_u32(ks + off), kg + g0 + r * HD + d);
        mma::cp_async16(mma::smem_u32(vs + off), vg + g0 + r * HD + d);
      }
      mma::cp_async_commit();
      if (pending >= 0) {
        mma::cp_async_wait<1>();
        mma::fence_proxy_async();
        mma::mbar_arrive(mma::smem_u32(&full[pending]));
      }
      pending = s;
      ++it;
    }
    if (pending >= 0) {
      mma::cp_async_wait<0>();
      mma::fence_proxy_async();
      mma::mbar_arrive(mma::smem_u32(&full[pending]));
    }
    return;
  }
  const int h = warp / 4;
  if (h >= halves) return;

  // consumer warp: rows [16·warp, 16·warp + 16) of the block; this thread
  // holds rows g and g + 8 of them, columns 2t and 2t + 1 of each n8 tile
  const int g = lane >> 2, t = lane & 3;
  const int qpos0 = row0 + warp * 16 + offset;   // the warp's first position
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int it = 0;
  for (int ki = 0; ki < nkv; ++ki) {
    const bool l0 = live(ki, 0), l1 = live(ki, 1);
    if (!l0 && !l1) continue;
    const int s = it % ST;
    mma::mbar_wait(mma::smem_u32(&full[s]), (it / ST) & 1);
    ++it;
    if (h == 0 ? l0 : l1) {
      const uint32_t ks = mma::smem_u32(kvs + s * 2 * NP * kPanel);
      const uint32_t vs = ks + NP * kPanel * 2;
      const int k_lo = ki * kBKV;
      // s = (q · k) in float32 on the tensor cores (k read k-major), then
      // scaled and masked
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      if constexpr (QS) {
        // q's 64 rows of this warpgroup straight from its swizzled panels
        const uint32_t qa = mma::smem_u32(qs) + h * 64 * 128;
        mma::pin(sc);
        mma::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          mma::wgmma64_ss<0>(
              sc,
              mma::sw128_desc(qa + (kk >> 2) * kMmaRows * 128 + (kk & 3) * 32,
                              16, 1024),
              mma::sw128_desc(ks + (kk >> 2) * kPanel * 2 + (kk & 3) * 32, 16,
                              1024));
        mma::wgmma_commit();
        mma::wgmma_wait<0>();
        mma::pin(sc);
      } else {
        // q's fragments, reloaded for every tile: a register A operand
        // carried across the loop is not kept intact between wgmma batches
        uint32_t qf[HD / 16][4];
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          mma::ldsm_x4(qf[kk], mma::smem_u32(qs + (warp * 16 + (lane & 15)) *
                                                 LD + kk * 16 +
                                             (lane >> 4) * 8));
        mma::pin(sc);
        mma::pin(qf);
        mma::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          mma::wgmma64<0>(sc, qf[kk],
                          mma::sw128_desc(ks + (kk >> 2) * kPanel * 2 +
                                              (kk & 3) * 32,
                                          16, 1024));
        mma::wgmma_commit();
        mma::wgmma_wait<0>();
        mma::pin(sc);
        mma::pin(qf);
      }
      const bool edge = (causal && k_lo + kBKV - 1 > qpos0) ||
                        (window && qpos0 + 15 - k_lo >= window);
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = __fmul_rn(sc[4 * j + e], scale);
          if (edge) {
            const int qp = qpos0 + g + (e >> 1) * 8;
            const int kp = k_lo + j * 8 + 2 * t + (e & 1);
            bool ok = true;
            if (causal) ok = qp >= kp;
            if (window) ok = ok && (qp - kp) < window;
            if (!ok) v = kNegInf;
          }
          sc[4 * j + e] = v;
        }
      // online softmax update of (m, l); p kept in float32 for Σp
      float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = sc[2 * r];
#pragma unroll
        for (int j = 0; j < kBKV / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[r] = fmaxf(m[r], mx);
        alpha[r] = expf(__fsub_rn(m[r], m_new[r]));
      }
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(__fsub_rn(sc[4 * j + e], m_new[e >> 1]));
          sum[e >> 1] = __fadd_rn(sum[e >> 1], p);
          sc[4 * j + e] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 1));
        sum[r] = __fadd_rn(sum[r], __shfl_xor_sync(0xffffffffu, sum[r], 2));
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), sum[r]);
        m[r] = m_new[r];
      }
      // p rounded to V's type: the A operand of P·V, straight from registers
      uint32_t pf[kBKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        pf[kk][0] = mma::pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pf[kk][1] = mma::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pf[kk][2] = mma::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pf[kk][3] = mma::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      // acc = acc·alpha + P·V, one 64-column panel of v (read n-major) at a
      // time
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        float pv[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) pv[i] = 0.f;
        mma::pin(pv);
        mma::pin(pf);
        mma::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBKV / 16; ++kk)
          mma::wgmma64<1>(pv, pf[kk],
                     mma::sw128_desc(vs + pn * kPanel * 2 + kk * 16 * 128,
                                kPanel * 2, 1024));
        mma::wgmma_commit();
        mma::wgmma_wait<0>();
        mma::pin(pv);
        mma::pin(pf);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[pn * 8 + n][e] = __fadd_rn(
                __fmul_rn(acc[pn * 8 + n][e], alpha[e >> 1]), pv[4 * n + e]);
      }
    }
    __syncwarp();
    if (lane == 0) mma::mbar_arrive(mma::smem_u32(&empty[s]));
  }

  bf16* o = O + ((size_t)bh * sq + row0 + warp * 16) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)(g + 8 * r) * HD +
                                         n * 8 + 2 * t) =
          __floats2bfloat162_rn(__fdiv_rn(acc[n][2 * r], den),
                                __fdiv_rn(acc[n][2 * r + 1], den));
    if (LSE != nullptr && t == 0)
      LSE[(size_t)bh * sq + row0 + warp * 16 + g + 8 * r] =
          __fadd_rn(m[r], logf(l[r]));
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int sq, int skv, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  static_assert(smem <= (size_t)rt::kSmemLimit, "tile too large");
  auto kern = fa_kernel_mma<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nq = (sq + kMmaRows - 1) / kMmaRows;
  kern<<<dim3((unsigned)bh * nq), kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, bh, sq, skv, nq, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int sq, int skv, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= (size_t)rt::kSmemLimit, "tile too large");
  auto kern = fa_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nq = sq / kBQ;
  kern<<<dim3((unsigned)bh * nq), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, nq, causal,
      window, scale);
  return (int)cudaGetLastError();
}

// float32: the scalar kernel; bf16: the tensor-core kernel.
template <bool kBF16>
int dispatch_hd(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int sq, int skv, int hd, int causal,
                int window, float scale, cudaStream_t s) {
#define FA_CASE(HD)                                                        \
  case HD:                                                                 \
    return kBF16 ? launch_mma<HD>(q, k, v, o, lse, bh, sq, skv, causal,    \
                                  window, scale, s)                        \
                 : launch<float, HD>(q, k, v, o, lse, bh, sq, skv, causal, \
                                     window, scale, s);
  switch (hd) {
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace fa

// ---------------------------------------------------------------------------
// backward (no Pallas counterpart: the reference differentiates its XLA twin,
// ``models.attention.flash_attention_xla``, with autodiff)
// ---------------------------------------------------------------------------
//
// fa_backward computes dQ, dK, dV of fa_forward's function from q, k, v, o,
// dO (all of one type) and the forward's row log-sum-exp, in float32,
// without atomics, in three passes:
//   fab_dot : D = rowsum(dO∘O), one warp a row;
//   fab_kv  : one CUDA block per kv tile (and head) walks its live q tiles
//             in ascending order (the forward's liveness), recomputes
//             S = Q·Kᵀ and P = exp(S·scale − lse) (0 where masked), dP = dO·Vᵀ
//             and dS = P∘(dP − D), and sums dV += Pᵀ·dO and dK += dSᵀ·Q in
//             registers; dK is scaled once at the end;
//   fab_q   : one CUDA block per q tile (and head) walks its live kv tiles
//             ascending, recomputes P and dS the same way, and sums
//             dQ += dS·K; dQ is scaled once at the end.
// Every output element has one owner that sums its terms in a fixed order,
// so two runs give the same bits.  The price is that S, P, dP and dS are
// computed twice (the first two passes' products S and dP again in the
// third): seven 64 x 64 x hd products per live tile pair where an
// atomics-based backward takes five.  P and dS are rounded to the operands'
// type (bf16: nearest even) before their products, as the plain version
// does (``ref.flash_attention_backward_plain``); the per-element arithmetic
// is a true expf of (s·scale − lse) and dS = p·(dP − D), each rounding
// written out (__fmul_rn / __fsub_rn).
//
// What bounds it on the H100: at StableLM-1.6B's training cell (BH 64,
// S 4096, hd 64, causal) the seven products over the ~64·4096²/2 live pairs
// are 7·2·64·8.4e6·64 = 4.8e11 FLOPs, 0.49 ms at 989 TFLOP/s (the five that
// the gradient needs: 0.35 ms); the bytes (q, k, v, o, dO in, dQ, dK, dV
// out in float32, lse, D) ~0.23 GB, 0.07 ms: bound by operations.  Beside
// the tensor cores sits the element work, done in both passes: each of the
// ~5.4e8 (P, dS) elements takes a true expf (~10 instructions) and ~5
// more, ~0.25 ms of the SMs' issue slots a pass at hd 64 — as much as a
// pass's products, so at hd 64 a warpgroup's chain of scores →
// element work → products, not either unit, sets the pace, and the design
// below is about keeping both units fed from several chains.  At hd 256
// the five products are 0.35 ms at Gemma-2B's cell (BH 16, S 4096, causal)
// and 0.52 ms at RecurrentGemma-9B's (BH 32, S 4096, window 2048), and the
// products dominate.
//
// bf16 (``fab_kv_kernel_mma`` / ``fab_q_kernel_mma``): the forward's
// structure turned to the gradient.  A block is two (fab_q at hd 64: three)
// consumer warpgroups and one producer warpgroup, one block an SM.  The
// producer hands its registers back (setmaxnreg 24) so the consumers may
// hold 240 (160 with three), and one of its threads streams the walked
// tiles with TMA (64-row boxes of 128-byte-swizzled 64-column panels, the
// layout wgmma's descriptors read) into a ring of single-tile slots guarded
// by full / empty mbarriers (the full barrier's transaction count tracks
// the boxes' bytes); the tiles a block owns are staged once the same way.
// Every product is wgmma.mma_async.m64n64k16 with float32 accumulators:
//   fab_kv (warpgroup = 64 kv rows): Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with both
//     operands from shared memory (K / V k-major as A, Q / dO k-major as
//     B), then Pᵀ and dSᵀ in the accumulator registers (lse and D per
//     column, from the ring slot where the producer copied them beside Q
//     and dO with a 1-D bulk copy), rounded to bf16 and fed straight back
//     as wgmma's register A operand of dV += Pᵀ·dO and dK += dSᵀ·Q (dO and
//     Q read n-major from the same slots).  At hd 64 and 128 a block owns
//     two kv tiles, one warpgroup each; the ring carries every q tile live
//     for either.
//   fab_q (warpgroup = 64 q rows, the heaviest causal tiles first): S =
//     Q·Kᵀ, dP = dO·Vᵀ (Q and dO staged once), dS in registers, dQ += dS·K
//     (K n-major); the ring carries K and V.
// So P and dS never touch shared memory, and the loop has no __syncthreads:
// a warpgroup waits only on its slots' barriers and its own products, and
// the warpgroups' element work and products overlap on the SM.  A score's
// first k-step overwrites its accumulator (wgmma's scale-d), the mask is
// computed only on a warp's diagonal or window-edge tiles and selects
// expf's argument (no branch), and where registers allow (fab_kv at hd 64,
// fab_q at hd 64 and 128) a pair's products run on while the next pair's
// scores are issued.  Control flow is uniform to ptxas (the warp index
// read from lane 0, barrier waits and arrivals without branches, constant
// wait counts, the first pair of an overlapped walk peeled): it serialised
// every product of the earlier drafts (C7511 / C7514 / C7520).
//
// hd 256: a warpgroup's dK and dV of a 64-row kv tile would take 256
// float32 registers a thread, more than a thread may hold, so the dK / dV
// block owns one kv tile and splits the work by output, not by column:
// warpgroup 0 sums dV (Sᵀ, Pᵀ, Pᵀ·dO), warpgroup 1 sums dK (Sᵀ, dPᵀ, dSᵀ,
// dSᵀ·Q), each 128 accumulators.  Sᵀ is computed in both: five products per
// live pair in this pass (the column halves of the first version took six),
// eight in all.
//
// ptxas -v (sm_90a): every bf16 kernel 168 registers at entry (fab_q at
// hd 64: 128, 512 threads) and 240 / 160 for consumers after setmaxnreg, no
// spills, no serialisation note; shared memory fab_kv 101,512 / 199,816 /
// 231,768 bytes at hd 64 / 128 / 256 (K and V once, a ring of eight, eight
// and five slots), fab_q 115,848 / 197,768 / 230,456 (Q and dO once, eight,
// eight and three slots).
//
// float32 (``fab_kv_kernel`` / ``fab_q_kernel``): the first version, kept as
// the reference's float32 arithmetic — scalar FMAs (no tensor cores, no
// TF32) in the m16n8k16 accumulator layout, tiles staged synchronously with
// padded rows.  A block has 8 warps: warp w owns rows 16·(w % 4) .. + 16 of
// a 64-row product and the column half w / 4.  At hd 256 a warp's 16 x 128
// slices of both dK and dV beside S, dP would pass the 255 registers a
// thread may hold, so ``fab_kv`` splits dK / dV into two column halves of
// 128, one CUDA block each (a block recomputes S and dP over all 256
// columns and sums only its half); the four 64 x 256 float32 tiles would
// take 301,568 bytes, so those blocks stage only the tiles they own (k and
// v in ``fab_kv``, q and dO in ``fab_q``) and read the tiles they walk in
// place from device memory (168,448 bytes).

namespace fab {

using mma::bf16;

constexpr int kB = 64;             // q and kv rows of a tile (the forward's)
constexpr int kThreads = 256;      // 8 warps (float32)

constexpr int kPad = 4;            // float32 row padding, elements

// column parts of dK / dV, one CUDA block of ``fab_kv`` each (float32)
template <int HD>
constexpr int kParts = HD > 128 ? 2 : 1;

// float32 at hd 256: the walked tiles are read in place from device memory
template <int HD>
constexpr bool kWalkInPlace = HD > 128;

// elements of a staged walked tile (none when read in place)
template <int HD>
constexpr int kWalkTile = kWalkInPlace<HD> ? 0 : kB * (HD + kPad);

// smem: the owned and the walked pairs of tiles [64][HD + pad] (fab_kv: k,
// v, then q, dO; fab_q: k, v, then q, dO, k and v being the walked ones),
// then P and dS [64][64 + pad], then lse and D of the q tile
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)2 * kB * (HD + kPad) +
                          (size_t)2 * kWalkTile<HD> +
                          (size_t)2 * kB * (kB + kPad) + 2 * kB);
}

// acc (this warp's 16 x N/2 slice of a 64 x N product, in the m16n8k16
// accumulator layout: acc[j] holds rows g, g + 8 and columns 2t, 2t + 1 of
// the warp's j-th 8-column tile) += A · B over KD, operands in shared or
// device memory: A(r, k) = a[r·lda + k], or a[k·lda + r] when AT; B(k, n) =
// b[n·ldb + k] when BN (stored n-major), else b[k·ldb + n].
template <int N, int KD, bool AT, bool BN>
__device__ __forceinline__ void warp_mm(float (&acc)[N / 16][4],
                                        const float* a, int lda,
                                        const float* b, int ldb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = (warp & 3) * 16 + (lane >> 2);
  const int c0 = (warp >> 2) * (N / 2) + 2 * (lane & 3);
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    const float x0 = AT ? a[k * lda + r] : a[r * lda + k];
    const float x1 = AT ? a[k * lda + r + 8] : a[(r + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      const int n = c0 + j * 8;
      const float y0 = BN ? b[n * ldb + k] : b[k * ldb + n];
      const float y1 = BN ? b[(n + 1) * ldb + k] : b[k * ldb + n + 1];
      acc[j][0] = fmaf(x0, y0, acc[j][0]);
      acc[j][1] = fmaf(x0, y1, acc[j][1]);
      acc[j][2] = fmaf(x1, y0, acc[j][2]);
      acc[j][3] = fmaf(x1, y1, acc[j][3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// 64 rows of HD from a row-major (., HD) tensor into a padded tile
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src) {
  constexpr int CH = HD / 4, LD = HD + kPad;
  for (int c = threadIdx.x; c < kB * CH; c += kThreads) {
    const int r = c / CH, d = (c % CH) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + d) =
        *reinterpret_cast<const float4*>(src + (size_t)r * HD + d);
  }
}

__device__ __forceinline__ bool live(int q_lo, int k_lo, int causal,
                                     int window) {
  if (causal && k_lo > q_lo + kB - 1) return false;
  if (window && q_lo - (k_lo + kB - 1) >= window) return false;
  return true;
}

// P = exp(S·scale − lse) of one score, 0 where masked: the mask selects
// expf's argument (expf(−inf) is +0 exactly), so it costs no branch
__device__ __forceinline__ float prob(float s, float lse, float scale,
                                      bool ok) {
  const float x = __fsub_rn(__fmul_rn(s, scale), lse);
  return expf(ok ? x : -INFINITY);
}

__device__ __forceinline__ bool unmasked(int qp, int kp, int causal,
                                         int window) {
  bool ok = true;
  if (causal) ok = qp >= kp;
  if (window) ok = ok && (qp - kp) < window;
  return ok;
}

// P = exp(S·scale − lse) (0 where masked) and dS = P∘(dP − D) for the
// tile pair (q_lo, k_lo), in place of s and dp; P and dS stored in ps
// (when not null) and dss, [64][64 + pad]
__device__ __forceinline__ void softmax_grad(float (&s)[4][4],
                                             float (&dp)[4][4], float* ps,
                                             float* dss, const float* ls,
                                             const float* dl, int q_lo,
                                             int k_lo, int causal,
                                             int window, float scale) {
  constexpr int LP = kB + kPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = (warp & 3) * 16 + (lane >> 2);
  const int c0 = (warp >> 2) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + (e >> 1) * 8, col = c0 + j * 8 + (e & 1);
      const float p = prob(s[j][e], ls[row], scale,
                           unmasked(q_lo + row, k_lo + col, causal, window));
      const float ds = __fmul_rn(p, __fsub_rn(dp[j][e], dl[row]));
      if (ps != nullptr) ps[row * LP + col] = p;
      dss[row * LP + col] = ds;
    }
}

// this warp's slice of a 64 x N float32 result (times ``mul``) into rows
// [0, 64) and columns [0, N) of a row-major (., HD) output
template <int N, int HD>
__device__ __forceinline__ void store(float* out, const float (&acc)[N / 16][4],
                                      float mul) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = (warp & 3) * 16 + (lane >> 2);
  const int c0 = (warp >> 2) * (N / 2) + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(size_t)(r + (e >> 1) * 8) * HD + c0 + j * 8 + (e & 1)] =
          __fmul_rn(acc[j][e], mul);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fab_dot_kernel(const T* __restrict__ O, const T* __restrict__ dO,
        float* __restrict__ D, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < HD; d += 32)
    s = fmaf(rt::to_f(O[(size_t)row * HD + d]),
             rt::to_f(dO[(size_t)row * HD + d]), s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if (lane == 0) D[row] = s;
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

#define FAB_ARGS                                                          \
  const float *__restrict__ Q, const float *__restrict__ K,               \
      const float *__restrict__ V, const float *__restrict__ dO,          \
      const float *__restrict__ LSE, const float *__restrict__ D

// Block b: column part b % kParts of kv tile (b / kParts) / nbh
// (ascending: the longest causal q ranges first) of head (b / kParts) %
// nbh.
template <int HD>
__global__ void __launch_bounds__(kThreads)
fab_kv_kernel(FAB_ARGS, float* __restrict__ dK, float* __restrict__ dV,
              int nbh, int sq, int skv, int causal, int window, float scale) {
  constexpr int LD = HD + kPad, LP = kB + kPad;
  constexpr int HP = HD / kParts<HD>;            // dK / dV columns summed
  constexpr bool kInPlace = kWalkInPlace<HD>;
  constexpr int LW = kInPlace ? HD : LD;         // the walked rows' stride
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kB * LD;
  float* qs = vs + kB * LD;
  float* dos = qs + kWalkTile<HD>;
  float* ps = dos + kWalkTile<HD>;
  float* dss = ps + kB * LP;
  float* ls = dss + kB * LP;
  float* dl = ls + kB;

  const int part = blockIdx.x % kParts<HD>, b = blockIdx.x / kParts<HD>;
  const int bh = b % nbh, k_lo = (b / nbh) * kB;
  const int offset = skv - sq;
  load_tile<HD>(ks, K + ((size_t)bh * skv + k_lo) * HD);
  load_tile<HD>(vs, V + ((size_t)bh * skv + k_lo) * HD);
  float dk[HP / 16][4], dv[HP / 16][4];
  zero(dk);
  zero(dv);
  for (int qi = 0; qi < sq / kB; ++qi) {
    const int q_lo = qi * kB + offset;
    if (!live(q_lo, k_lo, causal, window)) continue;
    __syncthreads();               // the last tile's readers are done
    const size_t row0 = (size_t)bh * sq + qi * kB;
    const float* qt = qs;
    const float* dot = dos;
    if constexpr (kInPlace) {
      qt = Q + row0 * HD;
      dot = dO + row0 * HD;
    } else {
      load_tile<HD>(qs, Q + row0 * HD);
      load_tile<HD>(dos, dO + row0 * HD);
    }
    if (threadIdx.x < kB) {
      ls[threadIdx.x] = LSE[row0 + threadIdx.x];
      dl[threadIdx.x] = D[row0 + threadIdx.x];
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    warp_mm<kB, HD, false, true>(s, qt, LW, ks, LD);     // Q·Kᵀ
    warp_mm<kB, HD, false, true>(dp, dot, LW, vs, LD);   // dO·Vᵀ
    softmax_grad(s, dp, ps, dss, ls, dl, q_lo, k_lo, causal, window, scale);
    __syncthreads();
    warp_mm<HP, kB, true, false>(dv, ps, LP, dot + part * HP, LW);  // Pᵀ·dO
    warp_mm<HP, kB, true, false>(dk, dss, LP, qt + part * HP, LW);  // dSᵀ·Q
  }
  const size_t out0 = ((size_t)bh * skv + k_lo) * HD + part * HP;
  store<HP, HD>(dK + out0, dk, scale);
  store<HP, HD>(dV + out0, dv, 1.f);
}

// Block b: q tile nq − 1 − b / nbh (the longest causal kv ranges first) of
// head b % nbh.
template <int HD>
__global__ void __launch_bounds__(kThreads)
fab_q_kernel(FAB_ARGS, float* __restrict__ dQ, int nbh, int sq, int skv,
             int causal, int window, float scale) {
  constexpr int LD = HD + kPad, LP = kB + kPad;
  constexpr bool kInPlace = kWalkInPlace<HD>;
  constexpr int LW = kInPlace ? HD : LD;         // the walked rows' stride
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kWalkTile<HD>;
  float* qs = vs + kWalkTile<HD>;
  float* dos = qs + kB * LD;
  float* dss = dos + kB * LD + kB * LP;
  float* ls = dss + kB * LP;
  float* dl = ls + kB;

  const int nq = sq / kB;
  const int bh = blockIdx.x % nbh, qi = nq - 1 - blockIdx.x / nbh;
  const int q_lo = qi * kB + (skv - sq);
  const size_t row0 = (size_t)bh * sq + qi * kB;
  load_tile<HD>(qs, Q + row0 * HD);
  load_tile<HD>(dos, dO + row0 * HD);
  if (threadIdx.x < kB) {
    ls[threadIdx.x] = LSE[row0 + threadIdx.x];
    dl[threadIdx.x] = D[row0 + threadIdx.x];
  }
  float dq[HD / 16][4];
  zero(dq);
  for (int ki = 0; ki < skv / kB; ++ki) {
    const int k_lo = ki * kB;
    if (!live(q_lo, k_lo, causal, window)) continue;
    __syncthreads();               // the last tile's readers are done
    const float* kt = ks;
    const float* vt = vs;
    if constexpr (kInPlace) {
      kt = K + ((size_t)bh * skv + k_lo) * HD;
      vt = V + ((size_t)bh * skv + k_lo) * HD;
    } else {
      load_tile<HD>(ks, K + ((size_t)bh * skv + k_lo) * HD);
      load_tile<HD>(vs, V + ((size_t)bh * skv + k_lo) * HD);
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    warp_mm<kB, HD, false, true>(s, qs, LD, kt, LW);     // Q·Kᵀ
    warp_mm<kB, HD, false, true>(dp, dos, LD, vt, LW);   // dO·Vᵀ
    softmax_grad(s, dp, nullptr, dss, ls, dl, q_lo, k_lo, causal, window,
                 scale);
    __syncthreads();
    warp_mm<HD, kB, false, false>(dq, dss, LP, kt, LW);  // dS·K
  }
  store<HD, HD>(dQ + row0 * HD, dq, scale);
}
#undef FAB_ARGS

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA rings, P and dS in registers
// ---------------------------------------------------------------------------

constexpr int kPanelBytes = kB * 128; // a 64-row x 64-column bf16 panel
constexpr int kProducerRegs = 24;     // the producer warpgroup's registers

// A pass's block (kKV: fab_kv, else fab_q): kConsumers warpgroups of 64
// rows and a producer warpgroup (the last), the consumers' registers after
// setmaxnreg (the SM's 65,536 less the producer's 128 x 24, shared), and
// its shared memory: the tiles staged once (two tensors — K and V, or Q and
// dO — of kOwnRows rows), a ring of kSlots tiles (64 x HD as HD / 64
// swizzled panels) with, in fab_kv, each slot's 64 floats of lse or D,
// then the full / empty barriers and the staged tiles' barrier.  fab_q at
// hd 64 runs three consumer warpgroups (its dQ, S, dP and dS take ~140 of
// the 160 registers each then gets); every other pass two, with 240.
template <int HD, bool kKV>
struct Plan {
  static constexpr int kConsumers = !kKV && HD == 64 ? 3 : 2;
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static constexpr int kTile = HD / 64 * kPanelBytes;
  static constexpr bool kSplit = kKV && HD > 128;   // dV / dK warpgroups
  static constexpr int kOwnRows = kSplit ? kB : kConsumers * kB;
  static constexpr int kOwn = 2 * (kOwnRows / kB) * kTile;
  static constexpr int kVec = kKV ? kB * (int)sizeof(float) : 0;
  static constexpr int kFree = rt::kSmemLimit - 1024 - kOwn - 512;
  static constexpr int kSlots =
      kFree / (kTile + kVec) < 8 ? kFree / (kTile + kVec) : 8;
  static constexpr size_t kSmem = 1024 + (size_t)kOwn +
                                  (size_t)kSlots * (kTile + kVec) +
                                  (2 * kSlots + 1) * sizeof(uint64_t);
};

// k-step kk (16 columns) of a 64-row tile read k-major
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return mma::sw128_desc(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 16,
                         1024);
}

// rows [16kk, 16kk + 16) x columns [64pn, 64pn + 64) of a 64-row tile read
// n-major
__device__ __forceinline__ uint64_t nmajor(uint32_t tile, int kk, int pn) {
  return mma::sw128_desc(tile + pn * kPanelBytes + kk * 16 * 128,
                         kPanelBytes, 1024);
}

// acc (64 x 64, this warpgroup) = A · Bᵀ over HD: A, B 64-row tiles, both
// read k-major; issued and committed as one group, not waited for (the
// first k-step overwrites acc, so it needs no zeroing)
template <int HD>
__device__ __forceinline__ void issue_scores(float (&acc)[32], uint32_t a,
                                             uint32_t b) {
  mma::pin(acc);
  mma::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma::wgmma64_ss<0>(acc, kmajor(a, kk), kmajor(b, kk), kk > 0);
  mma::wgmma_commit();
}

// x (a 64 x 64 accumulator) rounded to bf16, nearest even, as wgmma's
// register A operand: f[kk] holds columns [16kk, 16kk + 16)
__device__ __forceinline__ void pack(uint32_t (&f)[4][4],
                                     const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[kk][i] = mma::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// acc (64 x HD, panels of 64 columns) += f (64 x 64, registers) · B (a
// 64-row tile, read n-major), for the output ``a`` and, when kTwo, ``b``
template <int NP, bool kTwo>
__device__ __forceinline__ void issue_rs(float (&a)[NP][32],
                                         const uint32_t (&fa)[4][4],
                                         uint32_t ta, float (&b)[NP][32],
                                         const uint32_t (&fb)[4][4],
                                         uint32_t tb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      mma::wgmma64<1>(a[pn], fa[kk], nmajor(ta, kk, pn));
      if constexpr (kTwo) mma::wgmma64<1>(b[pn], fb[kk], nmajor(tb, kk, pn));
    }
}

// this warp's rows of a 64 x HD float32 accumulator (times ``mul``) at
// ``out`` (the tile's first row, row stride HD)
template <int HD>
__device__ __forceinline__ void store_acc(float* out,
                                          const float (&acc)[HD / 64][32],
                                          float mul) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int pn = 0; pn < HD / 64; ++pn)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            out + (size_t)(warp * 16 + g + 8 * hh) * HD + pn * 64 + 8 * j +
            2 * t) = make_float2(__fmul_rn(acc[pn][4 * j + 2 * hh], mul),
                                 __fmul_rn(acc[pn][4 * j + 2 * hh + 1], mul));
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][32]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
}

// What a block of either pass shares with its consumers.
struct Ring {
  unsigned char* tiles;   // slot s at tiles + s · kTile
  const float* vec;       // fab_kv: slot s's lse or D at vec + 64 s
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own;          // the staged tiles have landed
};

__device__ __forceinline__ Ring carve(unsigned char* smem_raw, int own_bytes,
                                      int slots, int tile, int vec) {
  // swizzled panels need 1024-byte alignment
  unsigned char* smem =
      smem_raw + ((1024 - (mma::smem_u32(smem_raw) & 1023)) & 1023);
  Ring r;
  r.tiles = smem + own_bytes;
  r.vec = reinterpret_cast<const float*>(r.tiles + slots * tile);
  r.full = reinterpret_cast<uint64_t*>(r.tiles + slots * (tile + vec));
  r.empty = r.full + slots;
  r.own = r.empty + slots;
  return r;
}

// Warp index, uniform in the compiler's eyes (read from lane 0): branches on
// it are not divergent, so ptxas keeps the wgmma pipelines it guards.
__device__ __forceinline__ int uniform_warp() {
  return __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
}

// Wait for the barrier's phase of parity ``parity``: the spin loop inside
// the asm, so the compiler sees no divergent branch.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra.uni WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Arrive on the barrier from lane 0 of the warp (predicated, no branch).
__device__ __forceinline__ void arrive_lane0(uint32_t bar) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(threadIdx.x & 31)
      : "memory");
}

// A walked tile and its partner (Q with dO, or K with V) sit in the slot
// pair at ring position ``at``: slots at % SL and (at + 1) % SL.
template <int SL>
__device__ __forceinline__ void wait_pair(const Ring& r, int at) {
  wait_phase(mma::smem_u32(&r.full[at % SL]), (at / SL) & 1);
  wait_phase(mma::smem_u32(&r.full[(at + 1) % SL]), ((at + 1) / SL) & 1);
}

// This warp is done with the pair (each consumer warp arrives once).
template <int SL>
__device__ __forceinline__ void release_pair(const Ring& r, int at) {
  __syncwarp();
  arrive_lane0(mma::smem_u32(&r.empty[at % SL]));
  arrive_lane0(mma::smem_u32(&r.empty[(at + 1) % SL]));
}

// A consumer warpgroup's walk over its live pairs: per pair the scores S
// (and, kDP, dP) are issued and waited for, ``prob`` turns S into P,
// ``dgrad`` forms dS and packs the operands and ``products`` issues the
// gradient products.  ``next(lo)`` returns the ring position of the next
// pair this warpgroup computes on (the walked tile's first position in
// lo), or -1, passing the pairs that only the block's other warpgroup
// needs.  With kOverlap a pair's products run on while the next pair's
// scores are issued, and the pair is released once they are done (the
// wait for the next S retires them: groups complete in issue order); else
// they are waited for at once.  kOverlap holds three pairs of the ring,
// and registers for the products' operands beside the next scores (ptxas
// serialises the products otherwise: C7512).
template <int SL, bool kDP, bool kOverlap, class Next, class Scores,
          class DScores, class Prob, class DGrad, class Products,
          class Settle>
__device__ __forceinline__ void walk(const Ring& r, Next&& next,
                                     Scores&& scores, DScores&& dscores,
                                     Prob&& prob, DGrad&& dgrad,
                                     Products&& products, Settle&& settle) {
  static_assert(!kOverlap || SL >= 6, "the ring must hold three pairs");
  float sc[32];
  int lo;
  // issue the pair's scores and wait for S (and what was issued before it)
  auto head = [&](int at) {
    wait_pair<SL>(r, at);
    scores(sc, at, lo);
    if constexpr (kDP) dscores(at, lo);
    mma::wgmma_wait<kDP ? 1 : 0>();
  };
  // P, dS, the products issued
  auto tail = [&](int at) {
    mma::pin(sc);
    prob(sc, at, lo);
    if constexpr (kDP) mma::wgmma_wait<0>();
    dgrad(sc, at, lo);
    products(at);
  };
  if constexpr (!kOverlap) {
    for (int at = next(lo); at >= 0; at = next(lo)) {
      head(at);
      tail(at);
      mma::wgmma_wait<0>();
      settle();
      release_pair<SL>(r, at);
    }
  } else {
    // the first pair peeled, so every iteration of the loop starts with
    // one group (the last products) in flight: ptxas serialises the
    // products of a loop whose first iteration differs (C7514)
    int prev = next(lo);
    if (prev < 0) return;
    head(prev);
    tail(prev);
    for (int at = next(lo); at >= 0; at = next(lo)) {
      head(at);                     // retires products(prev) too
      settle();
      release_pair<SL>(r, prev);
      tail(at);
      prev = at;
    }
    mma::wgmma_wait<0>();
    settle();
    release_pair<SL>(r, prev);
  }
}

// Pᵀ = exp(Sᵀ·scale − lse) in place of sc for the kv pass: rows kv (this
// thread's kw + g, + 8), columns q (q_lo + 8j + 2t, + 1), lse per column;
// the mask is computed only on a warp's diagonal or window-edge tiles
template <bool kMask>
__device__ __forceinline__ void kv_prob(float (&sc)[32], const float* ls,
                                        int q_lo, int kw, int causal,
                                        int window, float scale) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[4 * j + e] = prob(
          sc[4 * j + e], (e & 1) ? l2.y : l2.x, scale,
          !kMask || unmasked(q_lo + 8 * j + 2 * t + (e & 1),
                             kw + g + 8 * (e >> 1), causal, window));
  }
}

// dSᵀ = Pᵀ∘(dPᵀ − D) in place of dp for the kv pass, D per column
__device__ __forceinline__ void kv_dgrad(float (&dp)[32],
                                         const float (&sc)[32],
                                         const float* dl) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * j + e] = __fmul_rn(
          sc[4 * j + e], __fsub_rn(dp[4 * j + e], (e & 1) ? d2.y : d2.x));
  }
}

// One consumer warpgroup of fab_kv: the kv tile at k_lo (its K and V at
// shared addresses kt, vt), summing dV (kDV) and / or dK (kDK) over the q
// tiles live for it, in ascending order, in the ring's sequence: a slot
// pair (Q with lse, dO with D) for every q tile live for k_first or
// k_last, the block's kv tiles.  Writes its sums at dK / dV (the tile's
// first row).
template <int HD, bool kDV, bool kDK>
__device__ __forceinline__ void kv_consumer(const Ring& r, uint32_t kt,
                                            uint32_t vt, int k_lo,
                                            int k_first, int k_last, int nq,
                                            int offset, int causal,
                                            int window, float scale,
                                            float* dK, float* dV) {
  using P = Plan<HD, true>;
  constexpr int NP = HD / 64, SL = P::kSlots;
  const int kw = k_lo + (uniform_warp() & 3) * 16;   // warp's first row
  float dv[NP][32], dk[NP][32], dp[32];
  uint32_t pf[4][4], sf[4][4];
  if constexpr (kDV) zero_acc(dv);
  if constexpr (kDK) zero_acc(dk);
  wait_phase(mma::smem_u32(r.own), 0);
  const uint32_t ring = mma::smem_u32(r.tiles);
  auto slot = [&](int at, int x) {
    return ring + (at + x) % SL * P::kTile;
  };
  int n = 0, qi = 0;
  auto next = [&](int& q_lo) -> int {
    for (; qi < nq; ++qi) {
      q_lo = qi * kB + offset;
      if (!live(q_lo, k_first, causal, window) &&
          !live(q_lo, k_last, causal, window))
        continue;
      const int at = n;
      n += 2;
      if (live(q_lo, k_lo, causal, window)) {
        ++qi;
        return at;
      }
      wait_pair<SL>(r, at);
      release_pair<SL>(r, at);
    }
    return -1;
  };
  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ (rows: kv; columns: q)
  auto scores = [&](float (&sc)[32], int at, int) {
    issue_scores<HD>(sc, kt, slot(at, 0));
  };
  auto dscores = [&](int at, int) {
    if constexpr (kDK) issue_scores<HD>(dp, vt, slot(at, 1));
  };
  auto prob_ = [&](float (&sc)[32], int at, int q_lo) {
    const float* ls = r.vec + at % SL * kB;
    if ((causal && kw + 15 > q_lo) || (window && q_lo + kB - 1 - kw >= window))
      kv_prob<true>(sc, ls, q_lo, kw, causal, window, scale);
    else
      kv_prob<false>(sc, ls, q_lo, kw, causal, window, scale);
  };
  auto dgrad = [&](float (&sc)[32], int at, int) {
    if constexpr (kDK) {
      mma::pin(dp);
      kv_dgrad(dp, sc, r.vec + (at + 1) % SL * kB);
      pack(sf, dp);
    }
    if constexpr (kDV) pack(pf, sc);
  };
  // dV += Pᵀ·dO, dK += dSᵀ·Q: A from the registers just packed, B the
  // slots' dO and Q read n-major
  auto products = [&](int at) {
    if constexpr (kDV) { mma::pin(dv); mma::pin(pf); }
    if constexpr (kDK) { mma::pin(dk); mma::pin(sf); }
    mma::wgmma_fence();
    if constexpr (kDV && kDK)
      issue_rs<NP, true>(dv, pf, slot(at, 1), dk, sf, slot(at, 0));
    else if constexpr (kDV)
      issue_rs<NP, false>(dv, pf, slot(at, 1), dv, pf, 0);
    else
      issue_rs<NP, false>(dk, sf, slot(at, 0), dk, sf, 0);
    mma::wgmma_commit();
  };
  auto settle = [&] {
    if constexpr (kDV) { mma::pin(dv); mma::pin(pf); }
    if constexpr (kDK) { mma::pin(dk); mma::pin(sf); }
  };
  // the products overlap the next scores where registers allow: hd 64
  walk<SL, kDK, kDV && kDK && HD == 64>(r, next, scores, dscores, prob_,
                                        dgrad, products, settle);
  settle();
  if constexpr (kDV) store_acc<HD>(dV, dv, 1.f);
  if constexpr (kDK) store_acc<HD>(dK, dk, scale);
}

// Block b: kv tiles c·T .. c·T + T − 1 (T = kOwnRows / 64; c = b / nbh
// ascending: the longest causal q ranges first) of head b % nbh.
template <int HD>
__global__ void __launch_bounds__(Plan<HD, true>::kThreads, 1)
fab_kv_kernel_mma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ LSE, const float* __restrict__ D,
                  float* __restrict__ dK, float* __restrict__ dV, int nbh,
                  int sq, int skv, int causal, int window, float scale) {
  using P = Plan<HD, true>;
  constexpr int NP = HD / 64, SL = P::kSlots, T = P::kOwnRows / kB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Ring r = carve(smem_raw, P::kOwn, SL, P::kTile, P::kVec);
  unsigned char* ks = r.tiles - P::kOwn;     // T tiles of K, then of V
  unsigned char* vs = ks + T * P::kTile;
  const int warp = uniform_warp();
  const int bh = blockIdx.x % nbh, kt0 = (blockIdx.x / nbh) * T;
  const int ntiles = min(T, skv / kB - kt0);
  const int offset = skv - sq, nq = sq / kB;
  const int k_first = kt0 * kB, k_last = (kt0 + ntiles - 1) * kB;
  // consumer warpgroups: pair mode one per kv tile; split both on one
  const int consumers = P::kSplit ? 2 : ntiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SL; ++s) {
      mma::mbar_init(mma::smem_u32(&r.full[s]), 1);
      mma::mbar_init(mma::smem_u32(&r.empty[s]), 4 * consumers);
    }
    mma::mbar_init(mma::smem_u32(r.own), 1);
    mma::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * P::kConsumers) {
    // producer: K and V of the block's tiles once, then for every q tile
    // live for one of them, in order, Q with its lse and dO with its D
    mma::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 128 * P::kConsumers) return;
    const uint32_t ob = mma::smem_u32(r.own);
    osm::mbar_expect_tx(ob, 2 * ntiles * P::kTile);
    for (int h = 0; h < ntiles; ++h)
      for (int p = 0; p < NP; ++p) {
        const int row = bh * skv + (kt0 + h) * kB;
        const int off = h * P::kTile + p * kPanelBytes;
        osm::tma_load(mma::smem_u32(ks + off), &tk, ob, 64 * p, row);
        osm::tma_load(mma::smem_u32(vs + off), &tv, ob, 64 * p, row);
      }
    int n = 0;
    for (int qi = 0; qi < nq; ++qi) {
      const int q_lo = qi * kB + offset;
      if (!live(q_lo, k_first, causal, window) &&
          !live(q_lo, k_last, causal, window))
        continue;
      const int row = bh * sq + qi * kB;
      for (int x = 0; x < 2; ++x, ++n) {
        const int s = n % SL;
        mma::mbar_wait(mma::smem_u32(&r.empty[s]), ((n / SL) & 1) ^ 1);
        const uint32_t bar = mma::smem_u32(&r.full[s]);
        const uint32_t dst = mma::smem_u32(r.tiles + s * P::kTile);
        osm::mbar_expect_tx(bar, P::kTile + P::kVec);
        for (int p = 0; p < NP; ++p)
          osm::tma_load(dst + p * kPanelBytes, x ? &tdo : &tq, bar, 64 * p,
                        row);
        osm::bulk_load(mma::smem_u32(r.vec + s * kB), (x ? D : LSE) + row,
                       P::kVec, bar);
      }
    }
    return;
  }
  const int h = warp >> 2;
  if (h >= consumers) return;
  mma::setmaxnreg_inc<P::kConsumerRegs>();
  const int tile = P::kSplit ? 0 : h;
  const int k_lo = (kt0 + tile) * kB;
  const uint32_t kt = mma::smem_u32(ks + tile * P::kTile);
  const uint32_t vt = mma::smem_u32(vs + tile * P::kTile);
  float* dk = dK + ((size_t)bh * skv + k_lo) * HD;
  float* dv = dV + ((size_t)bh * skv + k_lo) * HD;
  if constexpr (P::kSplit) {
    if (h == 0)
      kv_consumer<HD, true, false>(r, kt, vt, k_lo, k_first, k_last, nq,
                                   offset, causal, window, scale, dk, dv);
    else
      kv_consumer<HD, false, true>(r, kt, vt, k_lo, k_first, k_last, nq,
                                   offset, causal, window, scale, dk, dv);
  } else {
    kv_consumer<HD, true, true>(r, kt, vt, k_lo, k_first, k_last, nq,
                                offset, causal, window, scale, dk, dv);
  }
}

// Block b: q rows [R·qt, R·qt + R) (R = kOwnRows, 64 per consumer
// warpgroup) of head b % nbh with qt = nq − 1 − b / nbh (the longest causal
// kv ranges first); warpgroup h the q tile (R / 64)·qt + h (a last, shorter
// block runs only the warpgroups it has tiles for).
template <int HD>
__global__ void __launch_bounds__(Plan<HD, false>::kThreads, 1)
fab_q_kernel_mma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ LSE, const float* __restrict__ D,
                 float* __restrict__ dQ, int nbh, int sq, int skv,
                 int causal, int window, float scale) {
  using P = Plan<HD, false>;
  constexpr int NP = HD / 64, SL = P::kSlots;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Ring r = carve(smem_raw, P::kOwn, SL, P::kTile, 0);
  constexpr int NC = P::kConsumers;
  unsigned char* qs = r.tiles - P::kOwn;     // NC tiles of Q, then of dO
  unsigned char* dos = qs + NC * P::kTile;
  const int warp = uniform_warp(), lane = threadIdx.x & 31;
  const int nq = (sq + NC * kB - 1) / (NC * kB);
  const int bh = blockIdx.x % nbh;
  const int row0 = (nq - 1 - blockIdx.x / nbh) * NC * kB;
  const int parts = min(NC * kB, sq - row0) / kB;   // q tiles of the block
  const int offset = skv - sq, nkv = skv / kB;
  const int q_first = row0 + offset;
  // kv tile at k_lo live for one of the block's q tiles
  auto any_live = [&](int k_lo) {
    for (int h = 0; h < parts; ++h)
      if (live(q_first + h * kB, k_lo, causal, window)) return true;
    return false;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < SL; ++s) {
      mma::mbar_init(mma::smem_u32(&r.full[s]), 1);
      mma::mbar_init(mma::smem_u32(&r.empty[s]), 4 * parts);
    }
    mma::mbar_init(mma::smem_u32(r.own), 1);
    mma::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NC) {
    // producer: Q and dO of the block's rows once, then for every kv tile
    // live for one of its q tiles, in order, K and V
    mma::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 128 * NC) return;
    const uint32_t ob = mma::smem_u32(r.own);
    osm::mbar_expect_tx(ob, 2 * parts * P::kTile);
    for (int h = 0; h < parts; ++h)
      for (int p = 0; p < NP; ++p) {
        const int row = bh * sq + row0 + h * kB;
        const int off = h * P::kTile + p * kPanelBytes;
        osm::tma_load(mma::smem_u32(qs + off), &tq, ob, 64 * p, row);
        osm::tma_load(mma::smem_u32(dos + off), &tdo, ob, 64 * p, row);
      }
    int n = 0;
    for (int ki = 0; ki < nkv; ++ki) {
      const int k_lo = ki * kB;
      if (!any_live(k_lo)) continue;
      for (int x = 0; x < 2; ++x, ++n) {
        const int s = n % SL;
        mma::mbar_wait(mma::smem_u32(&r.empty[s]), ((n / SL) & 1) ^ 1);
        const uint32_t bar = mma::smem_u32(&r.full[s]);
        const uint32_t dst = mma::smem_u32(r.tiles + s * P::kTile);
        osm::mbar_expect_tx(bar, P::kTile);
        for (int p = 0; p < NP; ++p)
          osm::tma_load(dst + p * kPanelBytes, x ? &tv : &tk, bar, 64 * p,
                        bh * skv + k_lo);
      }
    }
    return;
  }
  const int h = warp >> 2;
  if (h >= parts) return;
  mma::setmaxnreg_inc<P::kConsumerRegs>();
  // consumer warpgroup: q rows [q_lo, q_lo + 64); thread (g, t) of warp w
  // holds rows qw + g (+ 8) and kv columns 8j + 2t (+ 1)
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  const int q_lo = q_first + h * kB, qw = q_lo + w * 16;
  const size_t grow = (size_t)bh * sq + row0 + h * kB + w * 16 + g;
  const float lse[2] = {LSE[grow], LSE[grow + 8]};
  const float dd[2] = {D[grow], D[grow + 8]};
  const uint32_t qa = mma::smem_u32(qs + h * P::kTile);
  const uint32_t da = mma::smem_u32(dos + h * P::kTile);
  const uint32_t ring = mma::smem_u32(r.tiles);
  auto slot = [&](int at, int x) {
    return ring + (at + x) % SL * P::kTile;
  };
  float dq[NP][32], dp[32];
  uint32_t sf[4][4];
  zero_acc(dq);
  wait_phase(mma::smem_u32(r.own), 0);
  int n = 0, ki = 0;
  auto next = [&](int& k_lo) -> int {
    for (; ki < nkv; ++ki) {
      k_lo = ki * kB;
      if (!any_live(k_lo)) continue;
      const int at = n;
      n += 2;
      if (live(q_lo, k_lo, causal, window)) {
        ++ki;
        return at;
      }
      wait_pair<SL>(r, at);
      release_pair<SL>(r, at);
    }
    return -1;
  };
  // S = Q·Kᵀ, dP = dO·Vᵀ
  auto scores = [&](float (&sc)[32], int at, int) {
    issue_scores<HD>(sc, qa, slot(at, 0));
  };
  auto dscores = [&](int at, int) { issue_scores<HD>(dp, da, slot(at, 1)); };
  auto prob_ = [&](float (&sc)[32], int, int k_lo) {
    auto row = [&](auto mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = prob(
              sc[4 * j + e], lse[e >> 1], scale,
              !mask.value || unmasked(qw + g + 8 * (e >> 1),
                                      k_lo + 8 * j + 2 * t + (e & 1),
                                      causal, window));
    };
    if ((causal && k_lo + kB - 1 > qw) || (window && qw + 15 - k_lo >= window))
      row(std::true_type{});
    else
      row(std::false_type{});
  };
  auto dgrad = [&](float (&sc)[32], int, int) {
    mma::pin(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = __fmul_rn(sc[i], __fsub_rn(dp[i], dd[(i >> 1) & 1]));
    pack(sf, dp);
  };
  // dQ += dS·K: A the dS just packed, B the slot's K read n-major
  auto products = [&](int at) {
    mma::pin(dq);
    mma::pin(sf);
    mma::wgmma_fence();
    issue_rs<NP, false>(dq, sf, slot(at, 0), dq, sf, 0);
    mma::wgmma_commit();
  };
  auto settle = [&] {
    mma::pin(dq);
    mma::pin(sf);
  };
  // the products overlap the next scores where registers allow: hd <= 128
  walk<SL, true, HD <= 128>(r, next, scores, dscores, prob_, dgrad,
                            products, settle);
  settle();
  store_acc<HD>(dQ + ((size_t)bh * sq + row0 + h * kB) * HD, dq, scale);
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
int launch_f32(const float* Q, const float* K, const float* V,
               const float* O, const float* dO, const float* lse,
               float* dsum, float* dq, float* dk, float* dv, int bh, int sq,
               int skv, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= (size_t)rt::kSmemLimit, "tiles too large");
  const int rows = bh * sq;
  fab_dot_kernel<float, HD><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                               kThreads, 0, stream>>>(O, dO, dsum, rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if ((err = set_smem(fab_kv_kernel<HD>, smem))) return err;
  fab_kv_kernel<HD><<<(unsigned)bh * (skv / kB) * kParts<HD>, kThreads, smem,
                      stream>>>(Q, K, V, dO, lse, dsum, dk, dv, bh, sq, skv,
                                causal, window, scale);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(fab_q_kernel<HD>, smem))) return err;
  fab_q_kernel<HD><<<(unsigned)bh * (sq / kB), kThreads, smem, stream>>>(
      Q, K, V, dO, lse, dsum, dq, bh, sq, skv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const bf16* Q, const bf16* K, const bf16* V, const bf16* O,
               const bf16* dO, const float* lse, float* dsum, float* dq,
               float* dk, float* dv, int bh, int sq, int skv, int causal,
               int window, float scale, cudaStream_t stream) {
  using PK = Plan<HD, true>;
  using PQ = Plan<HD, false>;
  static_assert(PK::kSmem <= (size_t)rt::kSmemLimit &&
                    PQ::kSmem <= (size_t)rt::kSmemLimit && PK::kSlots >= 2 &&
                    PQ::kSlots >= 2,
                "tiles too large");
  // TMA and the bulk copies read 16-byte aligned rows
  if (!mma::aligned16(Q) || !mma::aligned16(K) || !mma::aligned16(V) ||
      !mma::aligned16(dO) || !mma::aligned16(lse) || !mma::aligned16(dsum))
    return (int)cudaErrorInvalidValue;
  const int rows = bh * sq;
  fab_dot_kernel<bf16, HD><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                              kThreads, 0, stream>>>(O, dO, dsum, rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  CUtensorMap tq{}, tk{}, tv{}, tdo{};
  if ((err = osm::make_tmap<bf16>(&tq, Q, HD, bh * sq, HD, kB)) ||
      (err = osm::make_tmap<bf16>(&tk, K, HD, bh * skv, HD, kB)) ||
      (err = osm::make_tmap<bf16>(&tv, V, HD, bh * skv, HD, kB)) ||
      (err = osm::make_tmap<bf16>(&tdo, dO, HD, bh * sq, HD, kB)))
    return err;
  if ((err = set_smem(fab_kv_kernel_mma<HD>, PK::kSmem))) return err;
  const int kv_blocks = (skv + PK::kOwnRows - 1) / PK::kOwnRows;
  fab_kv_kernel_mma<HD><<<(unsigned)bh * kv_blocks, PK::kThreads, PK::kSmem,
                          stream>>>(tq, tk, tv, tdo, lse, dsum, dk, dv, bh,
                                    sq, skv, causal, window, scale);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = set_smem(fab_q_kernel_mma<HD>, PQ::kSmem))) return err;
  const int q_blocks = (sq + PQ::kOwnRows - 1) / PQ::kOwnRows;
  fab_q_kernel_mma<HD><<<(unsigned)bh * q_blocks, PQ::kThreads, PQ::kSmem,
                         stream>>>(
      tq, tk, tv, tdo, lse, dsum, dq, bh, sq, skv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace fab

// q (bh, sq, hd), k / v (bh, skv, hd) and o (bh, sq, hd), contiguous, all of
// ``dtype`` (rt::Dtype: float32 or bfloat16); sq and skv multiples of 64,
// sq <= skv; hd 32, 64, 128 or 256.  ``lse`` (float32 (bh, sq)) receives
// each row's m + log(l) when it is not null; o's bits do not depend on it.
// Returns the cudaError_t of the launch.
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int sq, int skv, int hd,
                          int causal, int window, float scale, int dtype,
                          void* stream) {
  if (sq % fa::kBQ || skv % fa::kBKV || sq > skv || bh <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == rt::kF32)
    return fa::dispatch_hd<false>(q, k, v, o, l, bh, sq, skv, hd, causal,
                                  window, scale, s);
  if (dtype == rt::kBF16)
    return fa::dispatch_hd<true>(q, k, v, o, l, bh, sq, skv, hd, causal,
                                 window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The gradient of fa_forward: q, o, dout (bh, sq, hd), k, v (bh, skv, hd),
// contiguous, all of ``dtype`` (float32 or bfloat16), lse (bh, sq) float32
// from fa_forward; writes the float32 workspace dsum (bh, sq) = rowsum(dO∘O)
// and dq (bh, sq, hd), dk and dv (bh, skv, hd) in float32.  sq and skv
// multiples of 64, sq <= skv; hd 64, 128 or 256; bf16 operands, lse and
// dsum 16-byte aligned (TMA).  Three kernels on ``stream``; returns the
// first cudaError_t.
extern "C" int fa_backward(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* dsum, void* dq, void* dk, void* dv, int bh,
                           int sq, int skv, int hd, int causal, int window,
                           float scale, int dtype, void* stream) {
  if (sq % fab::kB || skv % fab::kB || sq > skv || bh <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  float* gq = static_cast<float*>(dq);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
#define FAB_CASE(HD)                                                        \
  case HD:                                                                  \
    if (dtype == rt::kF32)                                                  \
      return fab::launch_f32<HD>(                                           \
          static_cast<const float*>(q), static_cast<const float*>(k),       \
          static_cast<const float*>(v), static_cast<const float*>(o),       \
          static_cast<const float*>(dout), l, ds, gq, gk, gv, bh, sq, skv,  \
          causal, window, scale, s);                                        \
    if (dtype == rt::kBF16)                                                 \
      return fab::launch_mma<HD>(                                           \
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),         \
          static_cast<const bf16*>(v), static_cast<const bf16*>(o),         \
          static_cast<const bf16*>(dout), l, ds, gq, gk, gv, bh, sq, skv,   \
          causal, window, scale, s);                                        \
    break;
  using mma::bf16;
  switch (hd) {
    FAB_CASE(64)
    FAB_CASE(128)
    FAB_CASE(256)
    default:
      break;
  }
#undef FAB_CASE
  return (int)cudaErrorInvalidValue;
}
