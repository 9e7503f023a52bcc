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
//   fab_kv  : one CUDA block per (kv tile of 64, head) walks its live q
//             tiles in ascending order (the forward's liveness), recomputes
//             S = Q·Kᵀ and P = exp(S·scale − lse) (0 where masked), dP = dO·Vᵀ
//             and dS = P∘(dP − D), and sums dV += Pᵀ·dO and dK += dSᵀ·Q in
//             registers; dK is scaled once at the end;
//   fab_q   : one CUDA block per (q tile of 64, head) walks its live kv tiles
//             ascending, recomputes P and dS the same way, and sums
//             dQ += dS·K.
// Every output element has one owner that sums its terms in a fixed order,
// so two runs give the same bits.  The price is that S, P, dP and dS are
// computed twice (the first two passes' products S and dP again in the
// third): seven 64 x 64 x hd products per live tile pair where an
// atomics-based backward takes five.
//
// bf16: the products are mma.sync m16n8k16 (mma.cuh) on tiles staged in
// shared memory with padded rows (ldmatrix, transposed where an operand is
// read across its rows), float32 accumulators; P and dS are rounded to bf16
// (nearest even) before their products, as the plain version does
// (``ref.flash_attention_backward_plain``).  float32: the same loop with
// scalar FMAs in the same accumulator layout (no tensor cores, no TF32).
// A block has 8 warps: warp w owns rows 16·(w % 4) .. + 16 of a 64-row
// product and the column half w / 4.
//
// hd 256: a warp's 16 x 128 slices of both dK and dV (2 x 64 float32
// accumulators a thread) beside S, dP and the fragments would pass the 255
// registers a thread may hold, so ``fab_kv`` splits dK / dV into two
// column halves of 128, one CUDA block each: a block recomputes S and dP
// over all 256 columns and sums only its half, which makes its accumulators
// those of the hd-128 instance (two more 64 x 64 x 256 products per live
// pair).  ``fab_q`` keeps dQ whole (64 accumulators a thread, as
// ``fab_kv`` at hd 128).  bf16 stages the four 64 x 256 tiles in shared
// memory with the smaller heads' padding (154,112 bytes); float32's would
// take 301,568, so at hd 256 the float32 blocks stage only the tiles they
// own (k and v in ``fab_kv``, q and dO in ``fab_q``) and read the tiles
// they walk in place from device memory (168,448 bytes).  The order of
// every sum is that of the smaller heads; hd 64 and 128 compile to the
// code they had (one column part, every tile staged).
//
// What bounds it on the H100: at StableLM-1.6B's training cell (BH 64,
// S 4096, hd 64, causal) the seven products over the ~64·4096²/2 live pairs
// are 7·2·64·8.4e6·64 = 4.8e11 FLOPs, 0.49 ms at 989 TFLOP/s (the five that
// the gradient needs: 0.35 ms); the bytes (q, k, v, o, dO in, dQ, dK, dV
// out in float32, lse, D) ~0.23 GB, 0.07 ms: bound by operations.  At hd
// 256 the five products are 0.35 ms at Gemma-2B's cell (BH 16, S 4096,
// causal) and 0.52 ms at RecurrentGemma-9B's (BH 32, S 4096, window 2048),
// where the split dK / dV makes the kernels do nine.

namespace fab {

using mma::bf16;

constexpr int kB = 64;             // q and kv rows of a tile (the forward's)
constexpr int kThreads = 256;      // 8 warps

template <typename T>
constexpr int kPad = sizeof(T) == 2 ? 8 : 4;   // row padding, elements

// column parts of dK / dV, one CUDA block of ``fab_kv`` each
template <int HD>
constexpr int kParts = HD > 128 ? 2 : 1;

// float32 at hd 256: the walked tiles are read in place from device memory
template <typename T, int HD>
constexpr bool kWalkInPlace = sizeof(T) == 4 && HD > 128;

// elements of a staged walked tile (none when read in place)
template <typename T, int HD>
constexpr int kWalkTile = kWalkInPlace<T, HD> ? 0 : kB * (HD + kPad<T>);

// smem: the owned and the walked pairs of tiles [64][HD + pad] (fab_kv: k,
// v, then q, dO; fab_q: k, v, then q, dO, k and v being the walked ones),
// then P and dS [64][64 + pad] in T, then lse and D of the q tile (float)
template <typename T, int HD>
constexpr size_t smem_bytes() {
  return sizeof(T) * ((size_t)2 * kB * (HD + kPad<T>) +
                      (size_t)2 * kWalkTile<T, HD> +
                      (size_t)2 * kB * (kB + kPad<T>)) +
         2 * kB * sizeof(float);
}

// acc (this warp's 16 x N/2 slice of a 64 x N product, in the m16n8k16
// accumulator layout: acc[j] holds rows g, g + 8 and columns 2t, 2t + 1 of
// the warp's j-th 8-column tile) += A · B over KD, operands in shared
// memory: A(r, k) = a[r·lda + k], or a[k·lda + r] when AT; B(k, n) =
// b[n·ldb + k] when BN (stored n-major), else b[k·ldb + n].
template <int N, int KD, bool AT, bool BN>
__device__ __forceinline__ void warp_mm(float (&acc)[N / 16][4],
                                        const bf16* a, int lda,
                                        const bf16* b, int ldb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * (N / 2);
  const int mi = lane >> 3, li = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t af[4];
    if (!AT)
      mma::ldsm_x4(af, mma::smem_u32(a + (r0 + (lane & 15)) * lda + kk +
                                     (lane >> 4) * 8));
    else
      mma::ldsm_x4_t(af, mma::smem_u32(a + (kk + (mi >> 1) * 8 + li) * lda +
                                       r0 + (mi & 1) * 8));
#pragma unroll
    for (int j = 0; j < N / 16; j += 2) {
      const int n0 = c0 + j * 8;
      uint32_t bf[4];
      if (BN)
        mma::ldsm_x4(bf, mma::smem_u32(b + (n0 + (mi >> 1) * 8 + li) * ldb +
                                       kk + (mi & 1) * 8));
      else
        mma::ldsm_x4_t(bf, mma::smem_u32(b + (kk + (mi & 1) * 8 + li) * ldb +
                                         n0 + (mi >> 1) * 8));
      mma::mma_bf16(acc[j], af, bf[0], bf[1]);
      mma::mma_bf16(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

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
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src) {
  constexpr int E = 16 / sizeof(T), CH = HD / E, LD = HD + kPad<T>;
  for (int c = threadIdx.x; c < kB * CH; c += kThreads) {
    const int r = c / CH, d = (c % CH) * E;
    *reinterpret_cast<uint4*>(dst + r * LD + d) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * HD + d);
  }
}

__device__ __forceinline__ bool live(int q_lo, int k_lo, int causal,
                                     int window) {
  if (causal && k_lo > q_lo + kB - 1) return false;
  if (window && q_lo - (k_lo + kB - 1) >= window) return false;
  return true;
}

// P = exp(S·scale − lse) (0 where masked) and dS = P∘(dP − D) for the
// tile pair (q_lo, k_lo), in place of s and dp; P and dS (rounded to T)
// stored in ps (when not null) and dss, [64][64 + pad]
template <typename T>
__device__ __forceinline__ void softmax_grad(float (&s)[4][4],
                                             float (&dp)[4][4], T* ps,
                                             T* dss, const float* ls,
                                             const float* dl, int q_lo,
                                             int k_lo, int causal,
                                             int window, float scale) {
  constexpr int LP = kB + kPad<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = (warp & 3) * 16 + (lane >> 2);
  const int c0 = (warp >> 2) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + (e >> 1) * 8, col = c0 + j * 8 + (e & 1);
      const int qp = q_lo + row, kp = k_lo + col;
      bool ok = true;
      if (causal) ok = qp >= kp;
      if (window) ok = ok && (qp - kp) < window;
      const float p =
          ok ? expf(__fsub_rn(__fmul_rn(s[j][e], scale), ls[row])) : 0.f;
      const float ds = __fmul_rn(p, __fsub_rn(dp[j][e], dl[row]));
      if (ps != nullptr) ps[row * LP + col] = rt::from_f<T>(p);
      dss[row * LP + col] = rt::from_f<T>(ds);
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

// Block b: column part b % kParts of kv tile (b / kParts) / nbh
// (ascending: the longest causal q ranges first) of head (b / kParts) %
// nbh.
template <typename T, int HD>
__device__ __forceinline__ void
fab_kv(const T* __restrict__ Q, const T* __restrict__ K,
       const T* __restrict__ V, const T* __restrict__ dO,
       const float* __restrict__ LSE, const float* __restrict__ D,
       float* __restrict__ dK, float* __restrict__ dV, int nbh, int sq,
       int skv, int causal, int window, float scale) {
  constexpr int LD = HD + kPad<T>, LP = kB + kPad<T>;
  constexpr int HP = HD / kParts<HD>;            // dK / dV columns summed
  constexpr bool kInPlace = kWalkInPlace<T, HD>;
  constexpr int LW = kInPlace ? HD : LD;         // the walked rows' stride
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kB * LD;
  T* qs = vs + kB * LD;
  T* dos = qs + kWalkTile<T, HD>;
  T* ps = dos + kWalkTile<T, HD>;
  T* dss = ps + kB * LP;
  float* ls = reinterpret_cast<float*>(dss + kB * LP);
  float* dl = ls + kB;

  const int part = blockIdx.x % kParts<HD>, b = blockIdx.x / kParts<HD>;
  const int bh = b % nbh, k_lo = (b / nbh) * kB;
  const int offset = skv - sq;
  load_tile<T, HD>(ks, K + ((size_t)bh * skv + k_lo) * HD);
  load_tile<T, HD>(vs, V + ((size_t)bh * skv + k_lo) * HD);
  float dk[HP / 16][4], dv[HP / 16][4];
  zero(dk);
  zero(dv);
  for (int qi = 0; qi < sq / kB; ++qi) {
    const int q_lo = qi * kB + offset;
    if (!live(q_lo, k_lo, causal, window)) continue;
    __syncthreads();               // the last tile's readers are done
    const size_t row0 = (size_t)bh * sq + qi * kB;
    const T* qt = qs;
    const T* dot = dos;
    if constexpr (kInPlace) {
      qt = Q + row0 * HD;
      dot = dO + row0 * HD;
    } else {
      load_tile<T, HD>(qs, Q + row0 * HD);
      load_tile<T, HD>(dos, dO + row0 * HD);
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
    softmax_grad<T>(s, dp, ps, dss, ls, dl, q_lo, k_lo, causal, window,
                    scale);
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
template <typename T, int HD>
__device__ __forceinline__ void
fab_q(const T* __restrict__ Q, const T* __restrict__ K,
      const T* __restrict__ V, const T* __restrict__ dO,
      const float* __restrict__ LSE, const float* __restrict__ D,
      float* __restrict__ dQ, int nbh, int sq, int skv, int causal,
      int window, float scale) {
  constexpr int LD = HD + kPad<T>, LP = kB + kPad<T>;
  constexpr bool kInPlace = kWalkInPlace<T, HD>;
  constexpr int LW = kInPlace ? HD : LD;         // the walked rows' stride
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kWalkTile<T, HD>;
  T* qs = vs + kWalkTile<T, HD>;
  T* dos = qs + kB * LD;
  T* dss = dos + kB * LD + kB * LP;
  float* ls = reinterpret_cast<float*>(dss + kB * LP);
  float* dl = ls + kB;

  const int nq = sq / kB;
  const int bh = blockIdx.x % nbh, qi = nq - 1 - blockIdx.x / nbh;
  const int q_lo = qi * kB + (skv - sq);
  const size_t row0 = (size_t)bh * sq + qi * kB;
  load_tile<T, HD>(qs, Q + row0 * HD);
  load_tile<T, HD>(dos, dO + row0 * HD);
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
    const T* kt = ks;
    const T* vt = vs;
    if constexpr (kInPlace) {
      kt = K + ((size_t)bh * skv + k_lo) * HD;
      vt = V + ((size_t)bh * skv + k_lo) * HD;
    } else {
      load_tile<T, HD>(ks, K + ((size_t)bh * skv + k_lo) * HD);
      load_tile<T, HD>(vs, V + ((size_t)bh * skv + k_lo) * HD);
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    warp_mm<kB, HD, false, true>(s, qs, LD, kt, LW);     // Q·Kᵀ
    warp_mm<kB, HD, false, true>(dp, dos, LD, vt, LW);   // dO·Vᵀ
    softmax_grad<T>(s, dp, nullptr, dss, ls, dl, q_lo, k_lo, causal, window,
                    scale);
    __syncthreads();
    warp_mm<HD, kB, false, false>(dq, dss, LP, kt, LW);  // dS·K
  }
  store<HD, HD>(dQ + row0 * HD, dq, scale);
}

// the kernels: float32 (scalar) and bf16 (``*_mma``, mma.sync)
#define FAB_ARGS                                                             \
  const T *__restrict__ Q, const T *__restrict__ K, const T *__restrict__ V, \
      const T *__restrict__ dO, const float *__restrict__ LSE,               \
      const float *__restrict__ D
template <int HD, typename T = float>
__global__ void __launch_bounds__(kThreads)
fab_kv_kernel(FAB_ARGS, float* __restrict__ dK, float* __restrict__ dV,
              int nbh, int sq, int skv, int causal, int window, float scale) {
  fab_kv<T, HD>(Q, K, V, dO, LSE, D, dK, dV, nbh, sq, skv, causal, window,
                scale);
}
template <int HD, typename T = bf16>
__global__ void __launch_bounds__(kThreads)
fab_kv_kernel_mma(FAB_ARGS, float* __restrict__ dK, float* __restrict__ dV,
                  int nbh, int sq, int skv, int causal, int window,
                  float scale) {
  fab_kv<T, HD>(Q, K, V, dO, LSE, D, dK, dV, nbh, sq, skv, causal, window,
                scale);
}
template <int HD, typename T = float>
__global__ void __launch_bounds__(kThreads)
fab_q_kernel(FAB_ARGS, float* __restrict__ dQ, int nbh, int sq, int skv,
             int causal, int window, float scale) {
  fab_q<T, HD>(Q, K, V, dO, LSE, D, dQ, nbh, sq, skv, causal, window, scale);
}
template <int HD, typename T = bf16>
__global__ void __launch_bounds__(kThreads)
fab_q_kernel_mma(FAB_ARGS, float* __restrict__ dQ, int nbh, int sq, int skv,
                 int causal, int window, float scale) {
  fab_q<T, HD>(Q, K, V, dO, LSE, D, dQ, nbh, sq, skv, causal, window, scale);
}
#undef FAB_ARGS

template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, float* dq,
           float* dk, float* dv, int bh, int sq, int skv, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  static_assert(smem <= (size_t)rt::kSmemLimit, "tiles too large");
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* dO = static_cast<const T*>(dout);
  const int rows = bh * sq;
  fab_dot_kernel<T, HD><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                           kThreads, 0, stream>>>(static_cast<const T*>(o),
                                                  dO, dsum, rows);
  int e = (int)cudaGetLastError();
  if (e) return e;
  auto run = [&](auto kv, auto qk) -> int {
    int err;
    if ((err = set_smem(kv, smem))) return err;
    kv<<<(unsigned)bh * (skv / kB) * kParts<HD>, kThreads, smem, stream>>>(
        Q, K, V, dO, lse, dsum, dk, dv, bh, sq, skv, causal, window, scale);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = set_smem(qk, smem))) return err;
    qk<<<(unsigned)bh * (sq / kB), kThreads, smem, stream>>>(
        Q, K, V, dO, lse, dsum, dq, bh, sq, skv, causal, window, scale);
    return (int)cudaGetLastError();
  };
  // only the matching pair is instantiated: bf16 on the tensor cores
  if constexpr (sizeof(T) == 2)
    return run(fab_kv_kernel_mma<HD, T>, fab_q_kernel_mma<HD, T>);
  else
    return run(fab_kv_kernel<HD, T>, fab_q_kernel<HD, T>);
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
// multiples of 64, sq <= skv; hd 64, 128 or 256.  Three kernels on
// ``stream``; returns the first cudaError_t.
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
#define FAB_CASE(T, HD)                                                     \
  return fab::launch<T, HD>(q, k, v, o, dout, l, ds, gq, gk, gv, bh, sq,    \
                            skv, causal, window, scale, s);
  if (dtype == rt::kF32 && hd == 64) FAB_CASE(float, 64)
  if (dtype == rt::kF32 && hd == 128) FAB_CASE(float, 128)
  if (dtype == rt::kBF16 && hd == 64) FAB_CASE(__nv_bfloat16, 64)
  if (dtype == rt::kF32 && hd == 256) FAB_CASE(float, 256)
  if (dtype == rt::kBF16 && hd == 128) FAB_CASE(__nv_bfloat16, 128)
  if (dtype == rt::kBF16 && hd == 256) FAB_CASE(__nv_bfloat16, 256)
#undef FAB_CASE
  return (int)cudaErrorInvalidValue;
}
