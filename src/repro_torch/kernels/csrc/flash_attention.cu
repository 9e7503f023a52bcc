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
// Design.  The TPU grid (bh, q-block, kv-block) runs its kv axis in order on
// one core, carrying (m, l, acc) in VMEM scratch.  Here one CUDA block of 256
// threads owns one (bh, 64-row q tile) and walks the kv tiles of 64 rows in
// ascending order inside the block; nothing carries between blocks.  It
// visits exactly the kv tiles that ``_fa_kernel``'s liveness test keeps
// (causal: k_lo <= q_lo + 63; window: q_lo - (k_lo + 63) < window), so it
// makes the reference's sequence of online-softmax updates.  Q, K and V tiles
// are staged through shared memory as float32 (bf16 widens exactly); thread
// (ty, tx) owns score rows ty + 16r and columns tx + 16c (r, c < 4) and the
// same rows of the output, so a row's max and sum are a 16-lane shuffle
// reduction and (m, l, acc) stay in registers.  The arithmetic is the
// reference's: scores summed in float32 then scaled, p = exp(s - m) with a
// true expf, alpha = exp(m_old - m_new), l = l·alpha + Σp, p rounded to V's
// type before the PV product, acc = acc·alpha + PV, O = acc / max(l, 1e-30);
// the separate roundings are written with __fmul_rn / __fadd_rn so the
// compiler does not contract them into FMAs.  A row that has seen only
// masked keys gets p = 1 entries that the first real score wipes (alpha = 0),
// as in the reference.  Blocks run the heaviest causal q tiles first.
//
// What bounds it on the H100: at StableLM-1.6B's prefill cell (BH = 64,
// S = 4096, hd = 64, causal) the tensor-core work is 2·2·64·4096²·64 / 2 =
// 1.37e11 FLOPs, 0.139 ms at 989 TFLOP/s; the bytes (q, k, v, o in bf16,
// 134 MB) take 0.040 ms — so it is bound by operations.  This first version
// does every product as a scalar float32 FMA from shared memory (at most
// 67 TFLOP/s on the card, less with the shared-memory loads each FMA needs)
// and stages synchronously; mma.sync / wgmma on bf16 tiles, TMA loads into a
// staging ring and a larger q tile per warpgroup are later work.
#include "tile.cuh"

namespace fa {

constexpr int kBQ = 64;            // q rows per CUDA block
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

// Block b = bh * nq + t owns rows [qi·64, qi·64 + 64) of head bh, where
// qi = nq - 1 - t (the longest causal kv range first).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ Q, const T* __restrict__ K,
          const T* __restrict__ V, T* __restrict__ O, int sq, int skv, int nq,
          int causal, int window, float scale) {
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
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, int causal, int window, float scale,
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
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, nq, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int skv, int hd, int causal, int window, float scale,
                cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, bh, sq, skv, causal, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, sq, skv, causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, sq, skv, causal, window, scale,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fa

// q (bh, sq, hd), k / v (bh, skv, hd) and o (bh, sq, hd), contiguous, all of
// ``dtype`` (rt::Dtype: float32 or bfloat16); sq and skv multiples of 64,
// sq <= skv; hd 32, 64 or 128.  Returns the cudaError_t of the launch.
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* o, int bh, int sq, int skv, int hd,
                          int causal, int window, float scale, int dtype,
                          void* stream) {
  if (sq % fa::kBQ || skv % fa::kBKV || sq > skv || bh <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return fa::dispatch_hd<float>(q, k, v, o, bh, sq, skv, hd, causal, window,
                                  scale, s);
  if (dtype == rt::kBF16)
    return fa::dispatch_hd<__nv_bfloat16>(q, k, v, o, bh, sq, skv, hd,
                                          causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
