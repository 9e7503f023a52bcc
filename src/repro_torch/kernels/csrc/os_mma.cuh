// Output-stationary matmul on the tensor cores (sm_90a, CUDA C++): the one
// kernel template behind bf16 ``fm_output`` (flex_matmul.cu, the dense
// product), bf16 ``bs_matmul`` (block_sparse.cu, the CSB block-sparse
// product) and, with B an int8 payload and a float32 scale per column,
// bf16-activation ``i8_matmul`` (int8_matmul.cu) and ``bs_matmul_scaled``
// (block_sparse.cu).  Each CTA owns an output tile and keeps its float32
// accumulators in registers across its K range; bf16 products are exact in
// float32.  An int8 payload is staged as int8 (half the bytes) and widened
// to bf16 in shared memory before the products: exact, since |q| <= 127
// fits bf16's 8-bit significand, so a bf16 x int8 product is the same
// exact float32 number either way.
//
// One summation order for every output element, fixed by K alone:
//   * K is cut into 16-element groups aligned to global K offset 0, one
//     mma / wgmma k-step each, staged in 64-element chunks (four groups)
//     aligned to offset 0 too.
//   * K may be split into segments of ``seg`` elements, a constant of the
//     regime (``output_grid``, kernels/flex_matmul.py: it sees no blocks);
//     groups accumulate in ascending order inside a segment, from zero, and
//     ``seg_sum_kernel`` adds the segment partials in ascending order, one
//     rounding per add: ((p0 + p1) + p2) + ...
//   * An int8 product's scale multiplies the whole sum once, after the last
//     add (``__fmul_rn``, in the epilogue or in ``seg_sum_kernel``), as the
//     reference's kernels do.
//   * The dense products multiply every chunk of their segment.  The
//     block-sparse ones multiply the chunks that hold an element of a
//     K-block live in one of the CSB tiles their rows and columns overlap,
//     and skip the others.  A dead (A-block, B-block) pair must have an
//     all-zero operand block (the CSB lists are built from the operands'
//     zero blocks; quantization keeps zeros), so every product it
//     contributes — inside a multiplied chunk, or in a whole skipped chunk
//     — is an exact zero, and a k-step of zero products leaves the
//     accumulator unchanged.  Zero padding at the end of K (it differs
//     with bk) adds only such groups, or whole segments whose partial is +0.
//   So the dense product and the block-sparse one, under any blocks, give
//   the same float32 value for every element, provided both run in the same
//   regime, which depends on M alone — the product's own rows, before any
//   padding to the blocks, which every wrapper passes — so a given element
//   sees the same instruction, the same groups and the same segments in
//   both: ``fm_output`` equals ``bs_matmul``, and ``i8_matmul`` equals
//   ``bs_matmul_scaled``, bit for bit.
//
// Two regimes, chosen from M by the plan (``rows``; ``launch`` refuses a
// plan whose regime does not follow M):
//   skinny (M <= 16: decode, M = n_slots; bound by the weight's bytes):
//     ``os_kernel_mma`` / ``bs_kernel_mma`` (bf16 B), ``i8_kernel_mma`` /
//     ``bsq_kernel_mma`` (int8 B), 256 threads, mma.sync.m16n8k16 on a
//     16 x 128 tile (eight warps of 16 columns, rows zero-padded in shared
//     memory), a four-stage cp.async ring of (16 x 64 A, 64 x 128 B)
//     chunks — each warp widens the 16 int8 columns it multiplies into a
//     bf16 chunk, then multiplies them; K split into segments of 256 so that a
//     2048-wide site still gives 16 strips x 8 segments of CTAs, each
//     writing its float32 partial into a workspace that ``seg_sum_kernel``
//     reduces.  (One launch, with the segment CTAs of a tile in one cluster
//     adding their partials through distributed shared memory, was tried
//     and ran slower at every decode site: PERF.md.)
//   wide (M > 16: prefill, M = B·S; bound by operations):
//     ``os_wg_kernel_mma`` / ``bs_wg_kernel_mma`` (bf16 B),
//     ``i8_wg_kernel_mma`` / ``bsq_wg_kernel_mma`` (int8 B), a 128 x 128
//     tile, two consumer warpgroups of 64 rows issuing one
//     wgmma.mma_async.m64n128k16 per k-step with A and B read from
//     128-byte-swizzled shared panels through matrix descriptors, and a
//     producer thread that keeps a three-stage ring of chunks in flight
//     with TMA (full / empty mbarriers, the full barrier's transaction
//     count tracking the boxes' bytes): 32 KB of bf16 A and B, or 16 KB of
//     A and 8 KB of int8 B, which the consumers widen into one of two bf16
//     B panels, so that widening chunk i + 1 overlaps the wgmma of chunk
//     i.  Two CTAs share an SM.  K is not split.
// The skinny regime also runs E products of one shape in one launch
// (``experts`` > 1, the MoE expert contraction (E, C, K) @ (E, K, N)): the
// grid's y axis picks the expert, whose operands, lists, scales, output and
// workspace sit at fixed strides from the first; each expert's CTAs do
// exactly what a launch of that expert alone does, so the batched launch
// equals E single launches bit for bit.
// Operands are row-major with 16-byte aligned bases and row strides (lda,
// ldb, in elements; the wrappers copy an operand that is not into rows
// padded with zeros); an int8 B is (k, n), never read transposed.  Every
// edge — rows past M, columns past N, K past its end, a bn or bm narrower
// than the tile — is zero in shared memory.  The output (float32 or bf16,
// rounded to nearest even by ``rt::from_f``) is written once.
#pragma once

#include <cuda.h>            // CUtensorMap
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled

#include <type_traits>

#include "mma.cuh"
#include "tile.cuh"

namespace osm {

using mma::bf16;

constexpr int kChunk = 64;          // K elements of a staged chunk
constexpr int kCols = 128;          // output columns of a CTA
constexpr int kSkinnyRows = 16;     // rows of a skinny CTA (M <= 16)
constexpr int kSkinnyStages = 4;
constexpr int kSkinnyThreads = mma::kThreads;   // 256: the mma.cuh tile
constexpr int kWideRows = 128;      // rows of a wide CTA
constexpr int kWideStages = 3;     // x 32 KB (24 KB int8 B): 2 CTAs / SM
constexpr int kWideThreads = 9 * 32;            // 8 consumer warps + producer

static_assert(kChunk == mma::kKC && kCols == mma::kTN,
              "the skinny tile stages with mma.cuh's helpers");

// Arguments of one launch; operands already padded to block multiples for
// the block-sparse product.
struct OsArgs {
  const bf16* a;          // (m, k), row stride lda
  const void* b;          // bf16 (k, n), row stride ldb; (n, k) when BT;
                          // or int8 (k, n)
  void* out;              // (m, n) float32 or bf16, row-major
  float* ws;              // (segments, m, n) float32 partials, or null
  const int* kidx;        // CSB lists (block-sparse only)
  const int* kcnt;
  int m, n, k, lda, ldb, bm, bn, bk, max_nnz;
  int rows;               // the plan's CTA rows: kSkinnyRows or kWideRows
  int seg;                // K elements per segment (skinny); 0: all of K
  const float* scale;     // (n,) per-column scale of an int8 B, else null
  // an expert-batched launch (skinny only): ``experts`` products, expert e's
  // A at a + e·ea, B at b + e·eb, lists at kidx + e·ekidx and kcnt + e·ekcnt
  // (elements), scale at scale + e·n, output at out + e·m·n, partials at
  // ws + e·segments·m·n
  int experts = 1;
  long long ea = 0, eb = 0, ekidx = 0, ekcnt = 0;
};

// Make ``p`` an expert-batched launch of ``experts`` products at the given
// element strides (``launch`` checks them when ``experts`` > 1).
inline void set_experts(OsArgs& p, int experts, long long ea, long long eb,
                        long long ekidx, long long ekcnt) {
  p.experts = experts;
  p.ea = ea;
  p.eb = eb;
  p.ekidx = ekidx;
  p.ekcnt = ekcnt;
}

template <typename TB>
constexpr bool kInt8 = std::is_same_v<TB, int8_t>;

// Shared-memory words of a CTA's chunk list: a count, the liveness bits and
// the list itself, for at most ``per`` chunks.
__host__ __device__ inline int list_words(int per) {
  return 4 + (per + 31) / 32 + per;
}

// Every thread of the CTA calls this.  Writes to ``list`` the chunks in
// [c0, c1), ascending, that the CTA multiplies — all of them for the dense
// product; for the block-sparse one, those holding an element of a K-block
// listed in kidx[i, j, :kcnt[i, j]] for a tile (i, j) that rows [m0, m0 +
// mrows) and columns [n0, n0 + ncols) overlap — and returns their count.
template <bool kSparse>
__device__ int build_chunks(int* words, const OsArgs& p, int c0, int c1,
                            int m0, int mrows, int n0, int ncols) {
  const int per = c1 - c0;
  int* count = words;
  uint32_t* bits = reinterpret_cast<uint32_t*>(words + 4);
  int* list = words + 4 + (per + 31) / 32;
  const int tid = threadIdx.x, nthr = blockDim.x;
  if constexpr (!kSparse) {
    for (int i = tid; i < per; i += nthr) list[i] = c0 + i;
    if (tid == 0) *count = max(per, 0);
    __syncthreads();
    return *count;
  }
  for (int i = tid; i < (per + 31) / 32; i += nthr) bits[i] = 0u;
  __syncthreads();
  const int tn = p.n / p.bn;
  const int i0 = m0 / p.bm, i1 = (m0 + mrows - 1) / p.bm;
  const int j0 = n0 / p.bn, j1 = (n0 + ncols - 1) / p.bn;
  const int nj = j1 - j0 + 1, tiles = (i1 - i0 + 1) * nj;
  for (int e = tid; e < tiles * p.max_nnz; e += nthr) {
    const int tile = e / p.max_nnz, s = e % p.max_nnz;
    const int i = i0 + tile / nj, j = j0 + tile % nj;
    const size_t t = (size_t)i * tn + j;
    if (s >= p.kcnt[t]) continue;
    const long long lo = (long long)p.kidx[t * p.max_nnz + s] * p.bk;
    const int a = max((int)(lo / kChunk), c0);
    const int b = min((int)((lo + p.bk - 1) / kChunk), c1 - 1);
    for (int c = a; c <= b; ++c)
      atomicOr(&bits[(c - c0) >> 5], 1u << ((c - c0) & 31));
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int c = 0; c < per; ++c)
      if (bits[c >> 5] >> (c & 31) & 1u) list[n++] = c0 + c;
    *count = n;
  }
  __syncthreads();
  return *count;
}

// Two neighbouring outputs (r, c) and (r, c + 1) of a tile at ``out`` (row
// stride ldo), masked to (mrows, ncols).
template <typename To>
__device__ __forceinline__ void put2(To* out, int ldo, int r, int c,
                                     float v0, float v1, int mrows,
                                     int ncols) {
  if (r >= mrows || c >= ncols) return;
  To* q = out + (size_t)r * ldo + c;
  const To x0 = rt::from_f<To>(v0), x1 = rt::from_f<To>(v1);
  if (c + 1 < ncols && (ldo & 1) == 0 &&
      (reinterpret_cast<uintptr_t>(q) & (2 * sizeof(To) - 1)) == 0) {
    if constexpr (std::is_same_v<To, float>)
      *reinterpret_cast<float2*>(q) = make_float2(x0, x1);
    else
      *reinterpret_cast<__nv_bfloat162*>(q) = __halves2bfloat162(x0, x1);
  } else {
    q[0] = x0;
    if (c + 1 < ncols) q[1] = x1;
  }
}

// (v0, v1) of columns (c, c + 1) times their scales ``sc[c]``, ``sc[c + 1]``
// (those inside ``ncols``): the int8 product's one multiply.
__device__ __forceinline__ void scale2(const float* sc, int c, int ncols,
                                       float& v0, float& v1) {
  if (c < ncols) v0 = __fmul_rn(v0, sc[c]);
  if (c + 1 < ncols) v1 = __fmul_rn(v1, sc[c + 1]);
}

// An int8 chunk in shared memory: 64 rows (k) of 128 bytes (n), the 16-byte
// piece c of row k at piece c ^ (k % 8) — TMA's 128-byte swizzle, which
// ``stage_q`` copies, so that eight threads reading one piece of eight rows
// hit eight bank groups.
__device__ __forceinline__ int q_piece(int k, int c) {
  return k * kCols + (((c ^ k) & 7) << 4);
}

// Stage 64 rows x 128 columns of a row-major int8 payload (``Q`` at the
// chunk's origin, row stride ``ldq`` bytes) into ``Qs`` with cp.async, 16
// elements per copy; rows >= ``kc`` and columns >= ``nc`` are zero.
__device__ __forceinline__ void stage_q(int8_t* Qs,
                                        const int8_t* __restrict__ Q,
                                        int ldq, int kc, int nc) {
  for (int e = threadIdx.x; e < kChunk * (kCols / 16); e += blockDim.x) {
    const int k = e >> 3, c = e & 7, n16 = c << 4;
    int8_t* dst = Qs + q_piece(k, c);
    const int8_t* src = Q + (size_t)k * ldq + n16;
    if (k < kc && n16 + 16 <= nc) {
      mma::cp_async16(mma::smem_u32(dst), src);
    } else {
      uint4 u;
      int8_t* t = reinterpret_cast<int8_t*>(&u);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        t[j] = (k < kc && n16 + j < nc) ? src[j] : int8_t(0);
      *reinterpret_cast<uint4*>(dst) = u;
    }
  }
}

// The four int8 of ``w`` as two bf16x2 words (bytes 0-1, bytes 2-3),
// exactly, on the integer and float32 pipes rather than the conversion
// unit (whose 16 lanes per SM would bound the widening): byte x + 128 set
// into the mantissa of 2^23 is the float 2^23 + 128 + x, less 2^23 + 128
// is x, and x's bf16 is its float's top 16 bits (|x| <= 128 has at most 8
// significant bits).
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__fsub_rn(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)),
        8388736.f));
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// Widen piece c (columns 16c .. 16c + 15) of row k of a staged int8 chunk
// (``q_piece``'s layout) into bf16 at ``Bw`` in the layout of
// ``mma::stage_b`` for a 64-row chunk: two n-halves of 64 x 64, each row's
// 16-byte pieces permuted by ``swz64`` — what ``mma::mac_chunk`` reads
// through ldmatrix, and what a 128-byte-swizzled wgmma descriptor reads.
// Eight threads on eight consecutive rows of one piece hit eight bank
// groups, reading and writing.
__device__ __forceinline__ void widen_piece(bf16* Bw, const int8_t* Qs,
                                            int k, int c) {
  const uint4 u = *reinterpret_cast<const uint4*>(Qs + q_piece(k, c));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t h[8];
#pragma unroll
  for (int j = 0; j < 4; ++j)           // bytes 0-3 of w[j]: 4j .. 4j + 3
    widen4(w[j], h[2 * j], h[2 * j + 1]);
  bf16* half = Bw + (c >> 2) * kChunk * 64;          // columns 16c .. 16c+15
  const int col = (c & 3) << 4;
  *reinterpret_cast<uint4*>(half + mma::swz64(k, col)) =
      make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(half + mma::swz64(k, col + 8)) =
      make_uint4(h[4], h[5], h[6], h[7]);
}

static_assert(kCols / 16 == kSkinnyThreads / 32,
              "a skinny warp widens the one piece its columns cover");

// ---------------------------------------------------------------------------
// skinny: mma.sync on a 16 x 128 tile, one K segment per CTA
// ---------------------------------------------------------------------------

// The ring of S (B, A) chunks, the widened bf16 chunk of an int8 B, the
// chunk list.
template <typename TB>
__host__ __device__ inline size_t skinny_smem(int per) {
  return (size_t)kSkinnyStages * (kChunk * kCols * sizeof(TB) +
                                  kSkinnyRows * kChunk * sizeof(bf16)) +
         (kInt8<TB> ? (size_t)kChunk * kCols * sizeof(bf16) : 0) +
         (size_t)list_words(per) * sizeof(int);
}

// The arguments of expert ``e`` of an expert-batched launch alone.
template <typename To, typename TB>
__device__ __forceinline__ OsArgs expert_args(const OsArgs& p0, int e,
                                              int segments) {
  OsArgs p = p0;
  p.experts = 1;
  p.a += e * p0.ea;
  p.b = static_cast<const TB*>(p0.b) + e * p0.eb;
  p.out = static_cast<To*>(p0.out) + (size_t)e * p0.m * p0.n;
  if (p0.ws) p.ws += (size_t)e * segments * p0.m * p0.n;
  if (p0.kidx) p.kidx += e * p0.ekidx;
  if (p0.kcnt) p.kcnt += e * p0.ekcnt;
  if (p0.scale) p.scale += (size_t)e * p0.n;
  return p;
}

// Block (strip, expert, segment) = (blockIdx.x, blockIdx.y, blockIdx.z).
template <bool kSparse, bool BT, typename To, typename TB>
__device__ __forceinline__ void skinny_body(const OsArgs& p0) {
  constexpr int S = kSkinnyStages;
  static_assert(!(kInt8<TB> && BT), "an int8 B is read row-major");
  extern __shared__ __align__(16) unsigned char smem[];
  TB* Bs = reinterpret_cast<TB*>(smem);                  // S x (64 x 128)
  bf16* As = reinterpret_cast<bf16*>(Bs + S * kChunk * kCols);  // S x 16x64
  bf16* Bw = As + S * kSkinnyRows * kChunk;    // int8: the widened chunk
  int* words = reinterpret_cast<int*>(Bw + (kInt8<TB> ? kChunk * kCols : 0));
  const int chunks = (p0.k + kChunk - 1) / kChunk, per = p0.seg / kChunk;
  const OsArgs p = expert_args<To, TB>(p0, blockIdx.y,
                                       (chunks + per - 1) / per);
  const TB* b = static_cast<const TB*>(p.b);
  const int n0 = blockIdx.x * kCols;
  const int ncols = min(kCols, p.n - n0), mrows = p.m;
  const int c0 = blockIdx.z * per, c1 = min(chunks, c0 + per);
  const int nc = build_chunks<kSparse>(words, p, c0, c1, 0, mrows, n0,
                                       ncols);
  const int* list = words + 4 + (c1 - c0 + 31) / 32;

  auto load = [&](int i) {            // chunk list[i] into stage i % S
    const int kk = list[i] * kChunk, kc = min(kChunk, p.k - kk);
    mma::stage_a<kSkinnyRows>(As + (i % S) * kSkinnyRows * kChunk, p.a + kk,
                              p.lda, mrows, kc, true);
    const TB* src = BT ? b + (size_t)n0 * p.ldb + kk
                       : b + (size_t)kk * p.ldb + n0;
    if constexpr (kInt8<TB>)
      stage_q(Bs + (i % S) * kChunk * kCols, src, p.ldb, kc, ncols);
    else
      mma::stage_b<BT>(Bs + (i % S) * kChunk * kCols, src, p.ldb, kc, ncols,
                       kChunk, true);
  };

  mma::Acc<kSkinnyRows> acc;
  mma::zero_acc<kSkinnyRows>(acc);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nc) load(i);
    mma::cp_async_commit();
  }
  for (int i = 0; i < nc; ++i) {
    mma::cp_async_wait<S - 2>();
    __syncthreads();                  // chunk i landed; stage (i - 1) free
    if (i + S - 1 < nc) load(i + S - 1);
    mma::cp_async_commit();
    const bf16* a_i = As + (i % S) * kSkinnyRows * kChunk;
    if constexpr (kInt8<TB>) {
      // warp w multiplies columns [16w, 16w + 16) alone (mma::Warps<16>),
      // so it widens that piece alone: no barrier beyond its own warp
      const int warp = threadIdx.x >> 5;
      for (int k = threadIdx.x & 31; k < kChunk; k += 32)
        widen_piece(Bw, Bs + (i % S) * kChunk * kCols, k, warp);
      __syncwarp();
      mma::mac_chunk<kSkinnyRows, false>(acc, a_i, Bw, kChunk, 0);
    } else {
      mma::mac_chunk<kSkinnyRows, BT>(acc, a_i, Bs + (i % S) * kChunk * kCols,
                                      kChunk, 0);
    }
  }

  // Warps<16>: warp w owns columns [16w, 16w + 16), lane (g, t) rows g and
  // g + 8, columns 2t and 2t + 1 of each n8 tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h, c = warp * 16 + ni * 8 + 2 * t;
      float v0 = acc[0][ni][2 * h], v1 = acc[0][ni][2 * h + 1];
      if constexpr (kInt8<TB>)        // a split grid scales in the sum
        if (!p.ws) scale2(p.scale + n0, c, ncols, v0, v1);
      if (p.ws)
        put2<float>(p.ws + (size_t)blockIdx.z * p.m * p.n + n0, p.n, r, c,
                    v0, v1, mrows, ncols);
      else
        put2<To>(static_cast<To*>(p.out) + n0, p.n, r, c, v0, v1, mrows,
                 ncols);
    }
}

template <bool BT, typename To>
__global__ void __launch_bounds__(kSkinnyThreads)
os_kernel_mma(const OsArgs p) {
  skinny_body<false, BT, To, bf16>(p);
}

template <bool BT, typename To>
__global__ void __launch_bounds__(kSkinnyThreads)
bs_kernel_mma(const OsArgs p) {
  skinny_body<true, BT, To, bf16>(p);
}

template <typename To>
__global__ void __launch_bounds__(kSkinnyThreads)
i8_kernel_mma(const OsArgs p) {
  skinny_body<false, false, To, int8_t>(p);
}

template <typename To>
__global__ void __launch_bounds__(kSkinnyThreads)
bsq_kernel_mma(const OsArgs p) {
  skinny_body<true, false, To, int8_t>(p);
}

// out = ((ws[0] + ws[1]) + ws[2]) + ..., one rounding per add, then times
// the column's ``scale`` when there is one (an int8 product), then the
// output's type: the segment partials in ascending order.  ``total`` =
// experts · mn outputs: expert e's partials (segments, m, n) start at
// ws + e·segments·mn, its scales at scale + e·n.
template <typename To>
__global__ void seg_sum_kernel(const float* __restrict__ ws,
                               const float* __restrict__ scale,
                               To* __restrict__ out, long long total, int mn,
                               int n, int segments) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long e = i / mn, j = i - e * mn;
  const float* w = ws + e * segments * mn + j;
  float s = w[0];
  for (int g = 1; g < segments; ++g) s = __fadd_rn(s, w[(size_t)g * mn]);
  if (scale) s = __fmul_rn(s, scale[e * n + j % n]);
  out[i] = rt::from_f<To>(s);
}

// ---------------------------------------------------------------------------
// wide: wgmma on a 128 x 128 tile, a TMA producer + two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kPanelA = kWideRows * kChunk;   // A chunk, elements (16 KB)
constexpr int kPanelB = kChunk * kCols;       // B chunk, elements (16 KB)

// Bytes of one ring stage: an A chunk and a B chunk in B's own type.
template <typename TB>
constexpr int kWideStage = kPanelA * sizeof(bf16) + kPanelB * sizeof(TB);

template <typename TB>
__host__ __device__ inline size_t wide_smem(int per) {
  // 1 KB of alignment slack, the ring, the two widened bf16 B panels of an
  // int8 B, full / empty barriers, the list: 104 KB + the list for int8
  return 1024 + (size_t)kWideStages * kWideStage<TB> +
         (kInt8<TB> ? 2 * (size_t)kPanelB * sizeof(bf16) : 0) +
         2 * kWideStages * sizeof(uint64_t) +
         (size_t)list_words(per) * sizeof(int);
}

// A barrier of the two consumer warpgroups (256 threads; the producer warp
// does not take part): named barrier 1.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// d (64 x 128, float32, this warpgroup) += A (64 x 16) · B (16 x 128), both
// bf16 in shared memory through descriptors; TB: B stored n-major.
// d[32h + 4j + e] holds row g + 8(e >> 1), column 64h + 8j + 2t + (e & 1).
template <int TB>
__device__ __forceinline__ void wgmma128_ss(float (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// One 2-D TMA load of a box at (x = inner, y = outer) of ``map`` into
// ``dst``, completing on the mbarrier ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// One 1-D bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into ``dst``, completing on ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Arrive on ``bar`` and add ``bytes`` to the transaction count it awaits.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Block (strip, M-tile) = (blockIdx.x, blockIdx.y); ``ta`` / ``tb`` are the
// tensor maps of A and B (make_tmap).
template <bool kSparse, bool BT, typename To, typename TB>
__device__ __forceinline__ void wide_body(const OsArgs& p,
                                          const CUtensorMap* ta,
                                          const CUtensorMap* tb) {
  constexpr int S = kWideStages, kStage = kWideStage<TB>;
  static_assert(!(kInt8<TB> && BT), "an int8 B is read row-major");
  static_assert(kStage % 1024 == 0, "stages keep the swizzle's alignment");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled panels need 1024-byte alignment
  unsigned char* smem =
      smem_raw + ((1024 - (mma::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;                      // stage s: A then B
  bf16* wide = reinterpret_cast<bf16*>(ring + S * kStage);   // int8: 2 panels
  uint64_t* full = reinterpret_cast<uint64_t*>(
      wide + (kInt8<TB> ? 2 * kPanelB : 0));
  uint64_t* empty = full + S;
  int* words = reinterpret_cast<int*>(empty + S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * kWideRows;
  const int ncols = min(kCols, p.n - n0), mrows = min(kWideRows, p.m - m0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mma::mbar_init(mma::smem_u32(&full[s]), 1);
      mma::mbar_init(mma::smem_u32(&empty[s]), 8);
    }
    mma::fence_barrier_init();
  }
  const int chunks = (p.k + kChunk - 1) / kChunk;
  const int nc = build_chunks<kSparse>(words, p, 0, chunks, m0, mrows, n0,
                                       ncols);     // synchronises the block
  const int* list = words + 4 + (chunks + 31) / 32;

  if (warp == 8) {
    // producer, one thread: per listed chunk, in order, TMA boxes of A (128
    // rows x 64 k) and B (two of 64 k x 64 n, or one of 128 n x 64 k when
    // BT, or one of 64 k x 128 int8 n) into a free stage, 128-byte swizzled
    // and zero past the matrices' ends; the stage's ``full`` barrier
    // completes when all their bytes have landed
    if (lane != 0) return;
    for (int i = 0; i < nc; ++i) {
      const int s = i % S, kk = list[i] * kChunk;
      mma::mbar_wait(mma::smem_u32(&empty[s]), ((i / S) & 1) ^ 1);
      const uint32_t bar = mma::smem_u32(&full[s]);
      const uint32_t as = mma::smem_u32(ring + s * kStage);
      const uint32_t bs = as + kPanelA * sizeof(bf16);
      mbar_expect_tx(bar, kStage);
      tma_load(as, ta, bar, kk, m0);
      if (kInt8<TB>) {
        tma_load(bs, tb, bar, n0, kk);
      } else if (BT) {
        tma_load(bs, tb, bar, kk, n0);
      } else {
        tma_load(bs, tb, bar, n0, kk);
        tma_load(bs + kChunk * 64 * sizeof(bf16), tb, bar, n0 + 64, kk);
      }
    }
    return;
  }
  // consumers: warpgroup h owns rows [64h, 64h + 64) of the tile
  const int h = warp >> 2;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  for (int i = 0; i < nc; ++i) {
    const int s = i % S;
    mma::mbar_wait(mma::smem_u32(&full[s]), (i / S) & 1);
    const uint32_t as = mma::smem_u32(ring + s * kStage);
    uint32_t bs = as + kPanelA * sizeof(bf16);
    if constexpr (kInt8<TB>) {
      // widen the int8 chunk into panel i % 2, whose last products (chunk
      // i - 2, both warpgroups) the second barrier of the previous
      // iteration saw done; the async proxy (wgmma) reads what these
      // generic stores wrote once both warpgroups have fenced them
      bf16* panel = wide + (i & 1) * kPanelB;
      const int8_t* q = reinterpret_cast<const int8_t*>(
          ring + s * kStage + kPanelA * sizeof(bf16));
      for (int e = threadIdx.x; e < kChunk * (kCols / 16); e += 256)
        widen_piece(panel, q, e % kChunk, e / kChunk);
      mma::fence_proxy_async();
      consumers_sync();
      bs = mma::smem_u32(panel);
    }
    mma::pin(acc);
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      // all 128 columns in one instruction.  BT: 128 n rows of 128 bytes,
      // 1 KB per 8 rows; else two n-major 64-column halves, the
      // descriptor's leading offset (8 KB) stepping from one to the other
      const uint64_t da = mma::sw128_desc(as + h * 64 * 128 + kk * 32, 16,
                                          1024);
      if constexpr (BT)
        wgmma128_ss<0>(acc, da, mma::sw128_desc(bs + kk * 32, 16, 1024));
      else
        wgmma128_ss<1>(acc, da,
                       mma::sw128_desc(bs + kk * 16 * 128, 64 * 128, 1024));
    }
    mma::wgmma_commit();
    // the previous chunk's products are done: release its stage
    mma::wgmma_wait<1>();
    mma::pin(acc);
    if constexpr (kInt8<TB>)
      consumers_sync();    // in both warpgroups: its panel may be rewritten
    if (i > 0 && lane == 0)
      mma::mbar_arrive(mma::smem_u32(&empty[(i - 1) % S]));
  }
  mma::wgmma_wait<0>();
  mma::pin(acc);

  // accumulator layout: warp w of the warpgroup holds rows 16w .. 16w + 15;
  // acc[32nh + 4j + e] is row g + 8(e >> 1), column 64nh + 8j + 2t + (e & 1)
  const int g = lane >> 2, t = lane & 3;
  const int r0 = h * 64 + (warp & 3) * 16 + g;
  To* out = static_cast<To*>(p.out) + (size_t)m0 * p.n + n0;
#pragma unroll
  for (int nh = 0; nh < 2; ++nh)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = nh * 64 + 8 * j + 2 * t;
        float v0 = acc[32 * nh + 4 * j + 2 * hh],
              v1 = acc[32 * nh + 4 * j + 2 * hh + 1];
        if constexpr (kInt8<TB>) scale2(p.scale + n0, c, ncols, v0, v1);
        put2<To>(out, p.n, r0 + 8 * hh, c, v0, v1, mrows, ncols);
      }
}

template <bool BT, typename To>
__global__ void __launch_bounds__(kWideThreads, 2)
os_wg_kernel_mma(const OsArgs p, const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb) {
  wide_body<false, BT, To, bf16>(p, &ta, &tb);
}

template <bool BT, typename To>
__global__ void __launch_bounds__(kWideThreads, 2)
bs_wg_kernel_mma(const OsArgs p, const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb) {
  wide_body<true, BT, To, bf16>(p, &ta, &tb);
}

template <typename To>
__global__ void __launch_bounds__(kWideThreads, 2)
i8_wg_kernel_mma(const OsArgs p, const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb) {
  wide_body<false, false, To, int8_t>(p, &ta, &tb);
}

template <typename To>
__global__ void __launch_bounds__(kWideThreads, 2)
bsq_wg_kernel_mma(const OsArgs p, const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb) {
  wide_body<true, false, To, int8_t>(p, &ta, &tb);
}

// A 2-D tensor map of a row-major matrix of bf16 or int8 ``TB`` (``outer``
// rows of ``inner`` elements, row stride ``ld`` elements) in boxes of
// ``box_outer`` rows x 128 bytes (64 bf16 or 128 int8 elements), 128-byte
// swizzled, zero outside the matrix.  0 or an error.
template <typename TB>
inline int make_tmap(CUtensorMap* map, const void* base, int inner,
                     int outer, int ld, int box_outer) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(TB)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(TB)),
                             (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map,
      kInt8<TB> ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2,
      const_cast<void*>(static_cast<const void*>(base)), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The kernel of a regime, instantiated only for the product it serves.
template <bool kSparse, bool BT, typename To, typename TB>
constexpr auto skinny_kernel() {
  if constexpr (kInt8<TB>) {
    if constexpr (kSparse)
      return bsq_kernel_mma<To>;
    else
      return i8_kernel_mma<To>;
  } else if constexpr (kSparse) {
    return bs_kernel_mma<BT, To>;
  } else {
    return os_kernel_mma<BT, To>;
  }
}

template <bool kSparse, bool BT, typename To, typename TB>
constexpr auto wide_kernel() {
  if constexpr (kInt8<TB>) {
    if constexpr (kSparse)
      return bsq_wg_kernel_mma<To>;
    else
      return i8_wg_kernel_mma<To>;
  } else if constexpr (kSparse) {
    return bs_wg_kernel_mma<BT, To>;
  } else {
    return os_wg_kernel_mma<BT, To>;
  }
}

template <bool kSparse, bool BT, typename To, typename TB>
int launch_typed(const OsArgs& p, cudaStream_t s) {
  const unsigned strips = (p.n + kCols - 1) / kCols;
  const int chunks = (p.k + kChunk - 1) / kChunk;
  if (p.rows == kSkinnyRows) {
    auto kern = skinny_kernel<kSparse, BT, To, TB>();
    const int per = p.seg / kChunk, segments = (chunks + per - 1) / per;
    const size_t smem = skinny_smem<TB>(per);
    if (smem > (size_t)rt::kSmemLimit) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(strips, p.experts, segments), kSkinnyThreads, smem, s>>>(p);
    if (segments > 1) {
      const int mn = p.m * p.n;
      const long long total = (long long)p.experts * mn;
      seg_sum_kernel<To><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
          p.ws, p.scale, static_cast<To*>(p.out), total, mn, p.n, segments);
    }
    return (int)cudaGetLastError();
  }
  auto kern = wide_kernel<kSparse, BT, To, TB>();
  const size_t smem = wide_smem<TB>(chunks);
  if (smem > (size_t)rt::kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap ta{}, tb{};
  int r = make_tmap<bf16>(&ta, p.a, p.k, p.m, p.lda, kWideRows);
  if (r == 0)
    r = BT ? make_tmap<TB>(&tb, p.b, p.k, p.n, p.ldb, kCols)
           : make_tmap<TB>(&tb, p.b, p.n, p.k, p.ldb, kChunk);
  if (r != 0) return r;
  kern<<<dim3(strips, (p.m + kWideRows - 1) / kWideRows), kWideThreads, smem,
         s>>>(p, ta, tb);
  return (int)cudaGetLastError();
}

// The product under the plan of ``output_grid``: ``p.rows`` picks the
// regime and must follow M (16 rows and K segments of ``p.seg`` at M <= 16,
// ``p.ws`` holding the partials when there is more than one; 128 rows and
// all of K above).  M is the product's own row count: a block-sparse A may
// hold more rows (zero padding to bm), which are never read, and its row
// tiles are i = row / bm.  ``TB``: B's type, bf16 (``p.scale`` null) or an
// int8 payload (``p.scale`` its column scales; row-major only).  Operands
// need 16-byte aligned bases and row strides (TMA's and cp.async's unit).
// ``p.experts`` > 1 batches that many products of the skinny regime (B
// row-major, or each expert's B the transpose of a row-major (n, k) matrix
// (``b_trans``: the backward's Wᵀ); every expert's operands 16-byte
// aligned, lists and scales non-null as for one).  Refuses anything else.
template <bool kSparse, typename TB = bf16>
int launch(const OsArgs& p, int b_trans, int out_dtype, cudaStream_t s) {
  if (p.m <= 0 || p.n <= 0 || p.k <= 0 || p.bm <= 0 || p.bn <= 0 ||
      p.bk <= 0 || p.experts <= 0 || p.experts > 65535)
    return (int)cudaErrorInvalidValue;
  if (p.experts > 1 &&
      (p.rows != kSkinnyRows || p.ea < (long long)p.m * p.lda ||
       p.eb < (long long)(b_trans ? p.n : p.k) * p.ldb || (p.ea * 2) % 16 ||
       (p.eb * (long long)sizeof(TB)) % 16 ||
       (kSparse && (p.ekidx <= 0 || p.ekcnt <= 0))))
    return (int)cudaErrorInvalidValue;
  const int chunks = (p.k + kChunk - 1) / kChunk;
  const bool plan_ok =
      p.rows == kSkinnyRows
          ? p.m <= kSkinnyRows && p.seg > 0 && p.seg % kChunk == 0 &&
                (chunks > p.seg / kChunk) == (p.ws != nullptr)
          : p.rows == kWideRows && p.m > kSkinnyRows && p.seg == 0 &&
                p.ws == nullptr;
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  constexpr int unit = 16 / sizeof(TB);     // elements of 16 bytes
  if (!mma::aligned16(p.a) || !mma::aligned16(p.b) || p.lda % 8 ||
      p.ldb % unit || p.lda < p.k || p.ldb < (b_trans ? p.k : p.n))
    return (int)cudaErrorInvalidValue;
  if (kSparse && (p.n % p.bn || p.k % p.bk || p.max_nnz < 0 || !p.kidx ||
                  !p.kcnt))
    return (int)cudaErrorInvalidValue;
  if constexpr (kInt8<TB>) {
    if (b_trans || !p.scale) return (int)cudaErrorInvalidValue;
    if (out_dtype == rt::kF32)
      return launch_typed<kSparse, false, float, TB>(p, s);
    if (out_dtype == rt::kBF16)
      return launch_typed<kSparse, false, bf16, TB>(p, s);
  } else {
    if (p.scale) return (int)cudaErrorInvalidValue;
    if (out_dtype == rt::kF32)
      return b_trans ? launch_typed<kSparse, true, float, TB>(p, s)
                     : launch_typed<kSparse, false, float, TB>(p, s);
    if (out_dtype == rt::kBF16)
      return b_trans ? launch_typed<kSparse, true, bf16, TB>(p, s)
                     : launch_typed<kSparse, false, bf16, TB>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace osm
