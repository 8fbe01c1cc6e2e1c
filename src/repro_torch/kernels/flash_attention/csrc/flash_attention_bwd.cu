// flash_attention_bwd: the gradient of causal / windowed / softcapped GQA
// attention over a whole sequence, for sm_90a, on the tensor cores.
//
// The JAX package has no backward kernel: off the TPU it differentiates
// the plain src/repro/kernels/flash_attention/ref.py:mha, and this is the
// gradient of the function its Pallas kernel src/repro/kernels/
// flash_attention/kernel.py (_body, launched from flash_attention)
// computes.  For q (B, S, H, D), k, v (B, S, KV, D), the output o and its
// gradient dO (B, S, H, D), and the forward's row logsumexp in log2 units
// lse (B, H, S) float32 (csrc/flash_attention.cu writes it when asked):
//   s_ij  = (q_i . k_j) * scale; with a cap, t = tanh(s / cap), s = cap t
//   p_ij  = exp2(s_ij log2(e) - lse_i) where the masks keep (i, j), else 0
//   D_i   = dO_i . o_i                          (bwd_delta)
//   dV_j  = sum_i p_ij dO_i                     (bwd_main, dK/dV part)
//   ds_ij = p_ij (dO_i . v_j - D_i) (1 - t^2 with a cap) * scale
//   dK_j  = sum_i ds_ij q_i                     (bwd_main, dK/dV part)
//   dQ_i  = sum_j ds_ij k_j                     (bwd_main, dQ part)
// Query head h reads KV head h / G (G = H / KV), so dK and dV of a KV
// head sum over its G query heads.
//
// Bound: five products of D over the (query, key) pairs the masks keep,
// 10 D operations a pair and head, against q, k, v, o, dO, lse read once
// and dq, dk, dv written once: at SmolLM-360M's training shape (B 8,
// S 512, H 15, KV 5, D 64, bfloat16) 12.6 us, bound by bytes, with the
// operations 10.2 us at the bfloat16 tensor-core rate.
//
// Design, one step for each thing that held the CUDA-core kernel back
// (deterministic throughout: no atomics, every output element written
// once by one warp after a sum in a fixed order, so a repeated call is
// bitwise equal):
//  1. Tensor cores for every product.  bfloat16 runs mma.sync m16n8k16
//     with float32 accumulators; p and ds are rounded to bfloat16 where
//     they become A operands, as the forward rounds p.  float32 runs the
//     forward's 3xTF32 split on m16n8k8: x = hi + lo, hi rounded to TF32
//     on the bits, and a.b summed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
//     (one TF32 product misses the 1e-4 float32 tolerance); the small
//     products go into the same accumulator, the registers being needed
//     for the output's.  dQ takes blocks of its own that recompute s and
//     dO . v, seven products where five would do, in place of float
//     atomics into dQ.
//  2. The transposed tiles stay in registers.  A dK/dV warp owns a
//     16-key strip and computes S^T = K Q^T and dP^T = V dO^T, so p^T and
//     ds^T sit in the accumulator layout (rows keys, columns queries) and
//     feed dV += p^T dO and dK += ds^T Q as A operands, with no round trip
//     through shared memory; lse and D are read per column.  dO and Q
//     come in as B operands through ldmatrix.trans (bfloat16) or padded
//     4-byte loads (float32, rows DP + 4 words: the lanes' words fall on
//     32 banks for both the row-wise and the transposed reads; ldmatrix
//     is 16-bit).  A dQ warp owns a 16-row query strip, computes S and
//     dP, and feeds ds into dQ += ds K, with K through ldmatrix.trans;
//     lse and D are read per row.  bfloat16 rows are DP + 8 elements:
//     16-byte aligned for ldmatrix, 4 words apart mod 32 banks, so the 8
//     row addresses of a matrix do not conflict; a step's fragments are
//     loaded before its products.
//  3. Asynchronous staging in the input dtype.  16-byte cp.async copies,
//     zero-filled past S and D, into two stages: the next Q / dO tile
//     with its lse and D (dK/dV) or the next K / V tile (dQ) is in flight
//     while the warps multiply the current one.  bfloat16 stays bfloat16
//     in shared memory.  Rows that are no multiple of 16 bytes (D = 20)
//     or pointers that are not 16-byte aligned take the element-by-
//     element path.
//  4. Tiles and order.  bwd_main's blocks are 4 warps each.  The first
//     part takes dK and dV of 64 keys of one (batch row, KV head) (32 in
//     bfloat16 at DP = 64 and at DP = 256), walking the G query heads in
//     a fixed order and, for each, the query tiles of 64 rows (32 for
//     DP > 64) its keys can meet, so GQA's sum over heads stays in
//     registers; key tile 0, which meets every query under the causal
//     mask, first.  The second part takes dQ of 64 query rows of one
//     (batch row, head), walking the key tiles of 64 (32 at DP = 256, 16
//     for float32 there, for shared memory); the last query tile, which
//     meets every key under the causal mask, first.  One launch holds
//     both parts, the dK/dV blocks first, so the dQ blocks fill the SMs
//     that the causal mask's short dK/dV blocks leave.  The causal mask
//     makes the first key tile's block the longest (a dK/dV-only launch
//     took 90 us at the training shape, 24 query tiles of 64 keys), so
//     in bfloat16 at DP = 64 two warps share a 16-key strip, each taking
//     half of every stage's queries, and merge their dK and dV in warp
//     order through shared memory at the end (as the forward's key
//     splits do); float32 keeps one warp a strip, where the split
//     measured no gain.  A warp skips a tile pair whose pairs the masks
//     all drop, and masks only a tile that crosses the diagonal, the
//     window's edge or S.  At the training shape (bfloat16) the grid is
//     16 key tiles x 8 x 5 = 640 dK/dV blocks and 8 x 8 x 15 = 960 dQ
//     blocks of 128 threads, 55 KB of shared memory each and at most 170
//     registers a thread (kMinBlocks), so 3 blocks an SM: 396 resident
//     on 132 SMs, the heaviest dK/dV blocks first and the dQ blocks as
//     SMs free up.  bwd_delta runs before it, 8 lanes a row with 16-byte
//     loads.
//  5. D = 256.  A warp's dK and dV accumulators of 16 keys x 256 dims
//     would take 256 float32 registers a thread, more than the 255
//     allowed.  So at DP = 256 two warps share a 16-key strip: each
//     computes p^T and ds^T for half the stage's queries, both go through
//     shared memory (in the accumulator layout, a lane's word apart), and
//     each warp then accumulates dK and dV over all the stage's queries
//     for its half of the dims.  This keeps every sum in registers and in
//     one fixed order, where accumulating in shared memory would add a
//     read and a write of the accumulators for every tile pair.
//  6. Straight-line warp code.  The warps are latency-bound (few warps
//     an SM, each a chain of MMAs, loads and exponentials), and a branch
//     ends the window in which the compiler interleaves them.  So the
//     softcap is a template flag (its tanh and (1 - t^2) or nothing), the
//     masks' test is one uniform branch a tile pair around two copies of
//     the p / ds loop, and the copy loops run a fixed count a thread.
// D is padded with zeros to DP = 64, 128 or 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // the H100's 227 KB a block may opt into
constexpr int kDeltaThreads = 256;

template <typename T, int DP>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int LD = kF32 ? DP + 4 : DP + 8;  // elements a row
  static constexpr int kWarps = 4;  // a block, of either part
  // blocks an SM the registers must allow (bfloat16 at DP = 64: 3)
  static constexpr int kMinBlocks = !kF32 && DP == 64 ? 3 : 1;
  // dK/dV: a 16-key strip takes WS warps at DP = 256, each accumulating
  // half the dims, and QS in bfloat16 at DP = 64, each taking half of
  // every stage's queries (their sums merged at the end)
  static constexpr int WS = DP == 256 ? 2 : 1;
  static constexpr int QS = !kF32 && DP == 64 ? 2 : 1;
  static constexpr int BK = 16 * kWarps / (WS * QS);  // keys of a block
  static constexpr int BQ = DP == 64 ? 64 : 32;  // query rows of a stage
  // dQ: a warp to a 16-row query strip
  static constexpr int BQQ = 16 * kWarps;  // query rows of a block
  // keys of a stage
  static constexpr int BKQ = DP < 256 ? 64 : kF32 ? 16 : 32;
};

template <typename T, int DP>
constexpr size_t kv_smem() {
  using C = Cfg<T, DP>;
  // (QS > 1: the merge of the query halves reuses the first bytes)
  static_assert(sizeof(T) * (2 * C::BK + 4 * C::BQ) * C::LD >=
                    sizeof(float) * C::kWarps * (DP / 8) * 4 * 32,
                "the merge's slots");
  return sizeof(T) * (2 * C::BK + 4 * C::BQ) * C::LD +
         sizeof(float) * 4 * C::BQ +
         (C::WS > 1 ? sizeof(float) * (C::kWarps / C::WS) * 2 *
                          (C::BQ / 8) * 4 * 32
                    : 0);
}
template <typename T, int DP>
constexpr size_t q_smem() {
  using C = Cfg<T, DP>;
  return sizeof(T) * (2 * C::BQQ + 4 * C::BKQ) * C::LD;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi rounded to TF32 half away from zero, lo the rest, of
// which the MMA reads the top 19 bits (TF32)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// the split's three products of a.b into d
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the A fragment of a 16 x 16 tile of the m16n8k16 product from its
// float32 accumulator layout: column groups j (columns 0-7) and j + 1
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}
// the A fragment of a 16 x 8 tile of the m16n8k8 product from its
// accumulator layout, split: the 8 columns in the order (0, 2, 4, 6, 1,
// 3, 5, 7), which the B rows read with it follow
__device__ __forceinline__ void split_a(uint32_t (&h)[4], uint32_t (&l)[4],
                                        const float (&c)[4]) {
  split(c[0], h[0], l[0]);  // row g, column 2t
  split(c[2], h[1], l[1]);  // row g + 8, column 2t
  split(c[1], h[2], l[2]);  // row g, column 2t + 1
  split(c[3], h[3], l[3]);  // row g + 8, column 2t + 1
}
// four 8x8 bfloat16 matrices: lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// the same, transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// a lane's offsets into a row-major 16 x 16 bfloat16 tile for ldsm_x4:
// as an A operand (rows 0-7 | 8-15 of dims 0-7, then of dims 8-15) or as
// the B operand of two 8-row groups (dims 0-7 | 8-15 of rows 0-7, then
// of rows 8-15); with .trans the second gives B from a tile whose rows
// are the product's k
template <int LD>
__device__ __forceinline__ int a_off(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
}

// Copy ROWS rows of DP elements into shared memory (LD elements a row)
// with the block's NT threads: row r comes from row_ptr(r), or is zero
// where that is null; dims past D are zero.  With vec, 16-byte cp.async
// copies (D * sizeof(T) % 16 == 0 and 16-byte aligned rows), a thread
// taking one 16-byte column of every (NT / chunks a row)-th row, a fixed
// count of copies (the loop unrolled), the zero-filled ones given the
// valid global address `any`; else element by element.
template <typename T, int DP, int LD, int NT, int ROWS, typename RowPtr>
__device__ __forceinline__ void load_rows(T* dst, int D, bool vec,
                                          const T* any, RowPtr row_ptr) {
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int CPR = DP / VEC;  // 16-byte chunks a row
    static_assert(NT % CPR == 0 && ROWS % (NT / CPR) == 0,
                  "a thread keeps its column, and as many rows as another");
    const int d = (threadIdx.x % CPR) * VEC;
    const int r0 = threadIdx.x / CPR;
#pragma unroll
    for (int n = 0; n < ROWS / (NT / CPR); ++n) {
      const int r = r0 + n * (NT / CPR);
      const T* src = row_ptr(r);
      const bool ok = src != nullptr && d < D;
      cp_async16(dst + r * LD + d, ok ? src + d : any, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP;
      const int d = i % DP;
      const T* src = row_ptr(r);
      dst[r * LD + d] = src != nullptr && d < D ? src[d] : zero<T>();
    }
  }
}

// p and ds of an accumulator element from s (q . k) and dp (dO . v);
// lse and delta of its query row; keep: whether the masks keep the pair;
// kCap: a softcap (sc = scale / cap, c2 = cap log2(e))
template <bool kCap>
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse,
                                     float dlt, bool keep, float scale,
                                     float sl2, float sc, float c2) {
  float x, t = 0.0f;
  if constexpr (kCap) {
    t = tanhf(s * sc);
    x = c2 * t;
  } else {
    x = s * sl2;
  }
  const float p = keep ? ex2(x - lse) : 0.0f;
  float ds = p * (dp - dlt);
  if constexpr (kCap) ds *= 1.0f - t * t;
  s = p;
  dp = ds * scale;
}

__device__ __forceinline__ bool keeps(int qi, int kj, int S, int causal,
                                      int window) {
  bool keep = qi < S && kj < S;
  if (causal) keep = keep && kj <= qi;
  if (window > 0) keep = keep && kj > qi - window;
  return keep;
}

// D_i = dO_i . o_i, 8 lanes a (b, s, h) row: 16-byte loads with vec,
// else element by element; each lane's part summed in order, then the
// 8 parts in a fixed butterfly
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ delta, int B, int S, int H, int D,
              int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kDeltaThreads / 8) + threadIdx.x / 8;
  const int l8 = threadIdx.x % 8;
  const bool valid = row < static_cast<long long>(B) * S * H;
  float acc = 0.0f;
  if (valid) {
    const T* orow = o + row * D;
    const T* grow = dout + row * D;
    if (vec) {
      for (int d = VEC * l8; d < D; d += 8 * VEC) {
        const uint4 a = *reinterpret_cast<const uint4*>(orow + d);
        const uint4 c = *reinterpret_cast<const uint4*>(grow + d);
        const T* x = reinterpret_cast<const T*>(&a);
        const T* y = reinterpret_cast<const T*>(&c);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc += to_f(x[e]) * to_f(y[e]);
      }
    } else {
      for (int d = l8; d < D; d += 8) acc += to_f(orow[d]) * to_f(grow[d]);
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off *= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && l8 == 0) {
    const int h = static_cast<int>(row % H);
    const long long bs = row / H;  // b S + s
    const int s = static_cast<int>(bs % S);
    const int b = static_cast<int>(bs / S);
    delta[(static_cast<size_t>(b) * H + h) * S + s] = acc;
  }
}

// dK and dV of one block's keys (block index blk of the dK/dV part)
template <typename T, int DP, bool kCap>
__device__ __forceinline__ void bwd_dkdv(
    unsigned char* smem, int blk, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int B, int S, int H, int KV, int D, float scale, int causal, int window,
    float softcap, int vec) {
  using C = Cfg<T, DP>;
  constexpr int LD = C::LD;
  constexpr int BK = C::BK;
  constexpr int BQ = C::BQ;
  constexpr int WS = C::WS;
  constexpr int QS = C::QS;
  constexpr bool kF32 = C::kF32;
  constexpr int NJ = BQ / 8;    // 8-query column groups of a stage
  constexpr int NJW = NJ / (WS * QS);  // those a warp computes p and ds of
  constexpr int DW = DP / WS;   // dims a warp accumulates dK and dV of
  constexpr int ND = DW / 8;
  constexpr int NT = 32 * C::kWarps;  // threads a block
  static_assert(kF32 || (NJW % 2 == 0 && ND % 2 == 0),
                "a bfloat16 step takes 16 queries and 16 dims");
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BK * LD;
  T* sQ0 = sV + BK * LD;  // stage s: Q at sQ0 + 2 s BQ LD, dO after it
  // stage s: lse at sL0 + 2 s BQ, delta after it
  float* sL0 = reinterpret_cast<float*>(sQ0 + 4 * BQ * LD);
  float* sX = sL0 + 4 * BQ;  // WS > 1: p and ds of each strip

  const int G = H / KV;
  const int nqt = (S + BQ - 1) / BQ;
  const int per = B * KV;
  // key tile 0 first: under the causal mask it meets every query tile
  const int kt = blk / per;
  const int rest = blk % per;
  const int b = rest / KV;
  const int kvh = rest % KV;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int strip = warp / (WS * QS);
  const int part = warp % (WS * QS);  // the warp's share of the strip
  const int j0 = part * NJW;          // its first query group of a stage
  const int dim0 = WS > 1 ? part * DW : 0;  // its first dim of dK and dV
  const int kw0 = k0 + 16 * strip;    // its first key
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(kvh) * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  // query tiles that can meet a key of [k0, k0 + BK), for each of the G
  // heads in turn: the block's items
  const int k_last = min(k0 + BK, S) - 1;
  const int qt_lo = causal ? k0 / BQ : 0;
  int qt_hi = nqt - 1;
  if (window > 0) qt_hi = min(qt_hi, (k_last + window - 1) / BQ);
  const int nq = qt_hi - qt_lo + 1;
  const int n_items = G * nq;

  load_rows<T, DP, LD, NT, BK>(sK, D, vec, kb, [&](int r) -> const T* {
    return k0 + r < S ? kb + (k0 + r) * kv_stride : nullptr;
  });
  load_rows<T, DP, LD, NT, BK>(sV, D, vec, vb, [&](int r) -> const T* {
    return k0 + r < S ? vb + (k0 + r) * kv_stride : nullptr;
  });
  auto load_item = [&](int it, int st) {
    const int h = kvh * G + it / nq;
    const int q0 = (qt_lo + it % nq) * BQ;
    const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                         static_cast<size_t>(h) * D;
    const T* qb = q + q_off;
    const T* ob = dout + q_off;
    T* sQ = sQ0 + 2 * st * BQ * LD;
    load_rows<T, DP, LD, NT, BQ>(sQ, D, vec, qb, [&](int r) -> const T* {
      return q0 + r < S ? qb + (q0 + r) * q_stride : nullptr;
    });
    load_rows<T, DP, LD, NT, BQ>(sQ + BQ * LD, D, vec, ob,
                                 [&](int r) -> const T* {
                                   return q0 + r < S ? ob + (q0 + r) * q_stride
                                                     : nullptr;
                                 });
    const size_t row = (static_cast<size_t>(b) * H + h) * S + q0;
    float* sL = sL0 + 2 * st * BQ;  // lse, then delta
    for (int i = threadIdx.x; i < 2 * BQ; i += NT) {
      const int r = i % BQ;
      const bool ok = q0 + r < S;
      cp_async4(sL + i, ok ? (i < BQ ? lse : delta) + row + r : lse,
                ok ? 4 : 0);
    }
  };
  load_item(0, 0);
  cp_commit();

  const float sl2 = scale * kLog2e;
  const float sc = softcap > 0.0f ? scale / softcap : 0.0f;
  const float c2 = softcap * kLog2e;
  float dva[ND][4], dka[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[i][e] = dka[i][e] = 0.0f;

  // dV += p^T dO and dK += ds^T Q over the stage's query groups [jb, jb +
  // N), for the warp's dims
  auto dvdk = [&](const auto& pa, const auto& da, int jb, const T* sQ,
                  const T* sO) {
    constexpr int N =
        std::extent<std::remove_reference_t<decltype(pa)>>::value;
    if constexpr (kF32) {
      const float* orow = sO + (8 * jb + 2 * t) * LD + g + dim0;
      const float* qrow = sQ + (8 * jb + 2 * t) * LD + g + dim0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        split_a(ph, pl, pa[j]);
        split_a(dh, dl, da[j]);
        const float* oj = orow + 8 * j * LD;
        const float* qj = qrow + 8 * j * LD;
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          uint32_t bh[2], bl[2];
          split(oj[8 * i], bh[0], bl[0]);       // query 2t, dim g
          split(oj[LD + 8 * i], bh[1], bl[1]);  // query 2t + 1
          mma3(dva[i], ph, pl, bh, bl);
          split(qj[8 * i], bh[0], bl[0]);
          split(qj[LD + 8 * i], bh[1], bl[1]);
          mma3(dka[i], dh, dl, bh, bl);
        }
      }
    } else {
      const T* orow = sO + 8 * jb * LD + a_off<LD>(lane) + dim0;
      const T* qrow = sQ + 8 * jb * LD + a_off<LD>(lane) + dim0;
#pragma unroll
      for (int jj = 0; jj < N / 2; ++jj) {
        uint32_t ap[4], ad[4];
        pack_a(ap, pa[2 * jj], pa[2 * jj + 1]);
        pack_a(ad, da[2 * jj], da[2 * jj + 1]);
#pragma unroll
        for (int i = 0; i < ND; i += 2) {
          // (queries 0-7 | 8-15) x (dims 0-7 | 8-15), transposed
          uint32_t ro[4], rq[4];
          ldsm_x4_trans(ro, orow + 16 * jj * LD + 8 * i);
          ldsm_x4_trans(rq, qrow + 16 * jj * LD + 8 * i);
          const uint32_t o0[2] = {ro[0], ro[1]};
          const uint32_t o1[2] = {ro[2], ro[3]};
          const uint32_t q0_[2] = {rq[0], rq[1]};
          const uint32_t q1_[2] = {rq[2], rq[3]};
          mma_bf16(dva[i], ap, o0);
          mma_bf16(dva[i + 1], ap, o1);
          mma_bf16(dka[i], ad, q0_);
          mma_bf16(dka[i + 1], ad, q1_);
        }
      }
    }
  };

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    if (it + 1 < n_items) load_item(it + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();  // every group but the newest: item it has arrived
    __syncthreads();
    const int q0 = (qt_lo + it % nq) * BQ;
    const T* sQ = sQ0 + 2 * st * BQ * LD;
    const T* sO = sQ + BQ * LD;
    const float* sL = sL0 + 2 * st * BQ;
    const float* sD = sL + BQ;
    // the queries the warp's strip must meet: its own (QS > 1), else the
    // stage's (WS > 1: the strip's warps trade p and ds)
    constexpr int QW = QS > 1 ? 8 * NJW : BQ;
    const int q_lo = q0 + (QS > 1 ? 8 * j0 : 0);
    const int q_hi = min(q_lo + QW, S) - 1;
    // the strip meets one of them; some pair is masked
    const bool active = kw0 < S && q_lo < S && (!causal || kw0 <= q_hi) &&
                        (window <= 0 || min(kw0 + 15, S - 1) > q_lo - window);
    const bool edge = q_lo + QW > S || kw0 + 16 > S ||
                      (causal && kw0 + 15 > q_lo) ||
                      (window > 0 && kw0 <= q_hi - window);
    if (active) {
      // S^T = K Q^T and dP^T = V dO^T with the strip's 16 keys as rows,
      // then p^T and ds^T, then (WS = 1) their products
      float sacc[NJW][4], pacc[NJW][4];
#pragma unroll
      for (int j = 0; j < NJW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = pacc[j][e] = 0.0f;
      if constexpr (kF32) {
        const float* ka = sK + (16 * strip + g) * LD + t;
        const float* va = sV + (16 * strip + g) * LD + t;
        const float* qa = sQ + (8 * j0 + g) * LD + t;
        const float* oa = sO + (8 * j0 + g) * LD + t;
#pragma unroll 2
        for (int kd = 0; kd < DP; kd += 8) {
          uint32_t kh[4], kl[4], vh[4], vl[4];
          split(ka[kd], kh[0], kl[0]);
          split(ka[8 * LD + kd], kh[1], kl[1]);
          split(ka[kd + 4], kh[2], kl[2]);
          split(ka[8 * LD + kd + 4], kh[3], kl[3]);
          split(va[kd], vh[0], vl[0]);
          split(va[8 * LD + kd], vh[1], vl[1]);
          split(va[kd + 4], vh[2], vl[2]);
          split(va[8 * LD + kd + 4], vh[3], vl[3]);
#pragma unroll
          for (int j = 0; j < NJW; ++j) {
            uint32_t bh[2], bl[2];
            split(qa[8 * j * LD + kd], bh[0], bl[0]);
            split(qa[8 * j * LD + kd + 4], bh[1], bl[1]);
            mma3(sacc[j], kh, kl, bh, bl);
            split(oa[8 * j * LD + kd], bh[0], bl[0]);
            split(oa[8 * j * LD + kd + 4], bh[1], bl[1]);
            mma3(pacc[j], vh, vl, bh, bl);
          }
        }
      } else {
        const T* ka = sK + 16 * strip * LD + a_off<LD>(lane);
        const T* va = sV + 16 * strip * LD + a_off<LD>(lane);
        const T* qb_ = sQ + 8 * j0 * LD + b_off<LD>(lane);
        const T* ob_ = sO + 8 * j0 * LD + b_off<LD>(lane);
#pragma unroll
        for (int kd = 0; kd < DP; kd += 16) {
          // the step's fragments first, then its products
          uint32_t ak[4], av[4], bq[NJW / 2][4], bo[NJW / 2][4];
          ldsm_x4(ak, ka + kd);
          ldsm_x4(av, va + kd);
#pragma unroll
          for (int jj = 0; jj < NJW / 2; ++jj) {
            ldsm_x4(bq[jj], qb_ + 16 * jj * LD + kd);
            ldsm_x4(bo[jj], ob_ + 16 * jj * LD + kd);
          }
#pragma unroll
          for (int jj = 0; jj < NJW / 2; ++jj) {
            const uint32_t b0[2] = {bq[jj][0], bq[jj][1]};
            const uint32_t b1[2] = {bq[jj][2], bq[jj][3]};
            const uint32_t c0[2] = {bo[jj][0], bo[jj][1]};
            const uint32_t c1[2] = {bo[jj][2], bo[jj][3]};
            mma_bf16(sacc[2 * jj], ak, b0);
            mma_bf16(sacc[2 * jj + 1], ak, b1);
            mma_bf16(pacc[2 * jj], av, c0);
            mma_bf16(pacc[2 * jj + 1], av, c1);
          }
        }
      }
      // p^T and ds^T: lse and delta along the columns (queries); the
      // masks tested only where the stage crosses one of their edges
      auto pds = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < NJW; ++j) {
          const int c = 8 * (j0 + j) + 2 * t;  // the stage's query of e = 0
          const float2 l2 = *reinterpret_cast<const float2*>(sL + c);
          const float2 d2 = *reinterpret_cast<const float2*>(sD + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool keep =
                !decltype(masked)::value ||
                keeps(q0 + c + (e & 1), kw0 + g + 8 * (e >> 1), S, causal,
                      window);
            p_ds<kCap>(sacc[j][e], pacc[j][e], (e & 1) ? l2.y : l2.x,
                       (e & 1) ? d2.y : d2.x, keep, scale, sl2, sc, c2);
          }
        }
      };
      if (edge)
        pds(std::true_type{});
      else
        pds(std::false_type{});
      if constexpr (WS == 1) {
        dvdk(sacc, pacc, j0, sQ, sO);
      } else {
        // the strip's warps trade their halves of p^T and ds^T:
        // [j][e][lane]
        float* xs = sX + strip * 2 * NJ * 4 * 32 + lane;
#pragma unroll
        for (int j = 0; j < NJW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            xs[((j0 + j) * 4 + e) * 32] = sacc[j][e];
            xs[((NJ + j0 + j) * 4 + e) * 32] = pacc[j][e];
          }
      }
    }
    if constexpr (WS > 1) {
      __syncthreads();
      if (active) {
        const float* xs = sX + strip * 2 * NJ * 4 * 32 + lane;
        float pf[NJ][4], df[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pf[j][e] = xs[(j * 4 + e) * 32];
            df[j][e] = xs[((NJ + j) * 4 + e) * 32];
          }
        dvdk(pf, df, 0, sQ, sO);
      }
    }
    __syncthreads();  // the stage is consumed before it is loaded again
  }

  if constexpr (QS > 1) {
    // the strip's query halves merge in warp order: part 1's sums into
    // part 0's, through the stage buffers (the loop has left them)
    float* mx = reinterpret_cast<float*>(smem) + strip * 2 * ND * 4 * 32 +
                lane;
    if (part == 1) {
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mx[(i * 4 + e) * 32] = dva[i][e];
          mx[((ND + i) * 4 + e) * 32] = dka[i][e];
        }
    }
    __syncthreads();
    if (part == 1) return;
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dva[i][e] += mx[(i * 4 + e) * 32];
        dka[i][e] += mx[((ND + i) * 4 + e) * 32];
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kw0 + g + 8 * r;
    if (kj >= S) continue;
    T* dkrow = dk + kv_off + static_cast<size_t>(kj) * kv_stride;
    T* dvrow = dv + kv_off + static_cast<size_t>(kj) * kv_stride;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = dim0 + 8 * i + 2 * t;
      if (d < D) {
        store(dkrow + d, dka[i][2 * r]);
        store(dvrow + d, dva[i][2 * r]);
      }
      if (d + 1 < D) {
        store(dkrow + d + 1, dka[i][2 * r + 1]);
        store(dvrow + d + 1, dva[i][2 * r + 1]);
      }
    }
  }
}

// dQ of one block's query rows (block index blk of the dQ part)
template <typename T, int DP, bool kCap>
__device__ __forceinline__ void bwd_dq(
    unsigned char* smem, int blk, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int B, int S, int H,
    int KV, int D, float scale, int causal, int window, float softcap,
    int vec) {
  using C = Cfg<T, DP>;
  constexpr int LD = C::LD;
  constexpr int BQQ = C::BQQ;
  constexpr int BKQ = C::BKQ;
  constexpr bool kF32 = C::kF32;
  constexpr int NJ = BKQ / 8;  // 8-key column groups of a stage
  static_assert(kF32 || NJ % 2 == 0, "a bfloat16 step takes 16 keys");
  constexpr int ND = DP / 8;
  constexpr int NT = 32 * C::kWarps;  // threads a block
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + BQQ * LD;
  T* sK0 = sO + BQQ * LD;  // stage s: K at sK0 + 2 s BKQ LD, V after it

  const int G = H / KV;
  const int nqt = (S + BQQ - 1) / BQQ;
  const int per = B * H;
  // heaviest first: under the causal mask the last query tile meets
  // every key tile
  const int u = blk / per;
  const int qt = causal ? nqt - 1 - u : u;
  const int rest = blk % per;
  const int b = rest / H;
  const int h = rest % H;
  const int kvh = h / G;
  const int q0 = qt * BQQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wq0 = q0 + 16 * warp;  // the warp's first query row
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                       static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(kvh) * D;
  const T* qb = q + q_off;
  const T* ob = dout + q_off;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  // key tiles that hold a key some row of the block keeps
  const int q_last = min(q0 + BQQ, S) - 1;
  const int k_stop = causal ? q_last + 1 : S;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_first = (k_first / BKQ) * BKQ;
  const int n_tiles = (k_stop - kt_first + BKQ - 1) / BKQ;

  load_rows<T, DP, LD, NT, BQQ>(sQ, D, vec, qb, [&](int r) -> const T* {
    return q0 + r < S ? qb + (q0 + r) * q_stride : nullptr;
  });
  load_rows<T, DP, LD, NT, BQQ>(sO, D, vec, ob, [&](int r) -> const T* {
    return q0 + r < S ? ob + (q0 + r) * q_stride : nullptr;
  });
  auto load_kv = [&](int it, int st) {
    const int c0 = kt_first + it * BKQ;
    T* sK = sK0 + 2 * st * BKQ * LD;
    load_rows<T, DP, LD, NT, BKQ>(sK, D, vec, kb, [&](int r) -> const T* {
      return c0 + r < S ? kb + (c0 + r) * kv_stride : nullptr;
    });
    load_rows<T, DP, LD, NT, BKQ>(
        sK + BKQ * LD, D, vec, vb, [&](int r) -> const T* {
          return c0 + r < S ? vb + (c0 + r) * kv_stride : nullptr;
        });
  };
  load_kv(0, 0);
  cp_commit();

  // the thread's rows wq0 + g and wq0 + g + 8: lse and delta
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + g + 8 * r;
    const size_t at = (static_cast<size_t>(b) * H + h) * S + qi;
    lr[r] = qi < S ? lse[at] : 0.0f;
    dr[r] = qi < S ? delta[at] : 0.0f;
  }
  // the keys the warp's rows may keep
  const int w_last = min(wq0 + 15, S - 1);
  const int key_lo = window > 0 ? max(0, wq0 - window + 1) : 0;
  const int key_hi = causal ? w_last : S - 1;
  const float sl2 = scale * kLog2e;
  const float sc = softcap > 0.0f ? scale / softcap : 0.0f;
  const float c2 = softcap * kLog2e;

  float dqa[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[i][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) load_kv(it + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int c0 = kt_first + it * BKQ;  // the stage's keys: [c0, c1)
    const int c1 = c0 + BKQ;
    const T* sK = sK0 + 2 * st * BKQ * LD;
    const T* sV = sK + BKQ * LD;
    if (wq0 < S && max(c0, key_lo) <= min(c1 - 1, key_hi)) {
      const bool edge = c1 > S || (causal && c1 - 1 > wq0) ||
                        (window > 0 && c0 <= w_last - window);
      // S = Q K^T and dP = dO V^T with the strip's 16 rows, p and ds,
      // then dQ += ds K
      float sacc[NJ][4], pacc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = pacc[j][e] = 0.0f;
      if constexpr (kF32) {
        const float* qa = sQ + (16 * warp + g) * LD + t;
        const float* oa = sO + (16 * warp + g) * LD + t;
        const float* kr = sK + g * LD + t;
        const float* vr = sV + g * LD + t;
#pragma unroll 2
        for (int kd = 0; kd < DP; kd += 8) {
          uint32_t qh[4], ql[4], oh[4], ol[4];
          split(qa[kd], qh[0], ql[0]);
          split(qa[8 * LD + kd], qh[1], ql[1]);
          split(qa[kd + 4], qh[2], ql[2]);
          split(qa[8 * LD + kd + 4], qh[3], ql[3]);
          split(oa[kd], oh[0], ol[0]);
          split(oa[8 * LD + kd], oh[1], ol[1]);
          split(oa[kd + 4], oh[2], ol[2]);
          split(oa[8 * LD + kd + 4], oh[3], ol[3]);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            uint32_t bh[2], bl[2];
            split(kr[8 * j * LD + kd], bh[0], bl[0]);
            split(kr[8 * j * LD + kd + 4], bh[1], bl[1]);
            mma3(sacc[j], qh, ql, bh, bl);
            split(vr[8 * j * LD + kd], bh[0], bl[0]);
            split(vr[8 * j * LD + kd + 4], bh[1], bl[1]);
            mma3(pacc[j], oh, ol, bh, bl);
          }
        }
      } else {
        const T* qa = sQ + 16 * warp * LD + a_off<LD>(lane);
        const T* oa = sO + 16 * warp * LD + a_off<LD>(lane);
        const T* kr = sK + b_off<LD>(lane);
        const T* vr = sV + b_off<LD>(lane);
#pragma unroll
        for (int kd = 0; kd < DP; kd += 16) {
          // the step's fragments first, then its products
          uint32_t aq[4], ao[4], bk[NJ / 2][4], bv[NJ / 2][4];
          ldsm_x4(aq, qa + kd);
          ldsm_x4(ao, oa + kd);
#pragma unroll
          for (int jj = 0; jj < NJ / 2; ++jj) {
            ldsm_x4(bk[jj], kr + 16 * jj * LD + kd);
            ldsm_x4(bv[jj], vr + 16 * jj * LD + kd);
          }
#pragma unroll
          for (int jj = 0; jj < NJ / 2; ++jj) {
            const uint32_t b0[2] = {bk[jj][0], bk[jj][1]};
            const uint32_t b1[2] = {bk[jj][2], bk[jj][3]};
            const uint32_t c0_[2] = {bv[jj][0], bv[jj][1]};
            const uint32_t c1_[2] = {bv[jj][2], bv[jj][3]};
            mma_bf16(sacc[2 * jj], aq, b0);
            mma_bf16(sacc[2 * jj + 1], aq, b1);
            mma_bf16(pacc[2 * jj], ao, c0_);
            mma_bf16(pacc[2 * jj + 1], ao, c1_);
          }
        }
      }
      // p and ds: lse and delta along the rows; the masks tested only
      // where the stage crosses one of their edges
      auto pds = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool keep =
                !decltype(masked)::value ||
                keeps(wq0 + g + 8 * (e >> 1), c0 + 8 * j + 2 * t + (e & 1),
                      S, causal, window);
            p_ds<kCap>(sacc[j][e], pacc[j][e], lr[e >> 1], dr[e >> 1],
                       keep, scale, sl2, sc, c2);
          }
      };
      if (edge)
        pds(std::true_type{});
      else
        pds(std::false_type{});
      // dQ += ds K
      if constexpr (kF32) {
        const float* kt_ = sK + 2 * t * LD + g;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t ah[4], al[4];
          split_a(ah, al, pacc[j]);
          const float* kj_ = kt_ + 8 * j * LD;
#pragma unroll
          for (int i = 0; i < ND; ++i) {
            uint32_t bh[2], bl[2];
            split(kj_[8 * i], bh[0], bl[0]);       // key 2t, dim g
            split(kj_[LD + 8 * i], bh[1], bl[1]);  // key 2t + 1
            mma3(dqa[i], ah, al, bh, bl);
          }
        }
      } else {
        const T* kt_ = sK + a_off<LD>(lane);
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          uint32_t a[4];
          pack_a(a, pacc[2 * jj], pacc[2 * jj + 1]);
#pragma unroll
          for (int i = 0; i < ND; i += 2) {
            // (keys 0-7 | 8-15) x (dims 0-7 | 8-15), transposed
            uint32_t r[4];
            ldsm_x4_trans(r, kt_ + 16 * jj * LD + 8 * i);
            const uint32_t b0[2] = {r[0], r[1]};
            const uint32_t b1[2] = {r[2], r[3]};
            mma_bf16(dqa[i], a, b0);
            mma_bf16(dqa[i + 1], a, b1);
          }
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is loaded again
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + g + 8 * r;
    if (qi >= S) continue;
    T* row = dq + q_off + static_cast<size_t>(qi) * q_stride;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = 8 * i + 2 * t;
      if (d < D) store(row + d, dqa[i][2 * r]);
      if (d + 1 < D) store(row + d + 1, dqa[i][2 * r + 1]);
    }
  }
}

// one launch for both: the dK/dV blocks first, then the dQ blocks, each
// part heaviest first
template <typename T, int DP, bool kCap>
__global__ void __launch_bounds__(32 * Cfg<T, DP>::kWarps,
                                  Cfg<T, DP>::kMinBlocks)
    bwd_main(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
             int B, int S, int H, int KV, int D, float scale, int causal,
             int window, float softcap, int vec, int kv_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < kv_blocks)
    bwd_dkdv<T, DP, kCap>(smem, blk, q, k, v, dout, lse, delta, dk, dv, B, S, H,
                    KV, D, scale, causal, window, softcap, vec);
  else
    bwd_dq<T, DP, kCap>(smem, blk - kv_blocks, q, k, v, dout, lse, delta, dq, B,
                  S, H, KV, D, scale, causal, window, softcap, vec);
}

template <typename T, int DP, bool kCap>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int S, int H, int KV, int D,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  using C = Cfg<T, DP>;
  constexpr size_t bytes = kv_smem<T, DP>() > q_smem<T, DP>()
                               ? kv_smem<T, DP>()
                               : q_smem<T, DP>();
  static_assert(bytes <= kMaxSmem, "a block's shared memory");
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_main<T, DP, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const uintptr_t all =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
      reinterpret_cast<uintptr_t>(dout);
  const int vec = (D * sizeof(T)) % 16 == 0 && all % 16 == 0;
  const long long rows = static_cast<long long>(B) * S * H;
  const long long delta_blocks =
      (rows + kDeltaThreads / 8 - 1) / (kDeltaThreads / 8);
  const long long kv_blocks =
      static_cast<long long>((S + C::BK - 1) / C::BK) * B * KV;
  const long long q_blocks =
      static_cast<long long>((S + C::BQQ - 1) / C::BQQ) * B * H;
  if (delta_blocks > 0x7fffffffLL || kv_blocks + q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  bwd_delta<T><<<static_cast<unsigned>(delta_blocks), kDeltaThreads, 0,
                 stream>>>(static_cast<const T*>(o),
                           static_cast<const T*>(dout), delta, B, S, H, D,
                           vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_main<T, DP, kCap><<<static_cast<unsigned>(kv_blocks + q_blocks),
                    32 * C::kWarps, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), B, S,
      H, KV, D, scale, causal, window, softcap, vec,
      static_cast<int>(kv_blocks));
  return static_cast<int>(cudaGetLastError());
}

// the softcap's path chosen at compile time, so the p and ds loops have
// no branch on it
template <typename T, int DP>
int launch_cap(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int S, int H, int KV, int D,
               float scale, int causal, int window, float softcap,
               cudaStream_t st) {
  if (softcap > 0.0f)
    return launch<T, DP, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               S, H, KV, D, scale, causal, window, softcap,
                               st);
  return launch<T, DP, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                              H, KV, D, scale, causal, window, softcap, st);
}

template <typename T>
int launch_dp(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int B, int S, int H, int KV, int D,
              float scale, int causal, int window, float softcap,
              cudaStream_t st) {
  if (D <= 64)
    return launch_cap<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                             H, KV, D, scale, causal, window, softcap, st);
  if (D <= 128)
    return launch_cap<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                              S, H, KV, D, scale, causal, window, softcap,
                              st);
  return launch_cap<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                            H, KV, D, scale, causal, window, softcap, st);
}

}  // namespace

// C interface for ctypes.  q, o, dout, dq are device pointers to
// contiguous (B, S, H, D) tensors, k, v, dk, dv to (B, S, KV, D) ones, all
// of one dtype (0: float32, 1: bfloat16); lse is the forward's (B, H, S)
// float32 row logsumexp in log2 units and delta a (B, H, S) float32
// workspace; 1 <= D <= 256 and H % KV == 0 (the wrapper checks).  Two
// kernels run in order on `stream` (a cudaStream_t): bwd_delta, then
// bwd_main (dK and dV, and dQ).  Returns the first cudaError_t of the
// launches (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, int KV, int D, int dtype, float scale,
    int causal, int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dp<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                            H, KV, D, scale, causal, window, softcap, st);
  if (dtype == 1)
    return launch_dp<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, B, S, H, KV, D, scale, causal,
                                    window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
