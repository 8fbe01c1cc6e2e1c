// flash_attention: causal / windowed / softcapped GQA attention over a
// whole sequence (prefill), for sm_90a, on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py (_body, launched from flash_attention).  For q (B, S, H, D)
// and k, v (B, S, KV, D), query head h reads KV head h / G (G = H / KV):
//   s = (q . k) * scale;  s = cap * tanh(s / cap) if cap > 0;
//   s = NEG_INF (-2**30) where the key is masked (causal: key > query;
//       window: key <= query - window);
//   out = softmax(s) v, by the online softmax: per query row a running
//   max m, sum l and float32 accumulator, rescaled by exp(m_old - m_new)
//   for every key tile, and out = acc / max(l, 1e-30) in q's dtype.
//
// Bound: causal attention does 4 D operations per (query, key) pair that
// the masks keep (q.k and p.v), against (2 H + 2 KV) S D elements moved,
// so at the serving shapes it is bound by operations on the tensor cores.
// float32 inputs go through a 3xTF32 split (below), three TF32 products
// for each one, so their rate is the TF32 peak over 3 (495 / 3 TFLOP/s
// on an H100 SXM); bfloat16 inputs run at the bfloat16 peak (989).
//
// Design, one step for each thing that held the CUDA-core kernel back:
//  1. Tensor cores.  Both products are warp-level mma.sync tiles of 16
//     query rows: m16n8k8 TF32 for float32, m16n8k16 bfloat16 for
//     bfloat16, with float32 accumulators.  For float32 every operand x
//     is split into hi = tf32_rna(x) and lo = x - hi, and a.b is summed
//     as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (a_lo.b_lo, about 2^-22 of
//     a.b, is dropped): one TF32 product keeps 11 bits and misses the
//     2e-5 tolerance, the split about 21.  hi is rounded on the bits
//     ((x + 0x1000) & ~0x1fff, half away from zero, as cvt.rna.tf32.f32
//     for finite x, which the compiler expands with an inf check); lo
//     goes to the MMA as it is and the MMA reads its TF32 part (at most
//     2^-21 of x lost, against 2^-22 had lo been rounded, two
//     instructions a value saved).  The K and V fragments are split in
//     registers after their load from shared memory, so shared memory
//     holds one copy of each tile.  The 8 dims of a q.k step are taken
//     in the order (0, 2, 4, 6, 1, 3, 5, 7), so a lane's two Q or K
//     values are adjacent (one 8-byte load).  The logits stay in
//     registers: the accumulator of q.k is the A operand of p.v, for
//     TF32 with the 8 keys of a step in the same order, which the V
//     loads follow; for bfloat16 p is rounded to bfloat16 (the layouts
//     match as they are).  The softmax runs in log2 units (the logits
//     times log2(e)) with ex2.approx.ftz (about 2 ulp; a weight under
//     2^-126 of its row's largest is 0).  An mma.sync takes about
//     80 clocks to its result and 7 to issue on an H100
//     (benchmarks_torch/mma_rate.py), so a warp's loops have fixed trip
//     counts and no branches, and the split's small products accumulate
//     apart from a_hi.b_hi (in p.v where a warp has fewer than 16
//     output column groups): the compiler interleaves the products of
//     independent accumulators.
//  2. Asynchronous K/V.  16-byte cp.async copies, zero-filled past S and
//     past D, fill two stages of (K, V) tiles: the next tile's copies are
//     in flight while the warps multiply the current one.  Where a row is
//     no multiple of 16 bytes or a pointer is not 16-byte aligned, the
//     tiles are copied element by element (synchronous, still masked).
//  3. One K/V load per GQA group.  A block stacks `gh` query heads of one
//     KV group (gh divides G) and `nb` 16-row query strips into its warps,
//     so each K/V tile is read from memory and staged once for gh heads.
//  4. Filling the card.  Blocks take their units heaviest first (the
//     causal query tiles with the most key tiles), and KS warps split
//     the key columns of every tile of one strip; they merge their
//     (m, l, acc) through shared memory in warp order, so a result is
//     bitwise the same from call to call.  The wrapper (kernel.py:
//     tile_plan) picks (gh, nb, KS) for the shape.
// A warp skips a key tile where its columns hold no key that its rows
// keep (past the causal diagonal, before the window), and masks only the
// tiles that cross a mask's edge or S; the reference's masked logits add
// nothing once a row has seen a key it keeps, and every row keeps its
// own position.  D is padded with zeros to DP = 64, 128 or 256.  A block
// has at most 8 warps (4 at DP = 256); shared memory holds the block's Q
// rows and two stages of K and V tiles (64 keys, 32 at DP = 256), rows
// padded so that fragment loads do not conflict: up to 207 KB, so the
// launch raises the block's shared-memory limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
// -2**30, the reference's masked logit, in log2 units
constexpr float kNegInf2 = -1073741824.0f * kLog2e;
constexpr int kMaxSmem = 232448;  // the H100's 227 KB a block may opt into
// design switches, each the shipped choice; benchmarks_torch/
// kernel_steps.py builds copies with one set otherwise to time the step
constexpr bool kSplit = true;       // float32: 3xTF32 (false: one TF32)
constexpr bool kAsync = true;       // prefetch the next K/V tile
constexpr bool kHeavyFirst = true;  // units in heavy-first order

// key rows per tile, and the most warps a block may have
template <int DP>
__host__ __device__ constexpr int key_tile() {
  return DP == 256 ? 32 : 64;
}
template <int DP>
__host__ __device__ constexpr int max_warps() {
  return DP == 256 ? 4 : 8;
}

// elements a shared-memory row of Q, K and V takes: 8-byte fragment
// loads of Q and K want rows 8 words apart mod 32 banks, 4-byte ones of
// V 4 words apart; bfloat16 rows are 16-byte aligned for ldmatrix
template <typename T, int DP>
struct Lay {
  static constexpr int kQ = DP + 8;
  static constexpr int kK = DP + 8;
  static constexpr int kV = std::is_same<T, float>::value ? DP + 4 : DP + 8;
};

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
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// four 8x8 bfloat16 matrices, transposed: lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Copy `rows` rows of DP elements into shared memory (LD elements a row):
// row r comes from row_ptr(r), or is zero where that is null; dims past D
// are zero.  With vec, 16-byte cp.async copies (D * sizeof(T) % 16 == 0
// and 16-byte aligned rows), the zero-filled ones given the valid global
// address `any`; else element by element.
template <typename T, int DP, int LD, typename RowPtr>
__device__ __forceinline__ void load_rows(T* dst, int rows, int D, bool vec,
                                          const T* any, RowPtr row_ptr) {
  const int nthreads = blockDim.x;
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int CPR = DP / VEC;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < rows * CPR; i += nthreads) {
      const int r = i / CPR;
      const int d = (i % CPR) * VEC;
      const T* src = row_ptr(r);
      const bool ok = src != nullptr && d < D;
      cp_async16(dst + r * LD + d, ok ? src + d : any, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += nthreads) {
      const int r = i / DP;
      const int d = i % DP;
      const T* src = row_ptr(r);
      dst[r * LD + d] = src != nullptr && d < D ? src[d] : zero<T>();
    }
  }
}

template <typename T, int DP, int KS>
__global__ void __launch_bounds__(256, 1)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int B, int S, int H, int KV, int D,
              float scale, int causal, int window, float softcap, int gh,
              int nb, int vec) {
  constexpr int BK = key_tile<DP>();
  constexpr int NJ = BK / 8 / KS;  // 8-key column groups a warp takes
  constexpr int ND = DP / 8;       // 8-dim column groups of the output
  constexpr int LQ = Lay<T, DP>::kQ;
  constexpr int LK = Lay<T, DP>::kK;
  constexpr int LV = Lay<T, DP>::kV;
  constexpr bool kF32 = std::is_same<T, float>::value;
  // accumulators of the output: a second one for the split's small
  // products where the dim groups alone are too few independent chains
  constexpr int NO = kF32 && ND < 16 ? 2 : 1;
  static_assert(kF32 || NJ % 2 == 0, "a bfloat16 p.v step takes 16 keys");
  extern __shared__ __align__(16) unsigned char smem[];

  const int G = H / KV;
  const int M = gh * nb * 16;  // Q rows of the block
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK0 = sQ + M * LQ;  // stage s: K at sK0 + s BK (LK + LV), V after it

  // the block's unit: (query tile, batch row, KV head, head chunk)
  const int nqt = (S + 16 * nb - 1) / (16 * nb);
  const int nc = G / gh;
  int u = blockIdx.x;
  int qt;
  if (kHeavyFirst) {
    const int per = B * KV * nc;
    qt = nqt - 1 - u / per;
    u %= per;
  } else {
    qt = u % nqt;
    u /= nqt;
  }
  const int c = u % nc;
  u /= nc;
  const int kvh = u % KV;
  const int b = u / KV;
  const int q0 = qt * 16 * nb;
  const int h0 = kvh * G + c * gh;

  // warp w: key split w % KS of query strip (w / KS) % nb of head
  // h0 + w / (KS nb)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // the fragment's row group
  const int t = lane % 4;  // and its column within the group
  const int ksp = warp % KS;
  const int pair = warp / KS;  // (head, strip) of the warp
  const int strip = pair % nb;
  const int head = h0 + pair / nb;
  const int wq0 = q0 + 16 * strip;  // the warp's first query row
  const T* sQw = sQ + pair * 16 * LQ;
  const int j0 = ksp * NJ;  // the warp's first 8-key group of a tile

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const T* kb = k + static_cast<size_t>(b) * S * kv_stride +
                static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * S * kv_stride +
                static_cast<size_t>(kvh) * D;

  // key tiles that hold a key some row of the block keeps
  const int q_last = min(q0 + 16 * nb, S) - 1;
  const int k_stop = causal ? q_last + 1 : S;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_first = (k_first / BK) * BK;
  const int n_tiles = (k_stop - kt_first + BK - 1) / BK;

  auto load_kv = [&](int it, int stage) {
    const int kt = kt_first + it * BK;
    T* sK = sK0 + stage * BK * (LK + LV);
    T* sV = sK + BK * LK;
    load_rows<T, DP, LK>(sK, BK, D, vec, kb, [&](int r) -> const T* {
      return kt + r < S ? kb + (kt + r) * kv_stride : nullptr;
    });
    load_rows<T, DP, LV>(sV, BK, D, vec, vb, [&](int r) -> const T* {
      return kt + r < S ? vb + (kt + r) * kv_stride : nullptr;
    });
  };

  load_rows<T, DP, LQ>(sQ, M, D, vec, q, [&](int r) -> const T* {
    const int p = r / 16;
    const int s = q0 + 16 * (p % nb) + r % 16;
    const int h = h0 + p / nb;
    return s < S ? q + (static_cast<size_t>(b) * S + s) * q_stride +
                       static_cast<size_t>(h) * D
                 : nullptr;
  });
  load_kv(0, 0);
  cp_commit();

  // the keys the warp's rows may keep, and its thread's two rows
  const int w_last = min(wq0 + 15, S - 1);
  const int key_lo = window > 0 ? max(0, wq0 - window + 1) : 0;
  const int key_hi = causal ? w_last : S - 1;
  const int qi0 = wq0 + g;  // the thread's rows: qi0 and qi0 + 8
  const float sl2 = scale * kLog2e;

  float m[2] = {kNegInf2, kNegInf2};
  float l[2] = {0.0f, 0.0f};
  float oacc[NO][ND][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][i][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    int stage = 0;
    if (kAsync) {
      stage = it & 1;
      if (it + 1 < n_tiles) load_kv(it + 1, stage ^ 1);
      cp_commit();
      cp_wait<1>();  // every group but the newest: tile it has arrived
    } else {
      if (it > 0) load_kv(it, 0);
      cp_commit();
      cp_wait<0>();
    }
    __syncthreads();
    // the warp's keys of this tile: [c0, c1)
    const int c0 = kt_first + it * BK + 8 * j0;
    const int c1 = c0 + 8 * NJ;
    if (wq0 < S && max(c0, key_lo) <= min(c1 - 1, key_hi)) {
      const T* sK = sK0 + stage * BK * (LK + LV) + 8 * j0 * LK;
      const T* sV = sK0 + stage * BK * (LK + LV) + BK * LK + 8 * j0 * LV;
      float sacc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.0f;

      // s = q k^T
      if constexpr (kF32) {
        float small[NJ][4];  // the split's small products
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) small[j][e] = 0.0f;
#pragma unroll 2
        for (int kd = 0; kd < DP; kd += 8) {
          // dims kd + 2t and kd + 2t + 1 are the step's dims t and t + 4
          const float2 qa = *reinterpret_cast<const float2*>(
              sQw + g * LQ + kd + 2 * t);
          const float2 qb = *reinterpret_cast<const float2*>(
              sQw + (g + 8) * LQ + kd + 2 * t);
          uint32_t ah[4], al[4];
          split(qa.x, ah[0], al[0]);
          split(qb.x, ah[1], al[1]);
          split(qa.y, ah[2], al[2]);
          split(qb.y, ah[3], al[3]);
          uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float2 kk = *reinterpret_cast<const float2*>(
                sK + (8 * j + g) * LK + kd + 2 * t);
            split(kk.x, bh[j][0], bl[j][0]);
            split(kk.y, bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (kSplit) {
              mma_tf32(small[j], al, bh[j]);
              mma_tf32(small[j], ah, bl[j]);
            }
            mma_tf32(sacc[j], ah, bh[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[j][e] += small[j][e];
      } else {
#pragma unroll 2
        for (int kd = 0; kd < DP; kd += 16) {
          const T* qa = sQw + g * LQ + kd + 2 * t;
          const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LQ), ld32(qa + 8),
                                 ld32(qa + 8 * LQ + 8)};
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const T* kr = sK + (8 * j + g) * LK + kd + 2 * t;
            const uint32_t bb[2] = {ld32(kr), ld32(kr + 8)};
            mma_bf16(sacc[j], a, bb);
          }
        }
      }

      // the logits in log2 units, capped, and masked where the tile
      // crosses the causal diagonal, the window's edge or S
      if (softcap > 0.0f) {
        const float c2 = softcap * kLog2e;
        const float sc = scale / softcap;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sacc[j][e] = c2 * tanhf(sacc[j][e] * sc);
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[j][e] *= sl2;
      }
      const bool edge = c1 > S || (causal && c1 - 1 > wq0) ||
                        (window > 0 && c0 <= w_last - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = c0 + 8 * j + 2 * t + (e & 1);
            const int qi = qi0 + 8 * (e >> 1);
            bool keep = true;
            if (causal) keep = keep && kj <= qi;
            if (window > 0) keep = keep && kj > qi - window;
            float x = keep ? sacc[j][e] : kNegInf2;
            if (kj >= S) x = -INFINITY;  // no key: weight 0
            sacc[j][e] = x;
          }
      }
      // the running max over the 4 lanes of a row, then the weights
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], sacc[j][e]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];  // this lane's part of l; the lanes sum at the end
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(sacc[j][e] - m[e >> 1]);
          sacc[j][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          oacc[n][i][0] *= alpha[0];
          oacc[n][i][1] *= alpha[0];
          oacc[n][i][2] *= alpha[1];
          oacc[n][i][3] *= alpha[1];
        }

      // acc += p v
      if constexpr (kF32) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          // A: the 8 keys in the order (0, 2, 4, 6, 1, 3, 5, 7)
          uint32_t ah[4], al[4];
          split(sacc[j][0], ah[0], al[0]);  // row g, key 2t
          split(sacc[j][2], ah[1], al[1]);  // row g + 8, key 2t
          split(sacc[j][1], ah[2], al[2]);  // row g, key 2t + 1
          split(sacc[j][3], ah[3], al[3]);  // row g + 8, key 2t + 1
          const float* vr = sV + (8 * j + 2 * t) * LV + g;
#pragma unroll
          for (int i = 0; i < ND; ++i) {
            uint32_t bh[2], bl[2];
            split(vr[8 * i], bh[0], bl[0]);       // key 2t, dim g
            split(vr[LV + 8 * i], bh[1], bl[1]);  // key 2t + 1
            if (kSplit) {
              mma_tf32(oacc[NO - 1][i], al, bh);
              mma_tf32(oacc[NO - 1][i], ah, bl);
            }
            mma_tf32(oacc[0][i], ah, bh);
          }
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          const uint32_t a[4] = {
              pack_bf16(sacc[2 * jj][0], sacc[2 * jj][1]),
              pack_bf16(sacc[2 * jj][2], sacc[2 * jj][3]),
              pack_bf16(sacc[2 * jj + 1][0], sacc[2 * jj + 1][1]),
              pack_bf16(sacc[2 * jj + 1][2], sacc[2 * jj + 1][3])};
          // matrices (keys 0-7 | 8-15) x (dims 0-7 | 8-15) of the step
          const T* vr = sV + (16 * jj + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LV + (lane >> 4) * 8;
#pragma unroll
          for (int i = 0; i < ND; i += 2) {
            uint32_t r[4];
            ldsm_x4_trans(r, vr + 8 * i);
            const uint32_t b0[2] = {r[0], r[1]};
            const uint32_t b1[2] = {r[2], r[3]};
            mma_bf16(oacc[0][i], a, b0);
            mma_bf16(oacc[0][i + 1], a, b1);
          }
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is loaded again
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float(&acc)[ND][4] = oacc[0];
  if constexpr (NO > 1) {
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += oacc[1][i][e];
  }

  // the key splits of a strip merge into split 0, in split order
  if constexpr (KS > 1) {
    constexpr int NREG = 4 * ND + 4;  // acc, m and l of a lane
    float* slots = reinterpret_cast<float*>(smem);
    if (ksp > 0) {
      float* s = slots + (pair * (KS - 1) + ksp - 1) * 32 * NREG + lane;
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[32 * (4 * i + e)] = acc[i][e];
      s[32 * (4 * ND)] = m[0];
      s[32 * (4 * ND + 1)] = m[1];
      s[32 * (4 * ND + 2)] = l[0];
      s[32 * (4 * ND + 3)] = l[1];
    }
    __syncthreads();
    if (ksp > 0) return;
#pragma unroll
    for (int x = 0; x < KS - 1; ++x) {
      const float* s = slots + (pair * (KS - 1) + x) * 32 * NREG + lane;
      float wa[2], wb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mo = s[32 * (4 * ND + r)];
        const float mn = fmaxf(m[r], mo);
        wa[r] = ex2(m[r] - mn);
        wb[r] = ex2(mo - mn);
        l[r] = l[r] * wa[r] + s[32 * (4 * ND + 2 + r)] * wb[r];
        m[r] = mn;
      }
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][e] = acc[i][e] * wa[e >> 1] +
                      s[32 * (4 * i + e)] * wb[e >> 1];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qi0 + 8 * r;
    if (qi >= S) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    // the row's logsumexp in log2 units, which the backward reads
    if (lse != nullptr && t == 0)
      lse[(static_cast<size_t>(b) * H + head) * S + qi] = m[r] + log2f(lr);
    T* orow = o + (static_cast<size_t>(b) * S + qi) * q_stride +
              static_cast<size_t>(head) * D;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = 8 * i + 2 * t;
      if (d < D) store(&orow[d], acc[i][2 * r] / lr);
      if (d + 1 < D) store(&orow[d + 1], acc[i][2 * r + 1] / lr);
    }
  }
}

template <typename T, int DP>
size_t smem_bytes(int gh, int nb, int ks) {
  using L = Lay<T, DP>;
  const size_t rows = static_cast<size_t>(gh) * nb * 16;
  const size_t pipe =
      sizeof(T) * (rows * L::kQ + 2 * key_tile<DP>() * (L::kK + L::kV));
  const size_t merge = sizeof(float) * static_cast<size_t>(gh) * nb *
                       (ks - 1) * 32 * (4 * (DP / 8) + 4);
  return pipe > merge ? pipe : merge;
}

template <typename T, int DP, int KS>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int KV, int D, float scale, int causal,
           int window, float softcap, int gh, int nb, cudaStream_t stream) {
  const int nw = gh * nb * KS;
  if (nw > max_warps<DP>()) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T, DP>(gh, nb, KS);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, DP, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const uintptr_t all = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v);
  const int vec = (D * sizeof(T)) % 16 == 0 && all % 16 == 0;
  const int nqt = (S + 16 * nb - 1) / (16 * nb);
  const long long units =
      static_cast<long long>(nqt) * B * KV * ((H / KV) / gh);
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd<T, DP, KS>
      <<<static_cast<unsigned>(units), 32 * nw, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), lse, B, S, H, KV,
          D, scale, causal, window, softcap, gh, nb, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_ks(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int S, int H, int KV, int D, float scale,
              int causal, int window, float softcap, int gh, int nb, int ks,
              cudaStream_t stream) {
  if (ks == 1)
    return launch<T, DP, 1>(q, k, v, o, lse, B, S, H, KV, D, scale, causal,
                            window, softcap, gh, nb, stream);
  if (ks == 2)
    return launch<T, DP, 2>(q, k, v, o, lse, B, S, H, KV, D, scale, causal,
                            window, softcap, gh, nb, stream);
  if constexpr (DP < 256) {
    if (ks == 4)
      return launch<T, DP, 4>(q, k, v, o, lse, B, S, H, KV, D, scale,
                              causal, window, softcap, gh, nb, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_dp(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int S, int H, int KV, int D, float scale,
              int causal, int window, float softcap, int gh, int nb, int ks,
              cudaStream_t stream) {
  if (D <= 64)
    return launch_ks<T, 64>(q, k, v, o, lse, B, S, H, KV, D, scale, causal,
                            window, softcap, gh, nb, ks, stream);
  if (D <= 128)
    return launch_ks<T, 128>(q, k, v, o, lse, B, S, H, KV, D, scale,
                             causal, window, softcap, gh, nb, ks, stream);
  return launch_ks<T, 256>(q, k, v, o, lse, B, S, H, KV, D, scale,
                           causal, window, softcap, gh, nb, ks, stream);
}

}  // namespace

// C interface for ctypes.  q, k, v, o are device pointers to contiguous
// (B, S, H|KV, D) tensors of one dtype (0: float32, 1: bfloat16);
// 1 <= D <= 256 and H % KV == 0 (the wrapper checks).  The plan: a block
// stacks gh query heads of a KV group (gh divides H / KV) and nb 16-row
// strips, with ks warps splitting each strip's keys (1, 2 or 4; 1 or 2
// for D > 128): gh nb ks warps, at most 8 (4 for D > 128).  stream is a
// cudaStream_t.  lse, when not null, receives each row's logsumexp of the
// scaled, capped and masked logits in log2 units, (B, H, S) float32, for
// the backward (flash_attention_bwd.cu).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int S, int H, int KV, int D,
                                      int dtype, float scale, int causal,
                                      int window, float softcap, int gh,
                                      int nb, int ks, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0 || gh < 1 || nb < 1 ||
      (H / KV) % gh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dp<float>(q, k, v, o, lse, B, S, H, KV, D, scale, causal,
                            window, softcap, gh, nb, ks, st);
  if (dtype == 1)
    return launch_dp<__nv_bfloat16>(q, k, v, o, lse, B, S, H, KV, D, scale,
                                    causal, window, softcap, gh, nb, ks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
