// decode_attention: one query token against a KV cache, bounded by a
// per-row position, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// kernel.py (_body, launched from decode_attention).  For q (B, H, D),
// caches (B, S, KV, D) and pos (B,), query head h of row b reads KV head
// h / G (G = H / KV) at cache rows j with
//   j <= pos[b]  and, with a window, j > pos[b] - window;
//   s = (q . k_j) * scale;  s = cap * tanh(s / cap) if cap > 0;
//   out = softmax(s) v in float32, and out = acc / max(l, 1e-30) in
//   q's dtype.
// pos is read from device memory, so a decode step never waits on the
// host.  Where no cache row is kept (pos < 0, or a window that keeps
// nothing), every row is masked to -2**30 and the result is the plain
// mean of v, as in the reference.
//
// Bound: the op reads each kept cache row once (2 KV D elements per row
// and batch entry) and does 4 G D operations per row and KV head, so it
// is bound by bytes: at SmolLM-360M's decode shape (544-row cache,
// KV = 5, D = 64, float32) 1.4 MB, 0.42 us at 3.35 TB/s; at
// Qwen3-MoE's (KV = 4, D = 128) 2.2 MB, 0.69 us.
//
// Design: at batch 1 a grid of one block per (row, KV head) is 4-5
// blocks on 132 SMs, so the cache rows are split as well.  A block takes
// one (batch row b, KV head, span of `span` cache rows) and serves all G
// query heads of the group, so every kept cache element is read from
// device memory once.  It walks its span in tiles of at most 32 rows
// (one tile at the serving shapes):
//  1. Stage: the block loads the kept rows of the tile of K and V, and
//     (with the first tile) the G query rows, into shared memory as
//     float32, with 16-byte loads (4 float32 or 8 bfloat16) issued four
//     per thread before the first store waits on one.  A span with no
//     kept row loads nothing.
//  2. Reduce, with every thread of the block (256, or 512 for a group
//     of 8 or more heads) busy at the serving shapes: a thread per
//     (head, row) for the scores (float4 reads of the staged rows), a
//     warp per head for the running max m and l = sum exp(s - m), a
//     thread per (head, dim) for acc[d] = sum exp(s - m) v[d]; a later
//     tile rescales the earlier tiles' l and acc (kept in shared
//     memory) by exp(m_old - m), as an online softmax does (a kernel
//     instance for spans of one tile leaves that out).  (m, l, acc)
//     per head is written to a float32 workspace record.
//  3. Merge in the same launch: after a barrier, one thread of each
//     block takes a ticket on a per-(b, KV head) counter by an acq_rel
//     fetch_add (the fence and atomicAdd of CUDA's threadFenceReduction
//     sample in one instruction).  The last block to arrive merges the
//     group's records: M = max m_i, L = sum l_i exp(m_i - M) (a warp
//     per head, its lanes over the records), acc = sum acc_i
//     exp(m_i - M) (threads over columns and fixed chunks of records,
//     whose loads are issued before the round trip for m and l), always
//     in the same order, so a result is bitwise the same from run to
//     run whichever block merges.  It sets the counter back to 0.  A
//     record with l = 0 (a span that kept no row) has weight 0 and a
//     zero acc.
//  The kernel is bound by the latency of its dependent steps (pos, the
//  staged rows, the ticket, the records), not by bytes, so the wrapper
//  keeps the spans few (kernel.py:split_plan, at most 24): more,
//  shorter spans make the merge longer than they make the blocks
//  shorter, and a long cache makes longer spans, not more of them.
// The counters and the workspace live in buffers that the wrapper keeps
// for each (device, stream): each launch leaves the counters at 0, so
// the wrapper never clears them.  Hence the restriction: launches that
// share the buffers must not run at once, which holds for launches in
// one stream; a CUDA graph that captured a launch uses the capturing
// stream's buffers, so it is replayed in that stream or while it is
// idle; and a launch that faults mid-way leaves the counters to be
// zeroed again.
//
// Registers and spills: the ptxas lines chip_smoke.py phase 1 prints
// (at most 128 registers, so one 512-thread block fits an SM; the plan
// keeps to about one block an SM).  Shared memory is (2 tile + G)
// (DP + 4) floats for the staged rows, G (DP + 4) more for the running
// acc where a span has more than one tile, plus the tile's and the
// merge's weights: 22 and 45 KB at the two serving shapes.  D is padded
// to DP = 64, 128 or 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cuda/atomic>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as the reference
// threads of a block: 512 where a KV group has 8 or more query heads,
// else 256 (a template parameter NT below)
constexpr int kMaxThreads = 512;
constexpr int kTile = 32;     // cache rows a block stages at once
constexpr int kUnroll = 4;    // 16-byte loads a thread issues at once
// dynamic shared memory a block may opt into: the 227 KB of the H100
// less room for the kernel's static shared memory
constexpr int kMaxSmem = 232448 - 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of T as float32 into dst (4 or 8 values)
__device__ __forceinline__ void unpack(float* dst, uint4 r, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(r.x), __uint_as_float(r.y), __uint_as_float(r.z),
      __uint_as_float(r.w));
}
__device__ __forceinline__ void unpack(float* dst, uint4 r, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Records of the workspace: acc [G][D], then m [G], then l [G], padded
// to a multiple of 4 floats so that every record is 16-byte aligned.
__host__ __device__ __forceinline__ int record_floats(int G, int D) {
  return (G * D + 2 * G + 3) & ~3;
}

// Stage rows into shared memory as float32, row stride RS floats: the
// nk rows of K and of V (row r at kb / vb + r * rstride) and the G rows
// of q (row g at qb + g * D).  With vec, every item is 16 bytes and
// kUnroll items of a thread are in flight before the first store.
template <typename T, int RS, int NT>
__device__ __forceinline__ void stage(float* sK, float* sV, float* sQ,
                                      const T* kb, const T* vb,
                                      const T* qb, size_t rstride, int nk,
                                      int G, int D, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int per = vec ? D / VEC : D;  // items per row
  const int nkv = nk * per;
  const int total = 2 * nkv + G * per;
  for (int base = threadIdx.x; base < total;
       base += kUnroll * NT) {
    if (vec) {
      uint4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * NT;
        if (i >= total) break;
        const T* src;
        if (i < 2 * nkv) {
          const int ii = i < nkv ? i : i - nkv;
          src = (i < nkv ? kb : vb) + (ii / per) * rstride +
                (ii % per) * VEC;
        } else {
          const int ii = i - 2 * nkv;
          src = qb + static_cast<size_t>(ii / per) * D + (ii % per) * VEC;
        }
        r[u] = __ldg(reinterpret_cast<const uint4*>(src));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * NT;
        if (i >= total) break;
        const int ii = i < nkv ? i : (i < 2 * nkv ? i - nkv : i - 2 * nkv);
        float* dst = (i < nkv ? sK : (i < 2 * nkv ? sV : sQ)) +
                     (ii / per) * RS + (ii % per) * VEC;
        unpack(dst, r[u], T());
      }
    } else {
      float r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * NT;
        if (i >= total) break;
        const int ii = i < nkv ? i : (i < 2 * nkv ? i - nkv : i - 2 * nkv);
        const T* src = i < 2 * nkv
                           ? (i < nkv ? kb : vb) + (ii / per) * rstride +
                                 ii % per
                           : qb + static_cast<size_t>(ii / per) * D +
                                 ii % per;
        r[u] = to_f32(*src);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * NT;
        if (i >= total) break;
        const int ii = i < nkv ? i : (i < 2 * nkv ? i - nkv : i - 2 * nkv);
        float* dst = (i < nkv ? sK : (i < 2 * nkv ? sV : sQ)) +
                     (ii / per) * RS + ii % per;
        *dst = r[u];
      }
    }
  }
  // zero the columns [D, D rounded up to 4) that the float4 dot reads
  const int D4 = (D + 3) & ~3;
  if (D4 > D) {
    const int w = D4 - D;
    for (int i = threadIdx.x; i < (nk + G) * w; i += NT) {
      const int row = i / w, c = D + i % w;
      if (row < nk) {
        sK[row * RS + c] = 0.0f;
      } else {
        sQ[(row - nk) * RS + c] = 0.0f;
      }
    }
  }
}

// Write VW merged values of head g at dims d..: acc / max(L, 1e-30).
template <typename T, int VW>
__device__ __forceinline__ void finish(const float* acc, int g, int d,
                                       int G, int D, const float* s_ML,
                                       T* out) {
#pragma unroll
  for (int v = 0; v < VW; ++v)
    store(&out[g * D + d + v], acc[v] / fmaxf(s_ML[G + g], 1e-30f));
}

// Merge n records (src, src + RD, ...) in their order: per head
// M = max m_i over records with l_i > 0, L = sum l_i w_i, acc = sum
// w_i acc_i with w_i = exp(m_i - M) (0 where l_i = 0; such a record's
// acc is zero), and out = acc / max(L, 1e-30) in T (out row g at
// out + g * D).  Threads take columns of VW
// floats (4 where D % 4 == 0) and fixed chunks of the records, summed in
// chunk order afterwards; where a thread's chunk fits kHold records,
// their loads are issued before the round trip for m and l.
template <typename T, int VW, int NT>
__device__ void merge(const float* src, int n, int G, int D, T* out,
                      float* s_w, float* s_l, float* s_ML, float* s_part) {
  constexpr int kHold = 8;  // records a thread loads at once
  const int RD = record_floats(G, D);
  const int per = D / VW;
  const int ncols = G * per;
  const int nq = ncols >= NT ? 1 : min(n, NT / ncols);
  const int chunk = (n + nq - 1) / nq;
  const int items = ncols * nq;
  float x[kHold][VW];
  // kHold records of item t from record ib on, all loads in flight
  auto load = [&](int t, int ib) {
    const int col = t % ncols, i1 = min(n, t / ncols * chunk + chunk);
    const float* p = src + static_cast<size_t>(ib) * RD + col * VW;
#pragma unroll
    for (int u = 0; u < kHold; ++u) {
      if (ib + u < i1) {
        if constexpr (VW == 4) {
          const float4 f = __ldcg(reinterpret_cast<const float4*>(
              p + static_cast<size_t>(u) * RD));
          x[u][0] = f.x;
          x[u][1] = f.y;
          x[u][2] = f.z;
          x[u][3] = f.w;
        } else {
          x[u][0] = __ldcg(p + static_cast<size_t>(u) * RD);
        }
      }
    }
  };
  // the first records of a thread's first item do not wait on m and l
  if (threadIdx.x < items) load(threadIdx.x, threadIdx.x / ncols * chunk);
  for (int i = threadIdx.x; i < n * G; i += NT) {
    const int r = i / G, g = i % G;
    s_w[i] = __ldcg(src + static_cast<size_t>(r) * RD + G * D + g);
    s_l[i] = __ldcg(src + static_cast<size_t>(r) * RD + G * D + G + g);
  }
  __syncthreads();
  // warp w weighs heads w, w + NT / 32, ...: its lanes split the records
  // and reduce by shuffles (a fixed tree, so the order never changes)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += NT / 32) {
    float M = kNegInf;
    for (int i = lane; i < n; i += 32)
      if (s_l[i * G + g] > 0.0f) M = fmaxf(M, s_w[i * G + g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const float l = s_l[i * G + g];
      const float w = l > 0.0f ? expf(s_w[i * G + g] - M) : 0.0f;
      s_w[i * G + g] = w;
      L += l * w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, off);
    if (lane == 0) {
      s_ML[g] = M;
      s_ML[G + g] = L;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < items; t += NT) {
    const int col = t % ncols, g = col / per, d = (col % per) * VW;
    const int i0 = t / ncols * chunk, i1 = min(n, i0 + chunk);
    float acc[VW];
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[v] = 0.0f;
    for (int ib = i0; ib < i1; ib += kHold) {
      if (t != threadIdx.x || ib != i0) load(t, ib);
#pragma unroll
      for (int u = 0; u < kHold; ++u) {
        if (ib + u < i1) {
          const float w = s_w[(ib + u) * G + g];
#pragma unroll
          for (int v = 0; v < VW; ++v) acc[v] += w * x[u][v];
        }
      }
    }
    if (nq == 1) {
      finish<T, VW>(acc, g, d, G, D, s_ML, out);
    } else {  // items <= NT
#pragma unroll
      for (int v = 0; v < VW; ++v) s_part[v * NT + t] = acc[v];
    }
  }
  if (nq > 1) {
    __syncthreads();
    for (int col = threadIdx.x; col < ncols; col += NT) {
      float acc[VW];
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        acc[v] = 0.0f;
        for (int qi = 0; qi < nq; ++qi)
          acc[v] += s_part[v * NT + qi * ncols + col];
      }
      finish<T, VW>(acc, col / per, (col % per) * VW, G, D, s_ML,
                    out);
    }
  }
}

// kMulti: a span may have more than one tile (span > kTile), walked
// with the online softmax; else the one tile is reduced without the
// loop and the rescaling (a loop around it measured 0.4-0.7 us slower
// at the serving shapes).  One block an SM: at (NT, 1) ptxas spills
// nothing, at (NT) alone the D % 4 != 0 instances spilled
template <typename T, int DP, int VW, int NT, bool kMulti>
__global__ void __launch_bounds__(NT, 1)
    decode_split(const T* __restrict__ q, const T* __restrict__ kc,
                 const T* __restrict__ vc, const int32_t* __restrict__ pos,
                 T* __restrict__ o, float* __restrict__ ws,
                 int* __restrict__ cnt, int S, int H, int KV, int D,
                 float scale, int window, float softcap, int span,
                 bool vec) {
  constexpr int RS = DP + 4;  // staged row stride, floats
  extern __shared__ float4 smem4[];
  __shared__ int s_last;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int G = H / KV;
  const int tile = kMulti ? kTile : span;
  float* sK = reinterpret_cast<float*>(smem4);  // [tile][RS]
  float* sV = sK + tile * RS;                   // [tile][RS]
  float* sQ = sV + tile * RS;                   // [G][RS]
  float* sA = sQ + G * RS;  // [G][RS]: acc of the earlier tiles
  float* sS = sA + (kMulti ? G * RS : 0);       // [G][kTile]
  float* s_w = sS + G * kTile;                  // [splits][G]
  float* s_l = s_w + splits * G;                // [splits][G]
  float* s_ML = s_l + splits * G;               // [2][G]: m, l so far
  float* s_part = s_ML + 2 * G;                 // [4][NT]
  float* s_a = s_part + 4 * NT;                 // [G]: a tile's rescale
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int p = pos[b];
  int hi = min(p, S - 1);
  int lo = window > 0 ? max(0, p - window + 1) : 0;
  const bool none = lo > hi;
  if (none) {  // nothing kept: the reference averages every masked row
    lo = 0;
    hi = S - 1;
  }
  const int r0 = max(split * span, lo);
  const int nr = max(min(split * span + span - 1, hi) - r0 + 1, 0);

  const size_t rstride = static_cast<size_t>(KV) * D;
  const size_t group = static_cast<size_t>(b) * KV + kvh;
  T* og = o + (static_cast<size_t>(b) * H + kvh * G) * D;
  const int RD = record_floats(G, D);
  float* rec = ws + (group * splits + split) * RD;
  if (nr == 0) {  // a span with no kept row: weight 0, acc 0
    for (int e = threadIdx.x; e < G * D; e += NT) rec[e] = 0.0f;
    for (int g = threadIdx.x; g < G; g += NT) {
      rec[G * D + g] = kNegInf;
      rec[G * D + G + g] = 0.0f;
    }
  }
  const int D4 = (D + 3) & ~3;
  // the nt rows from r0 + t0 on, the first and the last tile of the
  // span or not: stage, score, weigh and add them to acc
  auto pass = [&](int t0, int nt, bool first, bool last) {
    const size_t row0 = static_cast<size_t>(b) * S + r0 + t0;
    stage<T, RS, NT>(sK, sV, sQ, kc + row0 * rstride + kvh * D,
                     vc + row0 * rstride + kvh * D,
                     q + (static_cast<size_t>(b) * H + kvh * G) * D,
                     rstride, nt, first ? G : 0, D, vec);
    __syncthreads();
    // scores: a thread per (head, row) pair, the q and k rows read from
    // shared memory as float4 (the padded stride keeps it conflict-free)
    for (int e = threadIdx.x; e < G * nt; e += NT) {
      const int g = e / nt, j = e % nt;
      float s = kNegInf;
      if (!none) {
        const float* qg = sQ + g * RS;
        const float* kj = sK + j * RS;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
        for (int c = 0; c < D4; c += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qg + c);
          const float4 kk = *reinterpret_cast<const float4*>(kj + c);
          a0 += qq.x * kk.x;
          a1 += qq.y * kk.y;
          a2 += qq.z * kk.z;
          a3 += qq.w * kk.w;
        }
        s = ((a0 + a1) + (a2 + a3)) * scale;
        if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      }
      sS[g * kTile + j] = s;
    }
    __syncthreads();
    // softmax of the tile: a warp per head, its lanes over the rows; the
    // running max m and sum l of the earlier tiles are in s_ML
    for (int g = warp; g < G; g += NT / 32) {
      const bool live = lane < nt;
      const float s = live ? sS[g * kTile + lane] : -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = first ? -INFINITY : s_ML[g];
      const float m = fmaxf(m_old, mx);
      const float pj = live ? expf(s - m) : 0.0f;
      float l = pj;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      if (live) sS[g * kTile + lane] = pj;
      if (lane == 0) {
        if (!first) {
          const float a = expf(m_old - m);
          s_a[g] = a;
          l = fmaf(s_ML[G + g], a, l);
        }
        s_ML[g] = m;
        s_ML[G + g] = l;
        if (last && splits > 1) {
          rec[G * D + g] = m;
          rec[G * D + G + g] = l;
        }
      }
    }
    __syncthreads();
    // acc: a thread per (head, dim), the same pairs in every tile
    for (int e = threadIdx.x; e < G * D; e += NT) {
      const int g = e / D, d = e % D;
      const float* pg = sS + g * kTile;
      float acc = 0.0f;
#pragma unroll 4
      for (int jj = 0; jj < nt; ++jj) acc += pg[jj] * sV[jj * RS + d];
      if (!first) acc = fmaf(s_a[g], sA[g * RS + d], acc);
      if (!last) {
        sA[g * RS + d] = acc;
      } else if (splits == 1) {
        store(&og[e], acc / fmaxf(s_ML[G + g], 1e-30f));
      } else {
        rec[e] = acc;
      }
    }
  };
  if constexpr (kMulti) {
    for (int t0 = 0; t0 < nr; t0 += kTile) {
      if (t0 > 0) __syncthreads();  // the last tile's rows are read
      const int nt = min(kTile, nr - t0);
      pass(t0, nt, t0 == 0, t0 + nt == nr);
    }
  } else if (nr > 0) {
    pass(0, nr, true, true);
  }
  if (splits == 1) return;

  // the last block of the group to arrive merges the splits' records
  int* c = cnt + group;
  __syncthreads();  // the block's records are written
  if (threadIdx.x == 0) {
    // a release of the block's records (ordered before it by the
    // barrier) and an acquire of the others', in one atomic
    cuda::atomic_ref<int, cuda::thread_scope_device> ticket(*c);
    const int t = ticket.fetch_add(1, cuda::memory_order_acq_rel);
    s_last = t == splits - 1;
    if (s_last) ticket.store(0, cuda::memory_order_relaxed);  // reset
  }
  __syncthreads();
  if (!s_last) return;
  merge<T, VW, NT>(ws + group * splits * RD, splits, G, D, og, s_w, s_l, s_ML,
               s_part);
}

size_t smem_bytes(int DP, int G, int span, int splits) {
  const int tile = span < kTile ? span : kTile;
  const int acc_rows = span > tile ? G : 0;
  return sizeof(float) *
         (static_cast<size_t>(2 * tile + G + acc_rows) * (DP + 4) +
          G * kTile + 2 * static_cast<size_t>(splits) * G + 3 * G +
          4 * kMaxThreads);
}

template <typename T, int DP, int NT>
int launch_nt(const void* q, const void* kc, const void* vc,
              const void* pos, void* o, void* ws, void* cnt, int B, int S,
              int H, int KV, int D, float scale, int window, float softcap,
              int span, cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    for (auto fn : {decode_split<T, DP, 1, NT, false>,
                    decode_split<T, DP, 4, NT, false>,
                    decode_split<T, DP, 1, NT, true>,
                    decode_split<T, DP, 4, NT, true>}) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    attr_set = true;
  }
  const int splits = (S + span - 1) / span;
  const size_t smem = smem_bytes(DP, H / KV, span, splits);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      D % (16 / sizeof(T)) == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kc) |
       reinterpret_cast<uintptr_t>(vc)) % 16 == 0;
  const dim3 grid(splits, KV, B);
  auto fn = span > kTile ? (D % 4 == 0 ? decode_split<T, DP, 4, NT, true>
                                       : decode_split<T, DP, 1, NT, true>)
                         : (D % 4 == 0 ? decode_split<T, DP, 4, NT, false>
                                       : decode_split<T, DP, 1, NT, false>);
  fn<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int32_t*>(pos),
      static_cast<T*>(o), static_cast<float*>(ws), static_cast<int*>(cnt),
      S, H, KV, D, scale, window, softcap, span, vec);
  return static_cast<int>(cudaGetLastError());
}

// 512 threads for a group of 8 or more heads (Qwen3-MoE's 16: the merge
// reads 16 D floats a record, and twice the threads halve its rounds);
// 256 for fewer (SmolLM-360M's 3), where 512 measured 0.35 us slower
template <typename T, int DP>
int launch(const void* q, const void* kc, const void* vc, const void* pos,
           void* o, void* ws, void* cnt, int B, int S, int H, int KV, int D,
           float scale, int window, float softcap, int span,
           cudaStream_t stream) {
  if (H / KV >= 8)
    return launch_nt<T, DP, 512>(q, kc, vc, pos, o, ws, cnt, B, S, H, KV, D,
                                 scale, window, softcap, span, stream);
  return launch_nt<T, DP, 256>(q, kc, vc, pos, o, ws, cnt, B, S, H, KV, D,
                               scale, window, softcap, span, stream);
}

template <typename T>
int launch_dp(const void* q, const void* kc, const void* vc,
              const void* pos, void* o, void* ws, void* cnt, int B, int S,
              int H, int KV, int D, float scale, int window, float softcap,
              int span, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, kc, vc, pos, o, ws, cnt, B, S, H, KV, D, scale,
                         window, softcap, span, stream);
  if (D <= 128)
    return launch<T, 128>(q, kc, vc, pos, o, ws, cnt, B, S, H, KV, D,
                          scale, window, softcap, span, stream);
  return launch<T, 256>(q, kc, vc, pos, o, ws, cnt, B, S, H, KV, D, scale,
                        window, softcap, span, stream);
}

}  // namespace

// C interface for ctypes.  q (B, H, D), caches (B, S, KV, D) and o
// (B, H, D) are contiguous device tensors of one dtype (0: float32,
// 1: bfloat16); pos is a device int32 (B,).  The cache rows are split
// into splits = ceil(S / span) spans of span >= 1 rows.  ws is a
// float32 workspace of B KV splits records of 4 ceil((G D + 2 G) / 4)
// floats each; cnt holds B KV int32 counters, zero before the launch
// and zero after it.  1 <= D <= 256, S >= 1, B <= 65535 and H % KV == 0
// (the wrapper checks).  stream is a cudaStream_t.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* pos,
                                       void* o, void* ws, void* cnt, int B,
                                       int S, int H, int KV, int D,
                                       int dtype, float scale, int window,
                                       float softcap, int span,
                                       void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || D < 1 || D > 256 || KV < 1 || H % KV != 0 || B > 65535 ||
      KV > 65535 || span < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dp<float>(q, kc, vc, pos, o, ws, cnt, B, S, H, KV, D,
                            scale, window, softcap, span, st);
  if (dtype == 1)
    return launch_dp<__nv_bfloat16>(q, kc, vc, pos, o, ws, cnt, B, S, H, KV,
                                    D, scale, window, softcap, span, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
