// midas_dispatch: the MoE layer's MIDAS expert dispatch, for sm_90a.
//
// Three kernels: the two passes of the Pallas TPU kernel
// src/repro/kernels/midas_route/kernel.py (midas_dispatch), and the
// steering that the TPU code runs between them in XLA:
//
//   dispatch_fused       replaces _body, the single-pass margin-governed
//                        variant (f_max >= 1).  For each token row of the
//                        (T, E) gate logits it picks the top-(k+d)
//                        candidates, then steers slot by slot: slot i's
//                        primary is the i-th ranked expert, and it moves to
//                        the least-loaded unused alternate a when
//                          load[a] <= load[prim] - dL,
//                          logit[a] >= logit[prim] - gate_slack and
//                          load[prim] - load[a] >= dL;
//                        it writes experts (T, k) int32, the softmax over
//                        the chosen logits (T, k) float32 and steered
//                        (T, k) as 0/1 bytes.
//   dispatch_candidates  replaces _cand_body, pass 1 of the f_max-capped
//                        variant (f_max < 1): the top-(k+d) ids (T, k+d)
//                        int32 and logits (T, k+d) float32.
//   dispatch_steer       replaces the XLA ops between the TPU kernel's two
//                        passes (kernel.py:207-215, ref.steer_from_candidates):
//                        pass 2 of f_max < 1.  Slot by slot over the whole
//                        batch: each token's benefit (as above, -inf with
//                        no feasible alternate), the batch's (1 - f_max)
//                        quantile of the benefits (non-finite ones counted
//                        as -1e9), and a steer where the benefit exceeds
//                        max(quantile, float32(dL - 1e-9)).  Slot i's
//                        quantile ranks every token after slots < i have
//                        marked their alternates used.
//
// Selection (both row kernels) is rank by counting: an element's rank is
//   #{j : v_j > v_e or (v_j == v_e and j < e)},
// its position in a stable descending sort (ties to the lowest expert
// id, as jax.lax.top_k and the TPU kernel's iterated argmax rank them),
// and the element of rank r < k+d is candidate r.  A block stages `rows`
// rows of logits in shared memory (padded with -inf to a multiple of 4)
// and gives each row `cover` threads (E rounded up to 32, at most 256),
// one element each (more past 256), which counts over the row's
// float4s: every count is independent, with no chain of dependent
// shuffles as in iterated argmax.  The wrapper's plan picks rows from T
// and E (a decode token's row of E = 128 over 128 threads, a prompt's
// two rows a block).  dispatch_fused then steers each row in its first
// warp, every lane alike, from the candidates and the load staged in
// shared memory; lane s writes slot s and the softmax is a warp
// reduction.
//
// dispatch_steer is one block: the slots are sequential over the batch.
// Each thread owns the tokens tid, tid + blockDim, ...; their benefit
// and used alternates live in shared memory up to kSteerSmemT tokens,
// beyond that in a scratch buffer of the wrapper's.  The quantile needs
// two order statistics s[low] and s[high] of the benefits (numpy
// float32 positions and weights from ref.quantile_plan, computed by
// the wrapper).  They are found by an exact radix select over the
// order-preserving 32-bit key of the float, both ranks in the same
// passes: up to 4 passes of 8-bit digits through block-wide 256-bin
// histograms in shared memory (lanes with the same bin add once),
// scanned by one warp, stopping once one key is left for each rank, so
// one token takes no pass.  A slot whose benefits all lie at or below the floor
// needs no select: the threshold is never below the floor.  The select
// returns elements of the vector, the values of torch.sort, up to the
// sign of a zero, which no steer can see.  Then
//   q = float(double(hi) * w_high + double(lo * w_low)),
// as core.xla.fma rounds the reference's fused interpolation, clamped
// below to float32(dL - 1e-9).
//
// Bound: a row reads E float32 logits and writes (k+d)·8 or k·9 bytes,
// and the selection is E·E compares a row; at the serving shape (E =
// 128, k + d = 10) bytes bind (0.09 µs at T = 512), and at one decode
// token every kernel is its own launch latency.  dispatch_steer moves
// T·(k+d)·8 + E·4 + T·k·9 bytes; its time is the dependent chain of
// the slots in order (at one token a thread's loads of the candidates,
// a barrier and the outputs; at 512 tokens mostly the select's passes).
//
// Build with -fmad=false and without fast math: experts and steered
// must equal the plain PyTorch version bit for bit, with the same
// float32 subtractions and comparisons, and the quantile's double
// multiply and add rounded separately.  Logits must not be NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCover = 256;     // elements a row's threads take at once
constexpr int kMaxThreads = 1024;
constexpr int kBins = 256;
constexpr int kMaxKD = 16;  // k + d
enum SteerMode { kNone = 0, kQuantile = 1, kMargin = 2 };

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// A block's selection layout: `rows` rows of `cover` threads.
struct Geometry {
  int E, Ep, cover, rows;
};

bool make_geometry(int E, int rows, Geometry* g) {
  g->E = E;
  g->Ep = round_up(E, 4);
  g->cover = round_up(E, 32) < kMaxCover ? round_up(E, 32) : kMaxCover;
  g->rows = rows;
  return rows >= 1 && g->cover * rows <= kMaxThreads;
}

// The block's rows of logits into shared memory, -inf past E.
__device__ __forceinline__ void stage_rows(const float* __restrict__ logits,
                                           float* s_rows, int T,
                                           const Geometry& g, int t0) {
  for (int idx = threadIdx.x; idx < g.rows * g.Ep; idx += blockDim.x) {
    const int r = idx / g.Ep, j = idx - r * g.Ep, t = t0 + r;
    s_rows[idx] = (t < T && j < g.E)
                      ? logits[static_cast<size_t>(t) * g.E + j]
                      : -INFINITY;
  }
}

// Rank every element of a staged row; thread i of the row's threads
// calls emit(e, rank, value) for its elements e = i + m·cover.
template <typename Emit>
__device__ __forceinline__ void rank_row(const float* row, const Geometry& g,
                                         int i, Emit emit) {
  const float4* row4 = reinterpret_cast<const float4*>(row);
  const int n4 = g.Ep >> 2;
  for (int e = i; e < g.E; e += g.cover) {
    const float ve = row[e];
    int cnt = 0;
    for (int c = 0; c < n4; ++c) {
      const float4 v = row4[c];
      const int j = c << 2;
      cnt += (v.x > ve) | ((v.x == ve) & (j < e));
      cnt += (v.y > ve) | ((v.y == ve) & (j + 1 < e));
      cnt += (v.z > ve) | ((v.z == ve) & (j + 2 < e));
      cnt += (v.w > ve) | ((v.w == ve) & (j + 3 < e));
    }
    emit(e, cnt, ve);
  }
}

__global__ void __launch_bounds__(kMaxThreads) dispatch_candidates_kernel(
    const float* __restrict__ logits, int32_t* __restrict__ cand,
    float* __restrict__ vals, int T, Geometry g, int kd) {
  extern __shared__ float4 s_mem[];
  float* s_rows = reinterpret_cast<float*>(s_mem);
  const int t0 = blockIdx.x * g.rows;
  stage_rows(logits, s_rows, T, g, t0);
  __syncthreads();
  const int r = threadIdx.x / g.cover;
  const int t = t0 + r;
  rank_row(s_rows + r * g.Ep, g, threadIdx.x - r * g.cover,
           [&](int e, int rank, float v) {
             if (t < T && rank < kd) {
               cand[static_cast<size_t>(t) * kd + rank] = e;
               vals[static_cast<size_t>(t) * kd + rank] = v;
             }
           });
}

// The least-loaded feasible unused alternate of slot i of a token whose
// candidates are ci (ids) and cv (logits), as ref.steer_from_candidates
// picks it (argmin, first index on ties): returns the benefit
// load[prim] - load[best], -inf if none is feasible, and sets best and
// has.
__device__ __forceinline__ float slot_benefit(
    const int32_t* ci, const float* cv, const float* s_load, int i, int k,
    int d, unsigned used, float dl, float slack, int& best, bool& has) {
  const float lp = s_load[ci[i]];
  const float lim_l = lp - dl;
  const float lim_v = cv[i] - slack;
  float best_l = 0.0f;
  best = 0;
  has = false;
  for (int j = 0; j < d; ++j) {
    const float la = s_load[ci[k + j]];
    const bool ok =
        !((used >> j) & 1u) && la <= lim_l && cv[k + j] >= lim_v;
    const float masked = ok ? la : INFINITY;
    if (j == 0 || masked < best_l) {
      best = j;
      best_l = masked;
    }
    has = has || ok;
  }
  return has ? lp - best_l : -INFINITY;
}

__global__ void __launch_bounds__(kMaxThreads) dispatch_fused_kernel(
    const float* __restrict__ logits, const float* __restrict__ load,
    int32_t* __restrict__ experts, float* __restrict__ weights,
    uint8_t* __restrict__ steered, int T, Geometry g, int k, int d, float dl,
    float slack) {
  const int kd = k + d;
  extern __shared__ float4 s_mem[];
  float* s_rows = reinterpret_cast<float*>(s_mem);  // rows * Ep
  float* s_load = s_rows + g.rows * g.Ep;            // E
  float* s_cv = s_load + g.E;                        // rows * kd
  int32_t* s_ci = reinterpret_cast<int32_t*>(s_cv + g.rows * kd);
  const int t0 = blockIdx.x * g.rows;
  stage_rows(logits, s_rows, T, g, t0);
  for (int j = threadIdx.x; j < g.E; j += blockDim.x) s_load[j] = load[j];
  __syncthreads();
  const int r = threadIdx.x / g.cover;
  const int i = threadIdx.x - r * g.cover;
  int32_t* ci = s_ci + r * kd;
  float* cv = s_cv + r * kd;
  rank_row(s_rows + r * g.Ep, g, i, [&](int e, int rank, float v) {
    if (rank < kd) {
      ci[rank] = e;
      cv[rank] = v;
    }
  });
  __syncthreads();
  const int t = t0 + r;
  if (i >= 32 || t >= T) return;

  // slot-sequential steering by the row's first warp, every lane alike
  // from the candidates in shared memory; lane s keeps slot s's result
  unsigned used = 0;
  int my_e = 0;
  float my_v = -INFINITY;
  bool my_s = false;
  for (int s = 0; s < k; ++s) {
    int best;
    bool has;
    const float benefit =
        slot_benefit(ci, cv, s_load, s, k, d, used, dl, slack, best, has);
    const bool steer = has && benefit >= dl;
    if (steer) used |= 1u << best;
    if (i == s) {
      const int src = steer ? k + best : s;
      my_e = ci[src];
      my_v = cv[src];
      my_s = steer;
    }
  }
  // softmax over the k chosen logits, one a lane
  float mx = my_v;
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  const float ex = i < k ? expf(my_v - mx) : 0.0f;
  float sum = ex;
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
  if (i < k) {
    const size_t o = static_cast<size_t>(t) * k + i;
    experts[o] = my_e;
    weights[o] = ex / sum;
    steered[o] = static_cast<uint8_t>(my_s);
  }
}

// The order-preserving key of a benefit as the quantile sees it
// (non-finite values as -1e9, where(isfinite(b), b, -1e9)), and back.
__device__ __forceinline__ uint32_t order_key(float b) {
  const uint32_t u = __float_as_uint(isfinite(b) ? b : -1e9f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

constexpr int kSteerSmemT = 4096;  // tokens whose state fits in shared memory

struct SteerArgs {
  const int32_t* cand;
  const float* vals;
  const float* load;
  int32_t* experts;
  float* weights;  // the chosen logits until the softmax
  uint8_t* steered;
  float* scratch;  // 2·T words beyond kSteerSmemT tokens
  int T, E, k, d, mode, low, high;
  float w_high, w_low, dl, slack, floor;
};

// per-token state word: used alternates << 5 | has << 4 | best
constexpr int kUsedShift = 5;
constexpr unsigned kHas = 16u;

// Shared memory of select_digits: two histograms a rank, used in turns
// (hist[0] is zero on entry and on return), and what warp 0 found.
struct DigitSmem {
  int hist[2][2][kBins];     // [pass parity][rank][bin]
  int dig[2][2], below[2][2], count[2][2];  // [pass parity][rank]
  uint32_t key[2];
};

// The keys of ranks low (out[0]) and high (out[1]) among the benefits
// ben[t] of the block's tokens t = threadIdx.x + j·blockDim.x, by
// 8-bit digits from the top: block-wide 256-bin histograms (lanes with
// the same bin add once), scanned by warp 0; both ranks in the same
// passes, one histogram while their prefixes agree.  It stops once one
// key is left for each rank, and reads that key from its thread: one
// token takes no pass.
__device__ void select_digits(const float* ben, int T, int low, int high,
                              DigitSmem& sm, uint32_t out[2]) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  uint32_t pre[2] = {0u, 0u};
  int rem[2] = {low, high}, m[2] = {T, T};
  int p = 0;
  for (; p < 4 && (m[0] > 1 || m[1] > 1); ++p) {
    const int shift = 24 - 8 * p;
    int(*h)[kBins] = sm.hist[p & 1];
    int* next = &sm.hist[(p + 1) & 1][0][0];
    for (int j = tid; j < 2 * kBins; j += nt) next[j] = 0;
    const int ranks = pre[0] == pre[1] ? 1 : 2;
    for (int base = 0; base < T; base += nt) {
      const int t = base + tid;
      const bool in = t < T;
      const uint32_t key = in ? order_key(ben[t]) : 0u;
      const uint32_t bin = (key >> shift) & 0xffu;
      for (int g = 0; g < ranks; ++g) {
        const bool match = in && (p == 0 || (key >> (shift + 8)) == pre[g]);
        const unsigned act = __ballot_sync(kFull, match);
        if (match) {
          const unsigned peers = __match_any_sync(act, bin);
          if (lane == __ffs(peers) - 1) atomicAdd(&h[g][bin], __popc(peers));
        }
      }
    }
    __syncthreads();
    if (tid < 32) {  // warp 0: the bin of each rank
      for (int g = 0; g < 2; ++g) {
        const int* hg = h[ranks == 1 ? 0 : g];
        const int4 c0 = reinterpret_cast<const int4*>(hg)[2 * lane];
        const int4 c1 = reinterpret_cast<const int4*>(hg)[2 * lane + 1];
        const int c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        int sum = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) sum += c[b];
        int incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += y;
        }
        const int r = rem[g];
        int acc = incl - sum, dig = -1, below = 0, count = 0;
        if (r >= acc && r < incl) {
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            if (dig < 0 && r < acc + c[b]) {
              dig = 8 * lane + b;
              below = acc;
              count = c[b];
            }
            acc += c[b];
          }
          sm.dig[p & 1][g] = dig;
          sm.below[p & 1][g] = below;
          sm.count[p & 1][g] = count;
        }
      }
    }
    __syncthreads();
    for (int g = 0; g < 2; ++g) {
      pre[g] = (pre[g] << 8) | static_cast<uint32_t>(sm.dig[p & 1][g]);
      rem[g] -= sm.below[p & 1][g];
      m[g] = sm.count[p & 1][g];
    }
  }
  if (p & 1)  // the last pass counted into hist[0]
    for (int j = tid; j < 2 * kBins; j += nt) (&sm.hist[0][0][0])[j] = 0;
  // the keys left match their rank's prefix on the top 8p bits: one
  // key, or equal keys (p = 4), so any writer is right
  for (int t = tid; t < T; t += nt) {
    const uint32_t key = order_key(ben[t]);
    for (int g = 0; g < 2; ++g)
      if (p == 0 || (key >> (32 - 8 * p)) == pre[g]) sm.key[g] = key;
  }
  __syncthreads();
  out[0] = sm.key[0];
  out[1] = sm.key[1];
}

__global__ void __launch_bounds__(kMaxThreads) dispatch_steer_kernel(
    SteerArgs a) {
  __shared__ __align__(16) DigitSmem sm;
  extern __shared__ float4 s_mem[];
  float* s_load = reinterpret_cast<float*>(s_mem);
  const int tid = threadIdx.x, nt = blockDim.x, T = a.T;
  const int k = a.k, kd = a.k + a.d;
  float* ben = T <= kSteerSmemT ? s_load + round_up(a.E, 4) : a.scratch;
  uint32_t* st = reinterpret_cast<uint32_t*>(ben + T);
  for (int j = tid; j < a.E; j += nt) s_load[j] = a.load[j];
  for (int j = tid; j < 2 * kBins; j += nt) (&sm.hist[0][0][0])[j] = 0;
  for (int t = tid; t < T; t += nt) st[t] = 0;
  __syncthreads();
  for (int i = 0; i < k; ++i) {
    // each of the thread's tokens: slot i's benefit and best alternate
    bool above = false;  // a benefit over the floor: the quantile matters
    for (int t = tid; t < T; t += nt) {
      const unsigned used = st[t] >> kUsedShift;
      int best;
      bool has;
      const size_t row = static_cast<size_t>(t) * kd;
      const float b = slot_benefit(a.cand + row, a.vals + row, s_load, i, k,
                                   a.d, used, a.dl, a.slack, best, has);
      ben[t] = b;
      st[t] = (used << kUsedShift) | (has ? kHas : 0u) |
              static_cast<unsigned>(best);
      above = above || b > a.floor;
    }
    // the threshold max(q, floor) never lies below the floor, so with no
    // benefit over it nothing steers, whatever q is
    float thr = a.floor;
    if (a.mode == kQuantile && __syncthreads_or(above)) {
      uint32_t key[2];
      select_digits(ben, T, a.low, a.high, sm, key);
      const float lo = key_value(key[0]), hi = key_value(key[1]);
      const float lw = lo * a.w_low;
      const float q = static_cast<float>(static_cast<double>(hi) *
                                             static_cast<double>(a.w_high) +
                                         static_cast<double>(lw));
      thr = q < a.floor ? a.floor : q;
    }
    for (int t = tid; t < T; t += nt) {
      const size_t row = static_cast<size_t>(t) * kd;
      const unsigned s = st[t];
      const int best = static_cast<int>(s & 15u);
      const bool has = (s & kHas) != 0u;
      const float b = ben[t];
      const bool steer = has && (a.mode == kQuantile ? b > thr
                                 : a.mode == kMargin ? b >= a.dl
                                                     : false);
      const int src = steer ? k + best : i;
      const size_t o = static_cast<size_t>(t) * k + i;
      a.experts[o] = a.cand[row + src];
      a.weights[o] = a.vals[row + src];
      a.steered[o] = static_cast<uint8_t>(steer);
      st[t] = ((s >> kUsedShift) | (steer ? 1u << best : 0u)) << kUsedShift;
    }
  }

  // softmax over each token's k chosen logits, as dispatch_fused, each
  // read once into registers
  for (int t = tid; t < T; t += nt) {
    float* w = a.weights + static_cast<size_t>(t) * k;
    float v[kMaxKD];
#pragma unroll
    for (int s = 0; s < kMaxKD; ++s) v[s] = s < k ? w[s] : -INFINITY;
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxKD; ++s) mx = fmaxf(mx, v[s]);
    float sum = 0.0f;
#pragma unroll
    for (int s = 0; s < kMaxKD; ++s) {
      v[s] = s < k ? expf(v[s] - mx) : 0.0f;
      sum += v[s];
    }
#pragma unroll
    for (int s = 0; s < kMaxKD; ++s)
      if (s < k) w[s] = v[s] / sum;
  }
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers; stream is a
// cudaStream_t.  Each returns the cudaError_t of its launch (0 on
// success; cudaErrorInvalidValue for a plan it cannot take).  The
// wrappers check 1 <= E <= 1024, 1 <= k, 1 <= d, k + d <= min(E, 16),
// T >= 1, and pass rows with rows · min(round_up(E, 32), 256) <= 1024.
extern "C" int dispatch_candidates_launch(const void* logits, void* cand,
                                          void* vals, int T, int E, int kd,
                                          int rows,
                                          void* stream) {
  if (T <= 0) return 0;
  Geometry g;
  if (!make_geometry(E, rows, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(rows) * g.Ep * sizeof(float);
  dispatch_candidates_kernel<<<(T + rows - 1) / rows, g.cover * rows,
                               smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int32_t*>(cand),
      static_cast<float*>(vals), T, g, kd);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dispatch_fused_launch(const void* logits, const void* load,
                                     void* experts, void* weights,
                                     void* steered, int T, int E, int k,
                                     int d, float delta_l, float gate_slack,
                                     int rows, void* stream) {
  if (T <= 0) return 0;
  Geometry g;
  if (!make_geometry(E, rows, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(rows) * (g.Ep + 2 * (k + d)) + E) * sizeof(float);
  dispatch_fused_kernel<<<(T + rows - 1) / rows, g.cover * rows, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(load),
      static_cast<int32_t*>(experts), static_cast<float*>(weights),
      static_cast<uint8_t*>(steered), T, g, k, d, delta_l, gate_slack);
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 steers nothing (f_max <= 0), 1 the f_max quantile, 2 the
// margin alone (f_max >= 1).  low, high, w_high and w_low are
// ref.quantile_plan(T, 1 - f_max); floor is float32(delta_l - 1e-9).
// scratch holds 2·T float32 words when T > 4096, else may be null.
extern "C" int dispatch_steer_launch(
    const void* cand, const void* vals, const void* load, void* experts,
    void* weights, void* steered, void* scratch, int T, int E, int k, int d,
    int mode, int low, int high, float w_high, float w_low, float delta_l,
    float gate_slack, float floor_, void* stream) {
  if (T <= 0) return 0;
  if (T > kSteerSmemT && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  SteerArgs a{static_cast<const int32_t*>(cand),
              static_cast<const float*>(vals),
              static_cast<const float*>(load),
              static_cast<int32_t*>(experts),
              static_cast<float*>(weights),
              static_cast<uint8_t*>(steered),
              static_cast<float*>(scratch),
              T, E, k, d, mode, low, high,
              w_high, w_low, delta_l, gate_slack, floor_};
  const int threads = T < kMaxThreads ? round_up(T, 32) : kMaxThreads;
  size_t smem = static_cast<size_t>(round_up(E, 4)) * sizeof(float);
  if (T <= kSteerSmemT) smem += static_cast<size_t>(T) * 8;
  dispatch_steer_kernel<<<1, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
