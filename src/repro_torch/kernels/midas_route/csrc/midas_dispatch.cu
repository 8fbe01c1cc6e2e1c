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
// dispatch_steer is one block: the slots run in order over the whole
// batch, since slot i's quantile ranks every token after slots < i have
// marked their alternates used.  Up to kRegT = 512 tokens a thread owns
// a token and keeps it in registers across the k slots
// (dispatch_steer_kernel): its k + d ids and logits, each loaded once,
// every load issued before the first use, their loads gathered once
// from the load staged in shared memory (the wide instantiation reads
// them there in each slot), the used alternates, and each slot's chosen
// expert and logit written over its primary's.  The softmax runs on
// those registers and each output row is written once (16-byte stores
// where k is a multiple of 4).  Nothing is read back from device
// memory.  The margin and none modes have no barrier in the slot loop.
// The quantile needs s[low] and s[high] of the batch's benefits
// (non-finite ones counted as -1e9; numpy float32 positions and weights
// from ref.quantile_plan, computed by the wrapper), then
//   q = float(double(hi) * w_high + double(lo * w_low)),
// as core.xla.fma rounds the reference's fused interpolation, clamped
// below to floor = float32(dL - 1e-9).  If s[high] < floor, q <= floor
// (the interpolation of lo <= hi < floor rounds to at most the floor;
// tests/test_torch_dispatch_design.py holds it on values ulps from the
// floor), so the threshold is the floor: only the G benefits at or
// above the floor are ranked, at ranks T - G and up, and a slot with
// G < T - high selects nothing.  A stable rank is counted, #{v_j < v_t}
// + #{v_j == v_t, j before t}, which is torch.sort's order, -0.0 and
// +0.0 alike:
//   - T <= 32, one warp (warp_select): the values go round by 32
//     shuffles, the ballots of rank low and high name the lanes to
//     read; no barrier.  At T = 1, s[0] is the token's own value;
//   - up to count_max tokens (block_select): one barrier counts G
//     (__syncthreads_count); a slot that selects has each warp write
//     its values at or above the floor first (ballot prefix) and +inf
//     after into its 32 slots of shared memory, and the largest key
//     below the floor; one barrier; each ranked thread counts over
//     every warp's slots in float4s; the threads of rank low and high
//     write their values; one barrier.  When s[low] lies below the
//     floor (G = T - high = T - low - 1), it is the largest value
//     below it, from the warps' maxima;
//   - beyond count_max tokens, select_digits.
// Beyond kRegT tokens (dispatch_steer_smem_kernel) each thread owns
// the tokens tid, tid + 1024, ...; their benefit and used alternates
// live in shared memory up to kSteerSmemT tokens, beyond that in a
// scratch buffer of the wrapper's, and the quantile comes from
// select_digits once a benefit exceeds the floor: an exact radix select
// over the order-preserving 32-bit key of the float, both ranks in the
// same passes, up to 4 passes of 8-bit digits through block-wide
// 256-bin histograms in shared memory, stopping once one key is left
// for each rank.  It returns elements of the vector, the values of
// torch.sort, up to the sign of a zero, which no steer can see.
//
// Bound: a row reads E float32 logits and writes (k+d)·8 or k·9 bytes,
// and the selection is E·E compares a row; at the serving shape (E =
// 128, k + d = 10) bytes bind (0.09 µs at T = 512), and at one decode
// token every kernel is its own launch latency.  dispatch_steer moves
// 8·T·(k+d) + 4·E + 9·T·k bytes (0.0002 µs at T = 1, 0.0234 µs at T =
// 512 at 3.35 TB/s); its time is the launch (a one-element op takes
// 1.025 µs in a graph replay) and the dependent chain of the k slots.
// NVIDIA H100 80GB HBM3, 700 W: 3.24 µs at one decode token and 6.51
// µs at a 512-token prompt (chip_smoke.py phase 2; 7.96 and 51.80 for
// the shared-memory design before, benchmarks_torch/kernel_steps.py).
// Registers (-Xptxas -v, sm_90a, both register kernels at
// __launch_bounds__(512, 1), up to 128 a thread): 88 for k <= 8, d <= 2
// and 127 for k + d = 16, 0 bytes spilled (8-byte stack frames: the
// calls of warp_select and block_select).  Hence kRegT = 512: at 1024
// threads a thread may hold 64 registers, too few for either.
// Crossover: counting ranks beats select_digits up to 320 tokens when
// most benefits clear the floor (kernel_steps.py: 34.7 against 37.8 µs
// at 320, 40.2 against 38.4 at 384), so the wrapper's STEER_COUNT_MAX
// is 320.  One block: the serving path sends at most 512 tokens, which
// one block holds, and its time there is the launch and the k slots; a
// thread-block cluster would add a cluster barrier to each slot's
// batch-wide quantile, and only batches beyond 512 tokens would use it
// (68.0 µs at 1024 and 194.7 at 4096 tokens on the shared-memory
// kernel, most benefits over the floor), which no serving path sends.
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
  float* weights;  // the smem kernel: the chosen logits until the softmax
  uint8_t* steered;
  float* scratch;  // 2·T words beyond kSteerSmemT tokens
  int T, E, k, d, mode, low, high;
  float w_high, w_low, dl, slack, floor;
};

// The threshold max(q, floor) from the order statistics lo = s[low] and
// hi = s[high]: lo * w_low in float32, then the product and the sum in
// double, rounded to float32.
__device__ __forceinline__ float threshold(float lo, float hi, float w_high,
                                           float w_low, float floor_) {
  const float lw = lo * w_low;
  const float q = static_cast<float>(static_cast<double>(hi) *
                                         static_cast<double>(w_high) +
                                     static_cast<double>(lw));
  return q < floor_ ? floor_ : q;
}

// per-token state word of dispatch_steer_smem_kernel: used alternates
// << 5 | has << 4 | best
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

// Beyond the register kernel's tokens: each thread owns the tokens tid,
// tid + blockDim, ..., whose benefit and state word live in shared
// memory (or the scratch buffer), re-reading the candidates each slot.
__global__ void __launch_bounds__(kMaxThreads) dispatch_steer_smem_kernel(
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
      thr = threshold(key_value(key[0]), key_value(key[1]), a.w_high,
                      a.w_low, a.floor);
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

// Shared memory of the register kernel's select, for up to NT tokens.
// (seg first: it is read in float4s, and the block aligns it to 16)
template <int NT>
struct RegSmem {
  float seg[NT];  // warp w's values at or above the floor first (token
                  // order), +inf after, at 32·w
  float all[NT];  // each token's quantile value, for select_digits
  DigitSmem dig;
  uint32_t kmax[NT / 32];  // the largest key below the floor in warp w
  float res[2];            // s[low] and s[high]
};

// The block's s[low] and s[high] once G values lie at or above the floor
// and G >= T - high, as the threshold max(q, floor).  Every thread calls
// it.  Out of line: one copy of this rarer path, so that the unrolled
// slots of the register kernel stay close together in the instruction
// cache.
template <int NT>
__device__ __noinline__ float block_select(float f, bool ge, bool mine,
                                           int G, int count_max, int T,
                                           int low, int high, float w_high,
                                           float w_low, float floor_,
                                           RegSmem<NT>& sm) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned bal = __ballot_sync(kFull, ge);
  const unsigned before = (1u << lane) - 1u;  // the lanes below this one
  const int cw = __popc(bal);
  const int pos = ge ? __popc(bal & before) : cw + __popc(~bal & before);
  sm.seg[32 * w + pos] = ge ? f : INFINITY;
  sm.all[tid] = f;
  const uint32_t kmax =
      __reduce_max_sync(kFull, mine && !ge ? order_key(f) : 0u);
  if (lane == 0) sm.kmax[w] = kmax;
  __syncthreads();
  if (T > count_max) {
    uint32_t key[2];
    select_digits(sm.all, T, low, high, sm.dig, key);
    return threshold(key_value(key[0]), key_value(key[1]), w_high, w_low,
                     floor_);
  }
  if (ge) {  // the stable rank among the values at or above the floor
    // every warp's 32 slots in float4s (+inf past its count is never
    // counted): earlier warps' equal values count, later warps' do not,
    // this warp's by position; four counts, so that no chain of adds
    // runs through every slot
    int r0 = 0, r1 = 0, r2 = 0, r3 = 0;
    const float4* seg = reinterpret_cast<const float4*>(sm.seg);
    for (int v = 0; v < w; ++v) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = seg[8 * v + j];
        r0 += x.x <= f;
        r1 += x.y <= f;
        r2 += x.z <= f;
        r3 += x.w <= f;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 x = seg[8 * w + j];
      r0 += (x.x < f) | ((x.x == f) & (4 * j < pos));
      r1 += (x.y < f) | ((x.y == f) & (4 * j + 1 < pos));
      r2 += (x.z < f) | ((x.z == f) & (4 * j + 2 < pos));
      r3 += (x.w < f) | ((x.w == f) & (4 * j + 3 < pos));
    }
    for (int v = w + 1; v < nw; ++v) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = seg[8 * v + j];
        r0 += x.x < f;
        r1 += x.y < f;
        r2 += x.z < f;
        r3 += x.w < f;
      }
    }
    const int rank = T - G + r0 + r1 + r2 + r3;
    if (rank == low) sm.res[0] = f;
    if (rank == high) sm.res[1] = f;
  }
  if (G < T - low && tid == 0) {  // s[low]: the largest below the floor
    uint32_t m = 0u;
    for (int v = 0; v < nw; ++v) m = max(m, sm.kmax[v]);
    sm.res[0] = key_value(m);
  }
  __syncthreads();
  return threshold(sm.res[0], sm.res[1], w_high, w_low, floor_);
}

// One warp's s[low] and s[high] (T <= 32, a lane a token) once G of
// them lie at or above the floor and G >= T - high, as the threshold
// max(q, floor): stable ranks by 32 shuffles, no barrier.  Out of line,
// as block_select.
__device__ __noinline__ float warp_select(float f, bool ge, bool mine,
                                          int G, int T, int low, int high,
                                          float w_high, float w_low,
                                          float floor_) {
  const int lane = threadIdx.x & 31;
  const float key = ge ? f : INFINITY;  // +inf: not ranked
  int r0 = 0, r1 = 0;
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const float v0 = __shfl_sync(kFull, key, j);
    const float v1 = __shfl_sync(kFull, key, j + 1);
    r0 += (v0 < f) | ((v0 == f) & (j < lane));
    r1 += (v1 < f) | ((v1 == f) & (j + 1 < lane));
  }
  const int rank = T - G + r0 + r1;
  const float hi = __shfl_sync(
      kFull, f, __ffs(__ballot_sync(kFull, ge && rank == high)) - 1);
  const unsigned at_low = __ballot_sync(kFull, ge && rank == low);
  // s[low] below the floor (G = T - low - 1): the largest value there
  const uint32_t kmax =
      __reduce_max_sync(kFull, mine && !ge ? order_key(f) : 0u);
  const float lo = at_low ? __shfl_sync(kFull, f, __ffs(at_low) - 1)
                          : key_value(kmax);
  return threshold(lo, hi, w_high, w_low, floor_);
}

// Slot i's threshold max(q, floor) at f_max < 1, the same in every
// thread, from each thread's benefit b (its token's; -inf past T).
// Every thread of the block calls it.
template <int NT>
__device__ __forceinline__ float reg_threshold(float b, bool mine,
                                               const SteerArgs& a,
                                               int count_max, bool warp,
                                               RegSmem<NT>& sm) {
  const int T = a.T;
  const float f = isfinite(b) ? b : -1e9f;  // what the quantile ranks
  const bool ge = mine && f >= a.floor;
  if (!warp) {  // one barrier counts G; a slot that selects waits again
    const int G = __syncthreads_count(ge);
    if (G < T - a.high) return a.floor;  // s[high] < floor: q <= floor
    return block_select(f, ge, mine, G, count_max, T, a.low, a.high,
                        a.w_high, a.w_low, a.floor, sm);
  }
  // T = 1: s[0] is the token's value f, and with quantile_plan(1, q) =
  // (0, 0, 0, 1) q = f exactly (lanes past the token never steer)
  if (T == 1) return ge ? f : a.floor;
  const int G = __popc(__ballot_sync(kFull, ge));
  if (G < T - a.high) return a.floor;  // s[high] < floor: q <= floor
  return warp_select(f, ge, mine, G, T, a.low, a.high, a.w_high, a.w_low,
                     a.floor);
}

// Up to NT tokens, one a thread, each token's state in registers across
// the k slots: k <= KMAX primaries and d <= DMAX alternates, the slots
// unrolled so that every register index is known.
template <int KMAX, int DMAX, int NT>
__global__ void __launch_bounds__(NT, 1)
    dispatch_steer_kernel(SteerArgs a, int count_max, int warp) {
  __shared__ __align__(16) RegSmem<NT> sm;
  extern __shared__ float4 s_mem[];
  float* s_load = reinterpret_cast<float*>(s_mem);  // E
  const int tid = threadIdx.x, nt = blockDim.x;
  const int k = a.k, d = a.d, kd = a.k + a.d;
  const bool mine = tid < a.T;

  // the token's candidates, every load issued before the first use
  int pid[KMAX], aid[DMAX];
  float pv[KMAX], av[DMAX], pl[KMAX], al[DMAX];
  const size_t row = static_cast<size_t>(mine ? tid : 0) * kd;
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    const bool in = mine && s < k;
    pid[s] = in ? a.cand[row + s] : 0;
    pv[s] = in ? a.vals[row + s] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    const bool in = mine && j < d;
    aid[j] = in ? a.cand[row + k + j] : 0;
    av[j] = in ? a.vals[row + k + j] : 0.0f;
  }
  for (int j = tid; j < a.E; j += nt) s_load[j] = a.load[j];
  const bool block = a.mode == kQuantile && !warp;
  if (block)  // select_digits finds hist[0] zero
    for (int j = tid; j < 2 * kBins; j += nt) (&sm.dig.hist[0][0][0])[j] = 0;
  __syncthreads();
  // up to 8 primaries and 2 alternates their loads stay in registers
  // too; the wide instantiation reads them from shared memory in each
  // slot, or it would spill
  constexpr bool kKeep = KMAX <= 8 && DMAX <= 2;
#pragma unroll
  for (int s = 0; s < KMAX; ++s) pl[s] = kKeep ? s_load[pid[s]] : 0.0f;
#pragma unroll
  for (int j = 0; j < DMAX; ++j) al[j] = kKeep ? s_load[aid[j]] : 0.0f;

  unsigned used = 0u, flags = 0u;  // alternates taken; slots steered
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i >= k) continue;  // k is the same in every thread
    // the least-loaded feasible unused alternate (argmin: the first on
    // ties), as slot_benefit picks it
    const float lp = kKeep ? pl[i] : s_load[pid[i]];
    const float lim_l = lp - a.dl, lim_v = pv[i] - a.slack;
    float best_l = INFINITY, bv = av[0];
    int best = 0, be = aid[0];
    bool has = false;
#pragma unroll
    for (int j = 0; j < DMAX; ++j) {
      if (j < d) {
        const float la = kKeep ? al[j] : s_load[aid[j]];
        const bool ok = !((used >> j) & 1u) && la <= lim_l && av[j] >= lim_v;
        const float masked = ok ? la : INFINITY;
        if (masked < best_l) {
          best = j;
          best_l = masked;
          bv = av[j];
          be = aid[j];
        }
        has = has || ok;
      }
    }
    has = has && mine;
    const float b = has ? lp - best_l : -INFINITY;
    bool steer = false;
    if (a.mode == kMargin) {
      steer = has && b >= a.dl;
    } else if (a.mode == kQuantile) {  // every thread: barriers inside
      const float thr = reg_threshold(b, mine, a, count_max, warp != 0, sm);
      steer = has && b > thr;
    }
    if (steer) {
      used |= 1u << best;
      flags |= 1u << i;
      pid[i] = be;
      pv[i] = bv;
    }
  }
  if (!mine) return;

  // softmax over the k chosen logits, as dispatch_fused, but one
  // division: weights within an ulp or two of ex / sum
  float mx = -INFINITY;
#pragma unroll
  for (int s = 0; s < KMAX; ++s) mx = fmaxf(mx, s < k ? pv[s] : -INFINITY);
  float sum = 0.0f;
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    pv[s] = s < k ? expf(pv[s] - mx) : 0.0f;
    sum += pv[s];
  }
  const float inv = 1.0f / sum;
#pragma unroll
  for (int s = 0; s < KMAX; ++s) pv[s] *= inv;

  // the row once: 16-byte stores where k is a multiple of 4 (rows then
  // start 16-byte aligned), 4-byte ones else
  const size_t o = static_cast<size_t>(tid) * k;
  if ((k & 3) == 0) {
#pragma unroll
    for (int s = 0; s + 3 < KMAX; s += 4)
      if (s < k) {
        const unsigned f4 = (flags >> s) & 15u;
        *reinterpret_cast<int4*>(a.experts + o + s) =
            make_int4(pid[s], pid[s + 1], pid[s + 2], pid[s + 3]);
        *reinterpret_cast<float4*>(a.weights + o + s) =
            make_float4(pv[s], pv[s + 1], pv[s + 2], pv[s + 3]);
        *reinterpret_cast<uint32_t*>(a.steered + o + s) =
            (f4 & 1u) | ((f4 & 2u) << 7) | ((f4 & 4u) << 14) |
            ((f4 & 8u) << 21);
      }
  } else {
#pragma unroll
    for (int s = 0; s < KMAX; ++s)
      if (s < k) {
        a.experts[o + s] = pid[s];
        a.weights[o + s] = pv[s];
        a.steered[o + s] = static_cast<uint8_t>((flags >> s) & 1u);
      }
  }
}

// The register kernel's instantiations (KMAX, DMAX, kRegT threads).
constexpr int kRegT = 512;

template <int KMAX, int DMAX, int NT>
int launch_reg(const SteerArgs& a, int count_max, int warp,
               cudaStream_t stream) {
  const int threads = round_up(a.T, 32);
  const size_t smem = static_cast<size_t>(a.E) * sizeof(float);
  dispatch_steer_kernel<KMAX, DMAX, NT><<<1, threads, smem, stream>>>(
      a, count_max, warp && threads == 32);
  return static_cast<int>(cudaGetLastError());
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
// Up to kRegT tokens the register kernel runs: its select counts ranks
// up to count_max tokens, by shuffles within one warp when warp is set
// and T <= 32, and runs select_digits above.
extern "C" int dispatch_steer_launch(
    const void* cand, const void* vals, const void* load, void* experts,
    void* weights, void* steered, void* scratch, int T, int E, int k, int d,
    int mode, int low, int high, float w_high, float w_low, float delta_l,
    float gate_slack, float floor_, int count_max, int warp, void* stream) {
  if (T <= 0) return 0;
  if (T > kSteerSmemT && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k < 1 || d < 1 || k + d > kMaxKD)
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 8 && d <= 2 && T <= kRegT)
    return launch_reg<8, 2, kRegT>(a, count_max, warp, st);
  if (T <= kRegT)
    return launch_reg<kMaxKD - 1, kMaxKD - 1, kRegT>(a, count_max, warp, st);
  const int threads = T < kMaxThreads ? round_up(T, 32) : kMaxThreads;
  size_t smem = static_cast<size_t>(round_up(E, 4)) * sizeof(float);
  if (T <= kSteerSmemT) smem += static_cast<size_t>(T) * 8;
  dispatch_steer_smem_kernel<<<1, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
