// route_select: the simulator's per-wave routing core, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/midas_route/kernel.py
// (_route_body, launched from route_select).  For each request row r it
// gathers the stale queue view lf[j] = load[feas[r, j]] (and p50 in
// midas mode) over the d_max feasible slots, applies the mode's test and
// writes assign[r] = feas[r, slot]:
//   power_of_d: argmin_j (sampled ? lf : inf) + tie
//   midas:      ok_j = sampled & lf <= lf[0] - dL & p50f <= p50f[0] - dT;
//               argmin_j (ok ? lf : inf) + tie, and ok_any = any_j ok_j
//   chbl:       the first slot with lf <= cap, else argmin_j lf
// The TPU kernel gathers by a one-hot (tile, d_max, m) contraction,
// which suits its matrix unit; here each thread gathers directly.
//
// Bound: the work is compares and one float add per slot, so the kernel
// is bound by bytes: each row reads d_max int32 ids, d_max sampling
// bytes and d_max float32 tie scores and writes 5 bytes, plus the 2m
// floats of telemetry once.  At the engine's per-wave shape (R = 64,
// m = 64, d_max = 4) that is about 3 KB, so a launch is bound by its
// own launch latency, not by the card.  The engine's hoisted loop routes
// a whole tick through route_tick below instead; this kernel stays for
// the unrolled engine (E10's "before") and for ops.route_waves.
//
// Design: one thread per row, 256 threads per block, ceil(R / 256)
// blocks, and the ragged last block masked.  load and p50 are staged in
// shared memory per block.  The loop over slots uses strict '<', so ties
// go to the first index, as jnp.argmin does; an all-ineligible row picks
// slot 0.  The scalars dL, dT and cap are read from a device pointer, so
// the host never syncs to launch.  Ids outside [0, m) read a load of 0,
// as the one-hot gather does.  Build with -fmad=false and without fast
// math: the result must equal the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPowerOfD = 0;
constexpr int kMidas = 1;
constexpr int kChbl = 2;

template <int MODE>
__global__ void route_select_kernel(
    const int32_t* __restrict__ feas, const uint8_t* __restrict__ sampled,
    const float* __restrict__ tie, const float* __restrict__ load,
    const float* __restrict__ p50, const float* __restrict__ scalars,
    int32_t* __restrict__ assign, uint8_t* __restrict__ ok_any, int R,
    int d_max, int m) {
  extern __shared__ float smem[];
  float* s_load = smem;
  float* s_p50 = smem + m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s_load[i] = load[i];
    if (MODE == kMidas) s_p50[i] = p50[i];
  }
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int32_t* f = feas + static_cast<size_t>(r) * d_max;
  const uint8_t* s = sampled + static_cast<size_t>(r) * d_max;
  const float* t = tie + static_cast<size_t>(r) * d_max;

  int slot = 0;
  bool any_ok = false;
  if (MODE == kChbl) {
    const float cap = scalars[2];
    int first_under = -1;
    int least = 0;
    float least_v = 0.0f;
    for (int j = 0; j < d_max; ++j) {
      const int id = f[j];
      const float lf = (id >= 0 && id < m) ? s_load[id] : 0.0f;
      if (first_under < 0 && lf <= cap) first_under = j;
      if (j == 0 || lf < least_v) {
        least_v = lf;
        least = j;
      }
    }
    slot = first_under >= 0 ? first_under : least;
  } else {
    float l0 = 0.0f, q0 = 0.0f, dl = 0.0f, dt = 0.0f;
    if (MODE == kMidas) {
      dl = scalars[0];
      dt = scalars[1];
    }
    float best = 0.0f;
    for (int j = 0; j < d_max; ++j) {
      const int id = f[j];
      const bool in = id >= 0 && id < m;
      const float lf = in ? s_load[id] : 0.0f;
      bool ok = s[j] != 0;
      if (MODE == kMidas) {
        const float qf = in ? s_p50[id] : 0.0f;
        if (j == 0) {
          l0 = lf;
          q0 = qf;
        }
        ok = ok && (lf <= l0 - dl) && (qf <= q0 - dt);
        any_ok = any_ok || ok;
      }
      const float v = (ok ? lf : INFINITY) + t[j];
      if (j == 0 || v < best) {
        best = v;
        slot = j;
      }
    }
  }
  assign[r] = f[slot];
  ok_any[r] = any_ok ? 1 : 0;
}

template <int MODE>
void launch(const void* feas, const void* sampled, const void* tie,
            const void* load, const void* p50, const void* scalars,
            void* assign, void* ok_any, int R, int d_max, int m,
            cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads);
  const size_t smem = 2 * static_cast<size_t>(m) * sizeof(float);
  route_select_kernel<MODE><<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(feas),
      static_cast<const uint8_t*>(sampled), static_cast<const float*>(tie),
      static_cast<const float*>(load), static_cast<const float*>(p50),
      static_cast<const float*>(scalars), static_cast<int32_t*>(assign),
      static_cast<uint8_t*>(ok_any), R, d_max, m);
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers; stream is a
// cudaStream_t.  Returns the cudaError_t of the launch (0 on success).
extern "C" int route_select_launch(const void* feas, const void* sampled,
                                   const void* tie, const void* load,
                                   const void* p50, const void* scalars,
                                   void* assign, void* ok_any, int R,
                                   int d_max, int m, int mode,
                                   void* stream) {
  if (R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPowerOfD:
      launch<kPowerOfD>(feas, sampled, tie, load, p50, scalars, assign,
                        ok_any, R, d_max, m, st);
      break;
    case kMidas:
      launch<kMidas>(feas, sampled, tie, load, p50, scalars, assign,
                     ok_any, R, d_max, m, st);
      break;
    case kChbl:
      launch<kChbl>(feas, sampled, tie, load, p50, scalars, assign,
                    ok_any, R, d_max, m, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// route_tick: one tick's G waves of one of route_select's policies in one
// launch, with the tick's steering dV.
//
// Replaces the engine's wave loop around the TPU kernel above:
// src/repro/core/sim.py (_route_waves_scan) calls a policy's route once a
// wave (src/repro/core/policies/midas.py route_midas, power_of_d.py
// route_power_of_d, bounded_load.py route_bounded_load), which runs
// route_select's test, for midas then the pins, the leaky bucket and the
// history ring as sequential scalar state, and for every policy the
// wave's steering dV (policies/base.py steering_dv).  Wave g routes
// against the view L_hat + sent, where sent counts the tick's own sends of
// the waves before it, so the waves run in order, and a tick stays in one
// block: only a block barrier makes wave g's sends and pin writes visible
// to wave g + 1.  Under fleet routing (the reference's fleet_routing) wave
// g is one proxy's and routes on that proxy's own view alone: base points
// at (G, m) views, base_stride is m and accumulate is 0, so the view is
// base[g] and no sends are shared; sent still counts every wave's sends
// for the arrivals.  Otherwise base is L_hat, base_stride 0 and
// accumulate 1.
//
// The mode, a template parameter, is the policy:
//   power_of_d: sampled = rank < d over every slot, slot 0 included;
//               argmin_j (sampled ? lf : inf) + tie.  No state.
//   chbl:       the first slot with lf <= cap, else the least loaded
//               (strict '<'); the cap from the wave's own view (below);
//               steered counts mask & assign != primary.  No state.
//   midas:      route_select's midas test with sampled = rank < d and
//               slot 0 cleared, then the pins, the bucket and the ring.
// In every mode ties go to the first slot, an all-ineligible row picks
// slot 0, ids outside [0, m) read a load of 0, and a row whose mask is
// clear is assigned -1.
//
// Per wave:
//   1. warp 0 sums the previous wave's dV terms (below); the view
//      base[g] (+ sent) in shared memory and in views[g];
//   2. chbl: warp 0 computes the cap on this view;
//   3. per row: the mode's test and argmin, exactly as route_select_kernel
//      does it.  power_of_d and chbl then assign, count the sends and write
//      the row's dV term; midas takes the pin at the row's key, want =
//      eligible & mask & !pinned, and the wave's eligible count;
//   4. midas: budget = floor(f_max * elig_win) - steer_win, in float32 and
//      in the plain version's order; the rows in chunks of the block: an
//      exclusive scan of want (warp ballots) gives order_rank, allowed =
//      want & order_rank < budget, then the assignment, the sends and the
//      row's dV term.  An allowed row writes its key's pin unless a later
//      allowed row of its chunk has the same key, and chunks write in
//      order, so the last row of a repeated key wins, as the plain
//      version's set_last does;
//   5. midas: the history slot hist_idx % W, and hist_idx + 1 (W counts
//      waves).
// A row's dV term is moved ? 2 * (view[a] - view[p]) + 2 : +0.0, with
// p = feas[row, 0] and moved = mask & a != p & a >= 0, on the view the
// wave was routed on; the multiply and the add round apart, as
// steering_dv computes them.
//
// Sum orders.  The plain version computes as the reference does on the
// CPU (core/xla.py), and the kernel takes the same orders, one add at a
// time, by one warp:
//   reduce_sum: up to 32 elements left to right from the first; above,
//     32k - n zeros (+0.0) padded, (32k - n) / 2 of them in front, each
//     window of 32 summed left to right (one lane a window), and the k
//     window sums reduced by the same rule: at most two levels of windows
//     for m <= 6144 and Rg <= 8192;
//   loop_sum (a wave's dV): below 16 terms left to right; from 16 to 32
//     sixteen lanes over the first 16 * (n / 16) terms, folded in halves
//     8, 4, 2, 1 (shuffles), then the rest left to right; above 32
//     reduce_sum's windows.
// The tick's dV is the wave sums added to +0.0 in wave order, as the
// engine adds the waves' RouteStats.  chbl's cap is bounded_load.py's
// load_cap, fma(reduce_sum(view), 1/m, 1) * c, and the plain version's
// fma is float64 arithmetic rounded to float32: the product of two
// floats is exact in float64, the add rounds to float64, then the sum
// to float32.  Rounded twice, that can differ from one float32 fmaf (a
// float64 sum on a float32 midpoint), and the kernel is held to the
// plain version, so it rounds the same way and never calls fmaf.
// float32(1/m) and c come from the host as the plain version rounds them.
//
// Bound: a tick moves a few tens of KB at the engine's shape (8 waves of
// 64 rows), under 0.02 us at the card's memory rate.  What takes the
// time is the chain of dependent steps (a wave needs the last wave's
// sends; a midas pin read needs its key) and the barriers.  What the
// kernel removes is the small PyTorch operations a wave that surround
// route_select on the per-wave path: ~100 for midas, ~40 for power_of_d
// and chbl, most of them the dV's sum order.
//
// The counts (eligible, steered, sent, the histories) are integers held
// in float32, so their sums are exact in any order.  Keys must lie in
// [0, N), as the plain version's gathers require; a key outside reads
// no pin and writes none.  The knobs and the clock are read from device
// pointers, so the host never syncs and a CUDA graph can hold the
// launch.
//
// Shared memory: 2m float32 (the sends and the view) and one float32 a
// row (the dV terms); midas adds m float32 (p50) and 13 bytes a row.  At
// MAX_M = 6144 and MAX_RG = 8192 that is 80 KB (power_of_d, chbl) and
// 208 KB (midas) of dynamic shared memory, with 1.3 KB static, of the
// block's 227 KB.

namespace {

constexpr int kTickMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// the warp sums' window sums: ceil(8192 / 32) at the first level, and
// ceil(256 / 32) at the second
constexpr int kScratchA = 256, kScratchB = 32;

struct TickArgs {
  const int64_t* keys;     // (G, Rg)              midas
  const uint8_t* mask;     // (G, Rg)
  const int32_t* feas;     // (G, Rg, d_max)
  const int8_t* rank;      // (G, Rg, d_max)       midas, power_of_d
  const float* tie;        // (G, Rg, d_max)       midas, power_of_d
  const float* base;       // (m,) L_hat, or (G, m) per-wave views
  const float* p50;        // (m,)                 midas
  const int32_t* d;        // () knobs and the tick clock: d for midas and
  const float* delta_l;    //    power_of_d, the rest for midas
  const float* delta_t;
  const float* f_max;
  const float* pin_ms;
  const float* now_ms;
  // midas's policy state, updated in place (never read through the
  // read-only cache: this block writes it)
  int32_t* pin_server;     // (N,)
  float* pin_expiry;       // (N,)
  float* steer_hist;       // (W,)
  float* elig_hist;        // (W,)
  const int32_t* hist_idx;  // ()
  // outputs
  int32_t* assign;         // (G, Rg)
  float* views;            // (G, m)
  float* arrivals;         // (m,)
  float* steered;          // ()
  float* eligible;         // ()
  float* dv;               // ()
  int32_t* hist_idx_out;   // ()                   midas
  int G, Rg, d_max, m, N, W;
  int base_stride;         // 0 (one shared view) or m (a view a wave)
  int accumulate;          // 1: add the earlier waves' sends to the view
  float inv_m, c;          // chbl: float32(1/m) and the capacity factor
};

constexpr uint8_t kWant = 1, kAllowed = 2, kMask = 4;

// XLA's reduce_sum order over x[0, n), by the calling warp (all 32 lanes
// call it); sa and sb hold the window sums.  Every lane gets the sum.
__device__ float warp_reduce_sum(const float* x, int n, float* sa,
                                 float* sb) {
  const int lane = threadIdx.x & 31;
  const float* in = x;
  float* out = sa;
  while (n > 32) {
    const int k = (n + 31) / 32;
    const int front = (32 * k - n) / 2;
    for (int w = lane; w < k; w += 32) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int q = 32 * w + i - front;
        v[i] = (q >= 0 && q < n) ? in[q] : 0.0f;
      }
      float acc = v[0];
#pragma unroll
      for (int i = 1; i < 32; ++i) acc = __fadd_rn(acc, v[i]);
      out[w] = acc;
    }
    __syncwarp();
    in = out;
    out = out == sa ? sb : sa;
    n = k;
  }
  float acc = 0.0f;
  if (lane == 0 && n > 0) {
    acc = in[0];
    for (int i = 1; i < n; ++i) acc = __fadd_rn(acc, in[i]);
  }
  return __shfl_sync(kFull, acc, 0);
}

// xla.loop_sum's order over x[0, n), by the calling warp; every lane gets
// the sum (+0.0 for n = 0).
__device__ float warp_loop_sum(const float* x, int n, float* sa,
                               float* sb) {
  if (n > 32) return warp_reduce_sum(x, n, sa, sb);
  const int lane = threadIdx.x & 31;
  const int nv = n / 16 * 16;
  float acc = 0.0f;
  if (nv > 0) {
    if (lane < 16) {
      acc = x[lane];
      if (nv == 32) acc = __fadd_rn(acc, x[16 + lane]);
    }
#pragma unroll
    for (int h = 8; h >= 1; h >>= 1) {
      acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, h));
    }
    if (lane == 0) {
      for (int i = nv; i < n; ++i) acc = __fadd_rn(acc, x[i]);
    }
  } else if (lane == 0 && n > 0) {
    acc = x[0];
    for (int i = 1; i < n; ++i) acc = __fadd_rn(acc, x[i]);
  }
  return __shfl_sync(kFull, acc, 0);
}

// A row's steering dV term on the wave's view (see the head comment).
__device__ __forceinline__ float dv_term(const float* view, int32_t out,
                                         int32_t prim, bool msk, int m) {
  if (!msk || out == prim || out < 0) return 0.0f;
  const float va = out < m ? view[out] : 0.0f;
  const float vp = prim >= 0 && prim < m ? view[prim] : 0.0f;
  return __fadd_rn(__fmul_rn(2.0f, __fsub_rn(va, vp)), 2.0f);
}

template <int MODE>
__global__ void route_tick_kernel(TickArgs a) {
  extern __shared__ float smem[];
  float* s_sent = smem;
  float* s_view = s_sent + a.m;
  float* s_term = s_view + a.m;  // the wave's dV terms
  // midas only
  float* s_p50 = s_term + a.Rg;
  int32_t* s_best = reinterpret_cast<int32_t*>(s_p50 + a.m);
  int32_t* s_other = s_best + a.Rg;  // the assignment unless allowed
  int32_t* s_key = s_other + a.Rg;   // the key, or -1 outside [0, N)
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_key + a.Rg);
  __shared__ float s_red[kScratchA + kScratchB];
  __shared__ int s_warp[32];
  __shared__ int s_elig, s_steer;
  __shared__ float s_elig_sum, s_steer_sum, s_cap;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;  // a multiple of 32
  const int d = MODE == kChbl ? 0 : *a.d;
  float dl = 0.0f, dt = 0.0f, f_max = 0.0f, now = 0.0f, expiry = 0.0f;
  const int W = a.W;
  int hidx = 0;
  if (MODE == kMidas) {
    dl = *a.delta_l;
    dt = *a.delta_t;
    f_max = *a.f_max;
    now = *a.now_ms;
    expiry = now + *a.pin_ms;
    hidx = *a.hist_idx;
  }

  for (int j = tid; j < a.m; j += nthreads) {
    s_sent[j] = 0.0f;
    if (MODE == kMidas) s_p50[j] = a.p50[j];
  }
  if (tid == 0) {
    if (MODE == kMidas) {
      float es = 0.0f, ss = 0.0f;
      for (int w = 0; w < W; ++w) {
        es += a.elig_hist[w];
        ss += a.steer_hist[w];
      }
      s_elig_sum = es;
      s_steer_sum = ss;
    }
    s_elig = 0;
    s_steer = 0;
  }
  // thread 0's
  int steered_total = 0, elig_total = 0;
  float dv_total = 0.0f;
  __syncthreads();

  for (int g = 0; g < a.G; ++g) {
    // 1. the last wave's dV (a barrier completed its terms), and the view
    if (warp == 0 && g > 0) {
      const float s = warp_loop_sum(s_term, a.Rg, s_red, s_red + kScratchA);
      if (lane == 0) dv_total = __fadd_rn(dv_total, s);
    }
    const float* base = a.base + static_cast<size_t>(g) * a.base_stride;
    for (int j = tid; j < a.m; j += nthreads) {
      const float v = a.accumulate ? __fadd_rn(base[j], s_sent[j]) : base[j];
      s_view[j] = v;
      a.views[static_cast<size_t>(g) * a.m + j] = v;
    }
    __syncthreads();

    // 2. chbl's cap: fma(reduce_sum(view), 1/m, 1) * c, the fma in
    // float64 and rounded to float32, as the plain version computes it
    if (MODE == kChbl) {
      if (warp == 0) {
        const float sum =
            warp_reduce_sum(s_view, a.m, s_red, s_red + kScratchA);
        if (lane == 0) {
          const double mean1 = __dadd_rn(
              __dmul_rn(static_cast<double>(sum),
                        static_cast<double>(a.inv_m)),
              1.0);
          s_cap = __fmul_rn(__double2float_rn(mean1), a.c);
        }
      }
      __syncthreads();
    }

    const size_t row0 = static_cast<size_t>(g) * a.Rg;
    if (MODE != kMidas) {
      // 3. each row, in one pass: power_of_d and chbl carry no state
      int my_moved = 0;
      for (int r = tid; r < a.Rg; r += nthreads) {
        const size_t row = row0 + r;
        const int32_t* f = a.feas + row * a.d_max;
        int slot = 0;
        if (MODE == kChbl) {
          const float cap = s_cap;
          int first_under = -1;
          int least = 0;
          float least_v = 0.0f;
          for (int j = 0; j < a.d_max; ++j) {
            const int id = f[j];
            const float lf = (id >= 0 && id < a.m) ? s_view[id] : 0.0f;
            if (first_under < 0 && lf <= cap) first_under = j;
            if (j == 0 || lf < least_v) {
              least_v = lf;
              least = j;
            }
          }
          slot = first_under >= 0 ? first_under : least;
        } else {
          const int8_t* rk = a.rank + row * a.d_max;
          const float* t = a.tie + row * a.d_max;
          float best = 0.0f;
          for (int j = 0; j < a.d_max; ++j) {
            const int id = f[j];
            const float lf = (id >= 0 && id < a.m) ? s_view[id] : 0.0f;
            const bool ok = static_cast<int>(rk[j]) < d;
            const float v = __fadd_rn(ok ? lf : INFINITY, t[j]);
            if (j == 0 || v < best) {
              best = v;
              slot = j;
            }
          }
        }
        const bool msk = a.mask[row] != 0;
        const int32_t prim = f[0];
        const int32_t out = msk ? f[slot] : -1;
        a.assign[row] = out;
        s_term[r] = dv_term(s_view, out, prim, msk, a.m);
        if (msk && out >= 0 && out < a.m) atomicAdd(&s_sent[out], 1.0f);
        if (MODE == kChbl) my_moved += (msk && out != prim) ? 1 : 0;
      }
      if (MODE == kChbl && my_moved) atomicAdd(&s_steer, my_moved);
      __syncthreads();  // the sends, the terms and s_steer are complete
      if (MODE == kChbl && tid == 0) {
        steered_total += s_steer;
        s_steer = 0;
      }
      continue;
    }

    // 3. midas, each row: eligibility, argmin, pin; the thread of row r
    // here is the thread of row r in step 4
    int my_want = 0;
    for (int r = tid; r < a.Rg; r += nthreads) {
      const size_t row = row0 + r;
      const int32_t* f = a.feas + row * a.d_max;
      const int8_t* rk = a.rank + row * a.d_max;
      const float* t = a.tie + row * a.d_max;
      float l0 = 0.0f, q0 = 0.0f, best = 0.0f;
      int slot = 0;
      bool any_ok = false;
      for (int j = 0; j < a.d_max; ++j) {
        const int id = f[j];
        const bool in = id >= 0 && id < a.m;
        const float lf = in ? s_view[id] : 0.0f;
        const float qf = in ? s_p50[id] : 0.0f;
        if (j == 0) {
          l0 = lf;
          q0 = qf;
        }
        bool ok = j > 0 && static_cast<int>(rk[j]) < d;
        ok = ok && (lf <= l0 - dl) && (qf <= q0 - dt);
        any_ok = any_ok || ok;
        const float v = (ok ? lf : INFINITY) + t[j];
        if (j == 0 || v < best) {
          best = v;
          slot = j;
        }
      }
      const bool msk = a.mask[row] != 0;
      const int64_t key = a.keys[row];
      const bool key_in = key >= 0 && key < a.N;
      int32_t pin_s = -1;
      float pin_e = 0.0f;
      if (key_in) {
        pin_s = a.pin_server[key];
        pin_e = a.pin_expiry[key];
      }
      const bool pinned = msk && key_in && pin_e > now && pin_s >= 0;
      const bool want = any_ok && msk && !pinned;
      s_best[r] = f[slot];
      s_other[r] = !msk ? -1 : (pinned ? pin_s : f[0]);
      s_key[r] = key_in ? static_cast<int32_t>(key) : -1;
      s_flag[r] = (want ? kWant : 0) | (msk ? kMask : 0);
      my_want += want ? 1 : 0;
    }
    if (my_want) atomicAdd(&s_elig, my_want);
    __syncthreads();

    // 4. the leaky bucket over the window, this wave included
    const int hi = ((hidx % W) + W) % W;
    const int elig_now = s_elig;
    const float e_i = a.elig_hist[hi];
    const float s_i = a.steer_hist[hi];
    const float elig_win = (s_elig_sum - e_i) + static_cast<float>(elig_now);
    const float steer_win = s_steer_sum - s_i;
    const float budget = floorf(f_max * elig_win) - steer_win;

    // the rows in order, a block-sized chunk at a time
    int carry = 0;  // want rows before the chunk
    int my_steer = 0;
    for (int base = 0; base < a.Rg; base += nthreads) {
      const int r = base + tid;
      const bool in_wave = r < a.Rg;
      const uint8_t fl = in_wave ? s_flag[r] : 0;
      const bool want = (fl & kWant) != 0;
      const unsigned ballot = __ballot_sync(kFull, want);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      int before = carry + __popc(ballot & ((1u << lane) - 1u));
      int chunk = 0;
      for (int w = 0; w < nthreads / 32; ++w) {
        const int c = s_warp[w];
        if (w < warp) before += c;
        chunk += c;
      }
      carry += chunk;
      const bool allowed = want && static_cast<float>(before) < budget;
      if (in_wave) {
        const int32_t out = allowed ? s_best[r] : s_other[r];
        const bool msk = (fl & kMask) != 0;
        a.assign[row0 + r] = out;
        s_term[r] = dv_term(s_view, out, a.feas[(row0 + r) * a.d_max], msk,
                            a.m);
        if (msk && out >= 0 && out < a.m) atomicAdd(&s_sent[out], 1.0f);
        if (allowed) s_flag[r] = fl | kAllowed;
        my_steer += allowed ? 1 : 0;
      }
      __syncthreads();  // the chunk's flags are set; s_warp is free
      if (allowed && s_key[r] >= 0) {
        const int32_t key = s_key[r];
        const int end = min(base + nthreads, a.Rg);
        bool last = true;
        for (int q = r + 1; q < end && last; ++q) {
          last = !((s_flag[q] & kAllowed) && s_key[q] == key);
        }
        if (last) {
          a.pin_server[key] = s_best[r];
          a.pin_expiry[key] = expiry;
        }
      }
    }
    if (my_steer) atomicAdd(&s_steer, my_steer);
    __syncthreads();  // pins, counts, terms and s_steer complete

    // 5. the history ring
    if (tid == 0) {
      const int steer_now = s_steer;
      a.steer_hist[hi] = static_cast<float>(steer_now);
      a.elig_hist[hi] = static_cast<float>(elig_now);
      s_steer_sum = (s_steer_sum - s_i) + static_cast<float>(steer_now);
      s_elig_sum = (s_elig_sum - e_i) + static_cast<float>(elig_now);
      steered_total += steer_now;
      elig_total += elig_now;
      s_steer = 0;
      s_elig = 0;
    }
    ++hidx;
    __syncthreads();
  }

  // the last wave's dV
  if (warp == 0 && a.G > 0) {
    const float s = warp_loop_sum(s_term, a.Rg, s_red, s_red + kScratchA);
    if (lane == 0) dv_total = __fadd_rn(dv_total, s);
  }
  for (int j = tid; j < a.m; j += nthreads) a.arrivals[j] = s_sent[j];
  if (tid == 0) {
    *a.steered = static_cast<float>(steered_total);
    *a.eligible = static_cast<float>(elig_total);
    *a.dv = dv_total;
    if (MODE == kMidas) *a.hist_idx_out = hidx;
  }
}

template <int MODE>
int launch_tick(const TickArgs& a, cudaStream_t stream) {
  int threads = (a.Rg + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads;
  threads = threads > kTickMaxThreads ? kTickMaxThreads : threads;
  size_t smem = (2 * static_cast<size_t>(a.m) + a.Rg) * sizeof(float);
  if (MODE == kMidas) {
    smem += static_cast<size_t>(a.m) * sizeof(float) +
            3 * static_cast<size_t>(a.Rg) * sizeof(int32_t) + a.Rg;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        route_tick_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  route_tick_kernel<MODE><<<1, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes: device pointers in TickArgs order (null where
// the mode reads none), then the sizes, the view's stride and accumulate
// flag, the mode (route_select's numbering), chbl's float32(1/m) and
// capacity factor, and the stream.  Returns the cudaError_t of the
// launch.
extern "C" int route_tick_launch(
    const void* keys, const void* mask, const void* feas, const void* rank,
    const void* tie, const void* base, const void* p50, const void* d,
    const void* delta_l, const void* delta_t, const void* f_max,
    const void* pin_ms, const void* now_ms, void* pin_server,
    void* pin_expiry, void* steer_hist, void* elig_hist,
    const void* hist_idx, void* assign, void* views, void* arrivals,
    void* steered, void* eligible, void* dv, void* hist_idx_out, int G,
    int Rg, int d_max, int m, int N, int W, int base_stride, int accumulate,
    int mode, float inv_m, float c, void* stream) {
  TickArgs a;
  a.keys = static_cast<const int64_t*>(keys);
  a.mask = static_cast<const uint8_t*>(mask);
  a.feas = static_cast<const int32_t*>(feas);
  a.rank = static_cast<const int8_t*>(rank);
  a.tie = static_cast<const float*>(tie);
  a.base = static_cast<const float*>(base);
  a.p50 = static_cast<const float*>(p50);
  a.d = static_cast<const int32_t*>(d);
  a.delta_l = static_cast<const float*>(delta_l);
  a.delta_t = static_cast<const float*>(delta_t);
  a.f_max = static_cast<const float*>(f_max);
  a.pin_ms = static_cast<const float*>(pin_ms);
  a.now_ms = static_cast<const float*>(now_ms);
  a.pin_server = static_cast<int32_t*>(pin_server);
  a.pin_expiry = static_cast<float*>(pin_expiry);
  a.steer_hist = static_cast<float*>(steer_hist);
  a.elig_hist = static_cast<float*>(elig_hist);
  a.hist_idx = static_cast<const int32_t*>(hist_idx);
  a.assign = static_cast<int32_t*>(assign);
  a.views = static_cast<float*>(views);
  a.arrivals = static_cast<float*>(arrivals);
  a.steered = static_cast<float*>(steered);
  a.eligible = static_cast<float*>(eligible);
  a.dv = static_cast<float*>(dv);
  a.hist_idx_out = static_cast<int32_t*>(hist_idx_out);
  a.G = G;
  a.Rg = Rg;
  a.d_max = d_max;
  a.m = m;
  a.N = N;
  a.W = W;
  a.base_stride = base_stride;
  a.accumulate = accumulate;
  a.inv_m = inv_m;
  a.c = c;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPowerOfD:
      return launch_tick<kPowerOfD>(a, st);
    case kMidas:
      return launch_tick<kMidas>(a, st);
    case kChbl:
      return launch_tick<kChbl>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
