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
// own launch latency, not by the card; fusing the wave loop is later
// work.
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
// route_tick: one tick's G waves of the midas policy in one launch.
//
// Replaces, for the midas policy, the engine's wave loop around the TPU
// kernel above: src/repro/core/sim.py (_route_waves_scan) calls
// src/repro/core/policies/midas.py (route_midas) once a wave, which runs
// route_select's midas test and then the pins, the leaky bucket and the
// history ring as sequential scalar state.  Wave g routes against the
// view L_hat + sent, where sent counts the tick's own sends of the waves
// before it, so the waves run in order, and a tick stays in one block:
// only a block barrier makes wave g's pin writes visible to wave g + 1.
// Under fleet routing (the reference's fleet_routing) wave g is one
// proxy's and routes on that proxy's own view alone: base points at
// (G, m) views, base_stride is m and accumulate is 0, so the view is
// base[g] and no sends are shared; sent still counts every wave's sends
// for the arrivals.  Otherwise base is L_hat, base_stride 0 and
// accumulate 1.
//
// Per wave:
//   1. the view base[g] (+ sent) in shared memory (and in views[g]);
//   2. per row: route_select's midas test and argmin, exactly as
//      route_select_kernel does it (strict '<', slot 0 when no slot is
//      eligible, ids outside [0, m) read 0), with sampled = rank < d
//      and slot 0 cleared; the pin at the row's key; want = eligible &
//      mask & !pinned; the wave's eligible count;
//   3. budget = floor(f_max * elig_win) - steer_win, in float32 and in
//      the plain version's order;
//   4. the rows in chunks of the block: an exclusive scan of want (warp
//      ballots) gives order_rank, allowed = want & order_rank < budget,
//      then the assignment and the wave counts.  An allowed row writes
//      its key's pin unless a later allowed row of its chunk has the
//      same key, and chunks write in order, so the last row of a
//      repeated key wins, as the plain version's set_last does;
//   5. the history slot hist_idx % W, and hist_idx + 1 (W counts waves).
//
// Bound: a tick moves a few tens of KB at the engine's shape (8 waves of
// 64 rows), under 0.02 us at the card's memory rate.  What takes the
// time is the chain of dependent steps (a pin read needs its key; a
// wave needs the last wave's pins and counts) and the barriers.  What
// the kernel removes is the ~100 small PyTorch operations a wave that
// surround route_select on the per-wave path.
//
// The counts (eligible, steered, sent, the histories) are integers held
// in float32, so their sums are exact in any order.  Keys must lie in
// [0, N), as the plain version's gathers require; a key outside reads
// no pin and writes none.  The knobs and the clock are read from device
// pointers, so the host never syncs and a CUDA graph can hold the
// launch.  The dV of the steers is not computed here: it is a float32
// sum over rows, which the caller takes from views and assign with the
// plain version's operations.

namespace {

constexpr int kTickMaxThreads = 256;

struct TickArgs {
  const int64_t* keys;     // (G, Rg)
  const uint8_t* mask;     // (G, Rg)
  const int32_t* feas;     // (G, Rg, d_max)
  const int8_t* rank;      // (G, Rg, d_max)
  const float* tie;        // (G, Rg, d_max)
  const float* base;       // (m,) L_hat, or (G, m) per-wave views
  const float* p50;        // (m,)
  const int32_t* d;        // () knobs and the tick clock
  const float* delta_l;
  const float* delta_t;
  const float* f_max;
  const float* pin_ms;
  const float* now_ms;
  // policy state, updated in place (never read through the read-only
  // cache: this block writes it)
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
  int32_t* hist_idx_out;   // ()
  int G, Rg, d_max, m, N, W;
  int base_stride;         // 0 (one shared view) or m (a view a wave)
  int accumulate;          // 1: add the earlier waves' sends to the view
};

constexpr uint8_t kWant = 1, kAllowed = 2, kMask = 4;

__global__ void route_tick_kernel(TickArgs a) {
  extern __shared__ float smem[];
  float* s_sent = smem;
  float* s_view = s_sent + a.m;
  float* s_p50 = s_view + a.m;
  int32_t* s_best = reinterpret_cast<int32_t*>(s_p50 + a.m);
  int32_t* s_other = s_best + a.Rg;  // the assignment unless allowed
  int32_t* s_key = s_other + a.Rg;   // the key, or -1 outside [0, N)
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_key + a.Rg);
  __shared__ int s_warp[32];
  __shared__ int s_elig, s_steer;
  __shared__ float s_elig_sum, s_steer_sum;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;  // a multiple of 32
  const int d = *a.d;
  const float dl = *a.delta_l;
  const float dt = *a.delta_t;
  const float f_max = *a.f_max;
  const float now = *a.now_ms;
  const float expiry = now + *a.pin_ms;
  const int W = a.W;
  int hidx = *a.hist_idx;

  for (int j = tid; j < a.m; j += nthreads) {
    s_sent[j] = 0.0f;
    s_p50[j] = a.p50[j];
  }
  if (tid == 0) {
    float es = 0.0f, ss = 0.0f;
    for (int w = 0; w < W; ++w) {
      es += a.elig_hist[w];
      ss += a.steer_hist[w];
    }
    s_elig_sum = es;
    s_steer_sum = ss;
    s_elig = 0;
    s_steer = 0;
  }
  int steered_total = 0, elig_total = 0;  // thread 0's
  __syncthreads();

  for (int g = 0; g < a.G; ++g) {
    // 1. the view
    const float* base = a.base + static_cast<size_t>(g) * a.base_stride;
    for (int j = tid; j < a.m; j += nthreads) {
      const float v = a.accumulate ? base[j] + s_sent[j] : base[j];
      s_view[j] = v;
      a.views[static_cast<size_t>(g) * a.m + j] = v;
    }
    __syncthreads();

    // 2. each row: eligibility, argmin, pin; the thread of row r here is
    // the thread of row r in step 4
    const size_t row0 = static_cast<size_t>(g) * a.Rg;
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

    // 3. the leaky bucket over the window, this wave included
    const int hi = ((hidx % W) + W) % W;
    const int elig_now = s_elig;
    const float e_i = a.elig_hist[hi];
    const float s_i = a.steer_hist[hi];
    const float elig_win = (s_elig_sum - e_i) + static_cast<float>(elig_now);
    const float steer_win = s_steer_sum - s_i;
    const float budget = floorf(f_max * elig_win) - steer_win;

    // 4. the rows in order, a block-sized chunk at a time
    int carry = 0;  // want rows before the chunk
    int my_steer = 0;
    for (int base = 0; base < a.Rg; base += nthreads) {
      const int r = base + tid;
      const bool in_wave = r < a.Rg;
      const uint8_t fl = in_wave ? s_flag[r] : 0;
      const bool want = (fl & kWant) != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, want);
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
        a.assign[row0 + r] = out;
        if ((fl & kMask) && out >= 0 && out < a.m) {
          atomicAdd(&s_sent[out], 1.0f);
        }
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
    __syncthreads();  // pins, counts and s_steer complete

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

  for (int j = tid; j < a.m; j += nthreads) a.arrivals[j] = s_sent[j];
  if (tid == 0) {
    *a.steered = static_cast<float>(steered_total);
    *a.eligible = static_cast<float>(elig_total);
    *a.hist_idx_out = hidx;
  }
}

}  // namespace

// C interface for ctypes: device pointers in TickArgs order, then the
// sizes, the view's stride and accumulate flag, and the stream.  Returns the cudaError_t of the launch.
extern "C" int route_tick_launch(
    const void* keys, const void* mask, const void* feas, const void* rank,
    const void* tie, const void* base, const void* p50, const void* d,
    const void* delta_l, const void* delta_t, const void* f_max,
    const void* pin_ms, const void* now_ms, void* pin_server,
    void* pin_expiry, void* steer_hist, void* elig_hist,
    const void* hist_idx, void* assign, void* views, void* arrivals,
    void* steered, void* eligible, void* hist_idx_out, int G, int Rg,
    int d_max, int m, int N, int W, int base_stride, int accumulate,
    void* stream) {
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
  a.hist_idx_out = static_cast<int32_t*>(hist_idx_out);
  a.G = G;
  a.Rg = Rg;
  a.d_max = d_max;
  a.m = m;
  a.N = N;
  a.W = W;
  a.base_stride = base_stride;
  a.accumulate = accumulate;
  int threads = (Rg + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads;
  threads = threads > kTickMaxThreads ? kTickMaxThreads : threads;
  const size_t smem = 3 * static_cast<size_t>(m) * sizeof(float) +
                      3 * static_cast<size_t>(Rg) * sizeof(int32_t) +
                      static_cast<size_t>(Rg);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        route_tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  route_tick_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
