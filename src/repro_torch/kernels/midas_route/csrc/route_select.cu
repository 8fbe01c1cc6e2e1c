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
