// midas_dispatch: the MoE layer's MIDAS expert dispatch, for sm_90a.
//
// Two kernels, the two passes of the Pallas TPU kernel
// src/repro/kernels/midas_route/kernel.py (midas_dispatch):
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
//                        int32 and logits (T, k+d) float32.  The batch-wide
//                        f_max quantile and the steering follow in PyTorch
//                        (ref.steer_from_candidates), as between the TPU
//                        kernel's two passes.
//
// Selection is k+d rounds of argmax over the row, each round excluding
// the experts already taken; equal logits go to the lowest expert id, as
// jax.lax.top_k and the TPU kernel's iterated argmax rank them.
//
// Bound: a row reads E float32 logits and writes (k+d)·8 or k·9 bytes,
// and the selection is (k+d)·E compares; at the serving shape (E = 128,
// k + d = 10) that is 512 bytes against 1280 compares a row, so the
// kernel is bound by bytes (0.08 µs at T = 512), and at one decode token
// by its own launch latency.
//
// Design: one warp per token row, 8 rows per 256-thread block, ragged T
// masked per warp.  Lane l holds the logits l, l + 32, ... in registers
// (PER_LANE = ceil(E / 32), a template parameter, E <= 1024) and a bit
// mask of the ones taken.  A round takes each lane's best untaken logit
// (strict '>' in increasing id order keeps the lowest id) and reduces
// (logit, id) over the warp by xor shuffles, ties to the lower id, so
// every lane ends the round with the same winner; lane r keeps round r's
// winner.  The fused kernel stages load (E float32) in shared memory,
// and every lane runs the k-slot steering loop on the same shuffled
// values (the alternates' used-mask in a register), so the warp stays
// converged; lane i keeps slot i's result and writes it.  Build with
// -fmad=false and without fast math: experts and steered must equal the
// plain PyTorch version bit for bit, and the comparisons use the same
// float32 subtractions.  Logits must not be NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

// The kd best logits of one row (lowest id first on ties).  On return,
// lane r < kd holds round r's winner in (id, val).
template <int PER_LANE>
__device__ __forceinline__ void select_top(const float* __restrict__ row,
                                           int E, int kd, int lane,
                                           int& id, float& val) {
  float v[PER_LANE];
  unsigned taken = 0;  // bit s: element s * 32 + lane taken or absent
#pragma unroll
  for (int s = 0; s < PER_LANE; ++s) {
    const int e = s * 32 + lane;
    v[s] = e < E ? row[e] : 0.0f;
    if (e >= E) taken |= 1u << s;
  }
  id = 0;
  val = 0.0f;
  for (int r = 0; r < kd; ++r) {
    int have = 0;
    float bv = 0.0f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int s = 0; s < PER_LANE; ++s) {
      if (!((taken >> s) & 1u) && (!have || v[s] > bv)) {
        have = 1;
        bv = v[s];
        bi = s * 32 + lane;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      const int oh = __shfl_xor_sync(kFull, have, off);
      if (oh && (!have || ov > bv || (ov == bv && oi < bi))) {
        have = 1;
        bv = ov;
        bi = oi;
      }
    }
    if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
    if (lane == r) {
      id = bi;
      val = bv;
    }
  }
}

template <int PER_LANE>
__global__ void dispatch_candidates_kernel(const float* __restrict__ logits,
                                           int32_t* __restrict__ cand,
                                           float* __restrict__ vals, int T,
                                           int E, int kd) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= T) return;  // a whole warp: rows are warp-uniform
  int id;
  float val;
  select_top<PER_LANE>(logits + static_cast<size_t>(t) * E, E, kd, lane, id,
                       val);
  if (lane < kd) {
    cand[static_cast<size_t>(t) * kd + lane] = id;
    vals[static_cast<size_t>(t) * kd + lane] = val;
  }
}

template <int PER_LANE>
__global__ void dispatch_fused_kernel(
    const float* __restrict__ logits, const float* __restrict__ load,
    int32_t* __restrict__ experts, float* __restrict__ weights,
    uint8_t* __restrict__ steered, int T, int E, int k, int d, float dl,
    float slack) {
  extern __shared__ float s_load[];
  for (int i = threadIdx.x; i < E; i += blockDim.x) s_load[i] = load[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= T) return;
  int id;
  float val;
  select_top<PER_LANE>(logits + static_cast<size_t>(t) * E, E, k + d, lane,
                       id, val);

  // slot-sequential steering; lanes 0..k-1 hold the primaries, k..k+d-1
  // the alternates, and every lane computes every slot
  unsigned used = 0;
  int out_e = 0, out_s = 0;
  float out_v = 0.0f;
  for (int i = 0; i < k; ++i) {
    const int prim = __shfl_sync(kFull, id, i);
    const float pv = __shfl_sync(kFull, val, i);
    const float lp = s_load[prim];
    const float lim_l = lp - dl;
    const float lim_v = pv - slack;
    int best = 0;
    float best_l = 0.0f;
    bool has = false;
    for (int j = 0; j < d; ++j) {
      const int a = __shfl_sync(kFull, id, k + j);
      const float av = __shfl_sync(kFull, val, k + j);
      const float la = s_load[a];
      const bool ok = !((used >> j) & 1u) && la <= lim_l && av >= lim_v;
      const float masked = ok ? la : INFINITY;
      if (j == 0 || masked < best_l) {  // the first index on ties
        best = j;
        best_l = masked;
      }
      has = has || ok;
    }
    const float benefit = has ? lp - best_l : -INFINITY;
    const bool steer = has && benefit >= dl;
    const int sel_id = __shfl_sync(kFull, id, k + best);
    const float sel_v = __shfl_sync(kFull, val, k + best);
    if (steer) used |= 1u << best;
    if (lane == i) {
      out_e = steer ? sel_id : prim;
      out_v = steer ? sel_v : pv;
      out_s = steer ? 1 : 0;
    }
  }

  // softmax over the k chosen logits
  float mx = -INFINITY;
  for (int i = 0; i < k; ++i) mx = fmaxf(mx, __shfl_sync(kFull, out_v, i));
  const float ex = lane < k ? expf(out_v - mx) : 0.0f;
  float sum = 0.0f;
  for (int i = 0; i < k; ++i) sum += __shfl_sync(kFull, ex, i);
  if (lane < k) {
    const size_t o = static_cast<size_t>(t) * k + lane;
    experts[o] = out_e;
    weights[o] = ex / sum;
    steered[o] = static_cast<uint8_t>(out_s);
  }
}

template <int PER_LANE>
int launch_candidates(const void* logits, void* cand, void* vals, int T,
                      int E, int kd, cudaStream_t st) {
  const dim3 grid((T + kWarps - 1) / kWarps);
  dispatch_candidates_kernel<PER_LANE><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const float*>(logits), static_cast<int32_t*>(cand),
      static_cast<float*>(vals), T, E, kd);
  return static_cast<int>(cudaGetLastError());
}

template <int PER_LANE>
int launch_fused(const void* logits, const void* load, void* experts,
                 void* weights, void* steered, int T, int E, int k, int d,
                 float dl, float slack, cudaStream_t st) {
  const dim3 grid((T + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(E) * sizeof(float);
  dispatch_fused_kernel<PER_LANE><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const float*>(logits), static_cast<const float*>(load),
      static_cast<int32_t*>(experts), static_cast<float*>(weights),
      static_cast<uint8_t*>(steered), T, E, k, d, dl, slack);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers; stream is a
// cudaStream_t.  Each returns the cudaError_t of its launch (0 on
// success).  The wrapper checks 1 <= E <= 1024, 1 <= k, 1 <= d,
// k + d <= min(E, 16) and T >= 1.
extern "C" int dispatch_candidates_launch(const void* logits, void* cand,
                                          void* vals, int T, int E, int kd,
                                          void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_lane = (E + 31) / 32;
  if (per_lane <= 1) return launch_candidates<1>(logits, cand, vals, T, E, kd, st);
  if (per_lane <= 2) return launch_candidates<2>(logits, cand, vals, T, E, kd, st);
  if (per_lane <= 4) return launch_candidates<4>(logits, cand, vals, T, E, kd, st);
  if (per_lane <= 8) return launch_candidates<8>(logits, cand, vals, T, E, kd, st);
  if (per_lane <= 16) return launch_candidates<16>(logits, cand, vals, T, E, kd, st);
  if (per_lane <= 32) return launch_candidates<32>(logits, cand, vals, T, E, kd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dispatch_fused_launch(const void* logits, const void* load,
                                     void* experts, void* weights,
                                     void* steered, int T, int E, int k,
                                     int d, float delta_l, float gate_slack,
                                     void* stream) {
  if (T <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_lane = (E + 31) / 32;
#define FUSED(P)                                                         \
  return launch_fused<P>(logits, load, experts, weights, steered, T, E, k, \
                         d, delta_l, gate_slack, st)
  if (per_lane <= 1) FUSED(1);
  if (per_lane <= 2) FUSED(2);
  if (per_lane <= 4) FUSED(4);
  if (per_lane <= 8) FUSED(8);
  if (per_lane <= 16) FUSED(16);
  if (per_lane <= 32) FUSED(32);
#undef FUSED
  return static_cast<int>(cudaErrorInvalidValue);
}
