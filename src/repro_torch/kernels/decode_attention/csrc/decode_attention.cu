// decode_attention: one query token against a KV cache, bounded by a
// per-row position, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// kernel.py (_body, launched from decode_attention).  For q (B, H, D),
// caches (B, S, KV, D) and pos (B,), query head h of row b reads KV head
// h / G (G = H / KV) at cache rows j with
//   j <= pos[b]  and, with a window, j > pos[b] - window;
//   s = (q . k_j) * scale;  s = cap * tanh(s / cap) if cap > 0;
//   out = softmax(s) v by the online softmax in float32, and
//   out = acc / max(l, 1e-30) in q's dtype.
// pos is read from device memory, so a decode step never waits on the
// host.  Where no cache row is kept (pos < 0), every row is masked to
// -2**30 and the result is the plain mean of v, as in the reference.
//
// Bound: the op reads each kept cache row once (2 KV D elements per row
// and batch entry) and does 4 G D operations per row and head group, so
// it is bound by bytes: at the serving shape (544-row cache, KV = 5,
// D = 64, float32) about 1.4 MB when every row is kept.
//
// Design: one block of 16 warps per (batch row b, KV head, group of up
// to 4 of its G query heads), so a KV group of G <= 4 heads is one block
// and reads its cache rows once.  The kept rows [lo, hi] are split over
// the warps, each taking 4 consecutive rows at a time (2 at DP = 256)
// so that several loads are in flight.  The lanes of a warp split the
// head dimension (lane owns dims lane + 32 e), reduce q . k with
// shuffles, and keep a running (m, l, acc) per head.  The 16 partial states are combined in shared
// memory: M = max m_w, L = sum l_w exp(m_w - M), acc = sum acc_w
// exp(m_w - M).  D is padded with zeros to DP = 64, 128 or 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as the reference
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kGB = 4;  // query heads per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int DP>
constexpr size_t smem_bytes() {
  // per warp and head: m, l and the DP accumulator
  return sizeof(float) * kWarps * kGB * (DP + 2);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    decode_fwd(const T* __restrict__ q, const T* __restrict__ kc,
               const T* __restrict__ vc, const int32_t* __restrict__ pos,
               T* __restrict__ o, int S, int H, int KV, int D, float scale,
               int window, float softcap) {
  constexpr int NE = DP / 32;  // dims per lane
  constexpr int U = DP <= 128 ? 4 : 2;  // rows a warp loads at once
  extern __shared__ float smem[];
  float* s_m = smem;                       // [kWarps][kGB]
  float* s_l = s_m + kWarps * kGB;         // [kWarps][kGB]
  float* s_acc = s_l + kWarps * kGB;       // [kWarps][kGB][DP]

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int g0 = blockIdx.z * kGB;
  const int ng = min(kGB, G - g0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int p = pos[b];
  int hi = min(p, S - 1);
  int lo = window > 0 ? max(0, p - window + 1) : 0;
  if (lo > hi) {  // nothing kept: the reference averages every masked row
    lo = 0;
    hi = S - 1;
  }

  const T* qrow = q + (static_cast<size_t>(b) * H + kvh * G + g0) * D;
  float qv[kGB][NE];
#pragma unroll
  for (int g = 0; g < kGB; ++g)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      qv[g][e] = (g < ng && d < D)
                     ? to_f32(qrow[static_cast<size_t>(g) * D + d])
                     : 0.0f;
    }

  float m[kGB], l[kGB], acc[kGB][NE];
#pragma unroll
  for (int g = 0; g < kGB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[g][e] = 0.0f;
  }

  const size_t row_stride = static_cast<size_t>(KV) * D;
  const T* kb = kc + static_cast<size_t>(b) * S * row_stride +
                static_cast<size_t>(kvh) * D;
  const T* vb = vc + static_cast<size_t>(b) * S * row_stride +
                static_cast<size_t>(kvh) * D;

  for (int j0 = lo + warp * U; j0 <= hi; j0 += kWarps * U) {
    float kr[U][NE], vr[U][NE];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int j = j0 + u;
        const int d = lane + 32 * e;
        const bool in = j <= hi && d < D;
        const size_t off = static_cast<size_t>(j) * row_stride + d;
        kr[u][e] = in ? to_f32(kb[off]) : 0.0f;
        vr[u][e] = in ? to_f32(vb[off]) : 0.0f;
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      if (j > hi) break;  // uniform across the warp
      const bool keep = j <= p && (window <= 0 || j > p - window);
#pragma unroll
      for (int g = 0; g < kGB; ++g) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < NE; ++e) part += qv[g][e] * kr[u][e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        float s = part * scale;
        if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
        s = keep ? s : kNegInf;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float pj = expf(s - m_new);
        l[g] = l[g] * alpha + pj;
#pragma unroll
        for (int e = 0; e < NE; ++e)
          acc[g][e] = acc[g][e] * alpha + pj * vr[u][e];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kGB; ++g) {
    if (lane == 0) {
      s_m[warp * kGB + g] = m[g];
      s_l[warp * kGB + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < NE; ++e)
      s_acc[(warp * kGB + g) * DP + lane + 32 * e] = acc[g][e];
  }
  __syncthreads();

  // warp g combines head g0 + g across the warps' partial states
  if (warp < ng) {
    const int g = warp;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w * kGB + g]);
    float L = 0.0f;
    float out[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) out[e] = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_m[w * kGB + g] - M);
      L += s_l[w * kGB + g] * f;
#pragma unroll
      for (int e = 0; e < NE; ++e)
        out[e] += s_acc[(w * kGB + g) * DP + lane + 32 * e] * f;
    }
    L = fmaxf(L, 1e-30f);
    T* orow = o + (static_cast<size_t>(b) * H + kvh * G + g0 + g) * D;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = lane + 32 * e;
      if (d < D) store(&orow[d], out[e] / L);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* kc, const void* vc, const void* pos,
           void* o, int B, int S, int H, int KV, int D, float scale,
           int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_fwd<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int G = H / KV;
  const dim3 grid(B, KV, (G + kGB - 1) / kGB);
  decode_fwd<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int32_t*>(pos),
      static_cast<T*>(o), S, H, KV, D, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dp(const void* q, const void* kc, const void* vc,
              const void* pos, void* o, int B, int S, int H, int KV, int D,
              float scale, int window, float softcap, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, kc, vc, pos, o, B, S, H, KV, D, scale, window,
                         softcap, stream);
  if (D <= 128)
    return launch<T, 128>(q, kc, vc, pos, o, B, S, H, KV, D, scale, window,
                          softcap, stream);
  return launch<T, 256>(q, kc, vc, pos, o, B, S, H, KV, D, scale, window,
                        softcap, stream);
}

}  // namespace

// C interface for ctypes.  q (B, H, D), caches (B, S, KV, D) and o
// (B, H, D) are contiguous device tensors of one dtype (0: float32,
// 1: bfloat16); pos is a device int32 (B,); 1 <= D <= 256, S >= 1 and
// H % KV == 0 (the wrapper checks).  stream is a cudaStream_t.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* pos,
                                       void* o, int B, int S, int H, int KV,
                                       int D, int dtype, float scale,
                                       int window, float softcap,
                                       void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || D < 1 || D > 256 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dp<float>(q, kc, vc, pos, o, B, S, H, KV, D, scale,
                            window, softcap, st);
  if (dtype == 1)
    return launch_dp<__nv_bfloat16>(q, kc, vc, pos, o, B, S, H, KV, D,
                                    scale, window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
