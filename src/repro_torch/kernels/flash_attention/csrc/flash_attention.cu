// flash_attention: causal / windowed / softcapped GQA attention over a
// whole sequence (prefill), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py (_body, launched from flash_attention).  For q (B, S, H, D)
// and k, v (B, S, KV, D), query head h reads KV head h / (H / KV):
//   s = (q . k) * scale;  s = cap * tanh(s / cap) if cap > 0;
//   s = NEG_INF (-2**30) where the key is masked (causal: key > query;
//       window: key <= query - window);
//   out = softmax(s) v, by the online softmax: per query row a running
//   max m, sum l and float32 accumulator, rescaled by exp(m_old - m_new)
//   for every key tile, and out = acc / max(l, 1e-30) in q's dtype.
//
// Bound: causal attention does 4 * D operations per (query, key) pair
// that the masks keep (q.k and p.v), against (2 H + 2 KV) * S * D
// elements moved, so at the serving shape (S = 512, H = 15, KV = 5,
// D = 64) it is bound by operations: about 0.5 GFLOP per call on the
// float32 CUDA cores, which is what this kernel uses (no tensor cores).
//
// Design: one block of 256 threads per (q tile of 64 rows, head h,
// batch b).  The block keeps its Q tile in shared memory as float32 and
// streams 64-row K and V tiles of KV head h / G through shared memory.
// Thread (ty, tx) of the 16 x 16 grid owns query rows ty + 16 r (r < 4):
// their 4 x 4 logits at key columns tx + 16 c, their running max and
// sum (the 16 threads of a row reduce with warp shuffles), and the
// accumulator dims 64 c' + 4 tx + e (e < 4) of those rows.  Rows of
// shared memory are padded by 4 floats so float4 reads do not conflict.
// Key tiles wholly past the causal diagonal or wholly before the window
// are skipped: the reference's masked logits there add nothing once a
// row has seen a key it keeps, and every row keeps its own position.
// The head dimension D is padded with zeros to DP = 64, 128 or 256
// (D <= DP), which leaves the dot products unchanged.  The sequence
// needs no multiple of the tile: rows past S are zero and keys past S
// are dropped.  A tile at DP = 256 needs 212 KB of shared memory, so
// the launch raises the block's dynamic shared-memory limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as the reference
constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per tile
constexpr int kPad = 4;  // floats of padding per shared-memory row

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
  // Q and K tiles (padded rows), the V tile, the P tile (padded rows)
  return sizeof(float) * (static_cast<size_t>(kBQ) * (DP + kPad) +
                          static_cast<size_t>(kBK) * (DP + kPad) +
                          static_cast<size_t>(kBK) * DP +
                          static_cast<size_t>(kBQ) * (kBK + kPad));
}

// Copy rows [row0, row0 + rows) of one head (stride `stride` elements
// between positions) into a float tile with `ld` floats per row; rows
// past S and dims past D are zero.
template <typename T, int DP>
__device__ void load_tile(float* dst, int ld, const T* src, size_t stride,
                          int row0, int rows, int S, int D) {
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int r = i / DP;
    const int d = i - r * DP;
    const int s = row0 + r;
    float x = 0.0f;
    if (s < S && d < D) x = to_f32(src[static_cast<size_t>(s) * stride + d]);
    dst[r * ld + d] = x;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int S, int H,
              int KV, int D, float scale, int causal, int window,
              float softcap) {
  constexpr int LQ = DP + kPad;  // floats per Q / K row in shared memory
  constexpr int LP = kBK + kPad;
  constexpr int NC = DP / 64;  // float4 groups of dims per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * LQ;
  float* sV = sK + kBK * LQ;
  float* sP = sV + kBK * DP;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const T* qb = q + static_cast<size_t>(b) * S * q_stride +
                static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * S * kv_stride +
                static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * S * kv_stride +
                static_cast<size_t>(kvh) * D;
  T* ob = o + static_cast<size_t>(b) * S * q_stride +
          static_cast<size_t>(h) * D;

  load_tile<T, DP>(sQ, LQ, qb, q_stride, q0, kBQ, S, D);

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.0f;
  }

  // key tiles that hold a key some row of this tile keeps
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_stop = causal ? q_last + 1 : S;
  int k_first = 0;
  if (window > 0) k_first = max(0, q0 - window + 1);
  const int kt_first = (k_first / kBK) * kBK;

  for (int kt = kt_first; kt < k_stop; kt += kBK) {
    __syncthreads();  // the previous tile is consumed (and Q is loaded)
    load_tile<T, DP>(sK, LQ, kb, kv_stride, kt, kBK, S, D);
    load_tile<T, DP>(sV, DP, vb, kv_stride, kt, kBK, S, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * r) * LQ + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * c) * LQ + d]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[r][c] += qv[r].x * kv[c].x + qv[r].y * kv[c].y +
                     qv[r].z * kv[c].z + qv[r].w * kv[c].w;
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
      float p[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = kt + tx + 16 * c;
        float x = s[r][c] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool keep = true;
        if (causal) keep = keep && kj <= qi;
        if (window > 0) keep = keep && kj > qi - window;
        s[r][c] = keep ? x : kNegInf;
        if (kj < S) mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = kt + tx + 16 * c;
        p[c] = kj < S ? expf(s[r][c] - m_new) : 0.0f;  // no key past S
        sum += p[c];
        sP[(ty + 16 * r) * LP + tx + 16 * c] = p[c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][c][e] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(&sP[(ty + 16 * r) * LP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &sV[(j + jj) * DP + 64 * c + 4 * tx]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float pj = jj == 0   ? pv[r].x
                             : jj == 1 ? pv[r].y
                             : jj == 2 ? pv[r].z
                                       : pv[r].w;
            acc[r][c][0] += pj * vv.x;
            acc[r][c][1] += pj * vv.y;
            acc[r][c][2] += pj * vv.z;
            acc[r][c][3] += pj * vv.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= S) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    T* orow = ob + static_cast<size_t>(qi) * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * c + 4 * tx + e;
        if (d < D) store(&orow[d], acc[r][c][e] / lr);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int D, float scale, int causal, int window,
           float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, D, scale,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dp(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, int D, float scale, int causal,
              int window, float softcap, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                         softcap, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                          softcap, stream);
  return launch<T, 256>(q, k, v, o, B, S, H, KV, D, scale, causal, window,
                        softcap, stream);
}

}  // namespace

// C interface for ctypes.  q, k, v, o are device pointers to contiguous
// (B, S, H|KV, D) tensors of one dtype (0: float32, 1: bfloat16);
// 1 <= D <= 256 and H % KV == 0 (the wrapper checks).  stream is a
// cudaStream_t.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int D, int dtype,
                                      float scale, int causal, int window,
                                      float softcap, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dp<float>(q, k, v, o, B, S, H, KV, D, scale, causal,
                            window, softcap, st);
  if (dtype == 1)
    return launch_dp<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, scale,
                                    causal, window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
