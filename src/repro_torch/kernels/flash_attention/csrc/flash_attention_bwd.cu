// flash_attention_bwd: the gradient of causal / windowed / softcapped GQA
// attention over a whole sequence, for sm_90a, on the CUDA cores.
//
// The JAX package has no backward kernel: off the TPU it differentiates
// the plain src/repro/kernels/flash_attention/ref.py:mha, and this is the
// gradient of the function its Pallas kernel src/repro/kernels/
// flash_attention/kernel.py (_body, launched from flash_attention)
// computes.  For q (B, S, H, D), k, v (B, S, KV, D), the output o and its
// gradient dO (B, S, H, D), and the forward's row logsumexp in log2 units
// lse (B, H, S) float32 (csrc/flash_attention.cu writes it when asked):
//   s_ij  = (q_i . k_j) * scale; with a cap, t = tanh(s / cap), s = cap t
//   p_ij  = exp2(s_ij log2(e) - lse_i) where the masks keep (i, j), else 0
//   D_i   = dO_i . o_i                          (prologue, bwd_delta)
//   dV_j  = sum_i p_ij dO_i                     (bwd_dkdv)
//   ds_ij = p_ij (dO_i . v_j - D_i) (1 - t^2 with a cap) * scale
//   dK_j  = sum_i ds_ij q_i                     (bwd_dkdv)
//   dQ_i  = sum_j ds_ij k_j                     (bwd_dq)
// Query head h reads KV head h / G (G = H / KV), so dK and dV of a KV
// head sum over its G query heads.
//
// Bound: five products of D over the (query, key) pairs the masks keep,
// 10 D operations a pair and head, against q, k, v, o, dO, lse read once
// and dq, dk, dv written once.  At the training shapes that is bound by
// operations (tens of TFLOP of tensor-core rate); this first kernel runs
// on the CUDA cores in float32 and sits far above it.
//
// Design (simple and deterministic: no float atomics, every output element
// written once by one thread, every sum in a fixed order):
//  * bwd_delta: one warp a row, D_i = dO_i . o_i in float32.
//  * bwd_dkdv: a block per (32-key tile, batch row, KV head), heaviest key
//    tiles first (under the causal mask key tile 0 meets every query).
//    It stages its K and V tile once and walks the G query heads and, for
//    each, the 32-row query tiles its keys can meet, accumulating dK and
//    dV in registers (a thread owns one key and DP / 8 dims of each).
//  * bwd_dq: a block per (32-row query tile, batch row, query head),
//    heaviest first; it stages Q and dO once and walks the key tiles.
//  Both recompute s and dO . v of a 32 x 32 tile pair, a thread 2 x 2 of
//  them from 16-byte shared-memory loads (rows padded to DP + 4 floats),
//  and write p and ds to shared memory for the sums.  Inputs are staged
//  as float32 (bfloat16 widened); D is padded with zeros to DP = 64, 128
//  or 256.  A second launch computes dQ (in place of atomics into it), so
//  s and dO . v are computed twice: seven products where five would do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 32;     // query rows and keys of a tile
constexpr int kThreads = 256;  // a block
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// rows [row0, row0 + 32) of a (B, S, heads, D) tensor's (b, head) slice,
// as float32 into shared memory (DP + 4 floats a row); zero past S and D
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          size_t stride, int row0, int S,
                                          int D) {
  constexpr int LD = DP + 4;
  for (int e = threadIdx.x; e < kTile * DP; e += kThreads) {
    const int r = e / DP;
    const int d = e % DP;
    const int s = row0 + r;
    dst[r * LD + d] =
        s < S && d < D ? to_f(base[static_cast<size_t>(s) * stride + d])
                       : 0.0f;
  }
}

// one row's 32 float32 values of a (B, H, S) array into shared memory
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int row0, int S) {
  if (threadIdx.x < kTile) {
    const int s = row0 + threadIdx.x;
    dst[threadIdx.x] = s < S ? src[s] : 0.0f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// p and ds of the tile pair (query rows q0.., keys k0..) into sP, sS
// (32 x 33 floats, [row][key]); sQ, sO (dO), sK, sV staged, sL (lse) and
// sD (delta) of the rows.  Thread (ty, tx) takes rows ty, ty + 16 and
// keys tx, tx + 16.
template <int DP>
__device__ __forceinline__ void tile_p_ds(
    const float* sQ, const float* sO, const float* sK, const float* sV,
    const float* sL, const float* sD, float* sP, float* sS, int q0, int k0,
    int S, float scale, int causal, int window, float softcap) {
  constexpr int LD = DP + 4;
  constexpr int LP = kTile + 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  float dp[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 q[2], o[2], k[2], v[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      q[a] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * a) * LD + d);
      o[a] = *reinterpret_cast<const float4*>(sO + (ty + 16 * a) * LD + d);
      k[a] = *reinterpret_cast<const float4*>(sK + (tx + 16 * a) * LD + d);
      v[a] = *reinterpret_cast<const float4*>(sV + (tx + 16 * a) * LD + d);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[a][c] += dot4(q[a], k[c]);
        dp[a][c] += dot4(o[a], v[c]);
      }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = ty + 16 * a;
      const int j = tx + 16 * c;
      const int qi = q0 + i;
      const int kj = k0 + j;
      bool keep = qi < S && kj < S;
      if (causal) keep = keep && kj <= qi;
      if (window > 0) keep = keep && kj > qi - window;
      float x = s[a][c] * scale;
      float t = 0.0f;
      if (softcap > 0.0f) {
        t = tanhf(x / softcap);
        x = softcap * t;
      }
      const float p = keep ? exp2f(x * kLog2e - sL[i]) : 0.0f;
      float ds = p * (dp[a][c] - sD[i]);
      if (softcap > 0.0f) ds *= 1.0f - t * t;
      sP[i * LP + j] = p;
      sS[i * LP + j] = ds * scale;
    }
}

// D_i = dO_i . o_i, one warp a (b, s, h) row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ delta, int B, int S, int H, int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(B) * S * H) return;
  const T* orow = o + row * D;
  const T* grow = dout + row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc += to_f(orow[d]) * to_f(grow[d]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bs = row / H;  // b S + s
    const int s = static_cast<int>(bs % S);
    const int b = static_cast<int>(bs / S);
    delta[(static_cast<size_t>(b) * H + h) * S + s] = acc;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dk, T* __restrict__ dv, int B, int S, int H,
             int KV, int D, float scale, int causal, int window,
             float softcap) {
  constexpr int LD = DP + 4;
  constexpr int LP = kTile + 1;
  constexpr int NC = DP / 32;  // float4 chunks a thread owns, per row
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sO = sQ + kTile * LD;
  float* sP = sO + kTile * LD;
  float* sS = sP + kTile * LP;
  float* sL = sS + kTile * LP;
  float* sD = sL + kTile;

  const int G = H / KV;
  const int nt = (S + kTile - 1) / kTile;
  const int per = B * KV;
  // key tile 0 first: under the causal mask it meets every query tile
  const int kt = static_cast<int>(blockIdx.x) / per;
  const int rest = static_cast<int>(blockIdx.x) % per;
  const int b = rest / KV;
  const int kvh = rest % KV;
  const int k0 = kt * kTile;
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(kvh) * D;

  load_tile<T, DP>(sK, k + kv_off, kv_stride, k0, S, D);
  load_tile<T, DP>(sV, v + kv_off, kv_stride, k0, S, D);

  // query tiles that can meet a key of [k0, k0 + 32)
  const int k_last = min(k0 + kTile, S) - 1;
  const int qt_lo = causal ? k0 / kTile : 0;
  int qt_hi = nt - 1;
  if (window > 0) qt_hi = min(qt_hi, (k_last + window - 1) / kTile);

  // thread: key j, dims 4 c + 32 r (r < NC)
  const int j = threadIdx.x / 8;
  const int c4 = 4 * (threadIdx.x % 8);
  float4 adk[NC], adv[NC];
#pragma unroll
  for (int r = 0; r < NC; ++r) {
    adk[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    adv[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                         static_cast<size_t>(h) * D;
    const float* lrow = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* drow = delta + (static_cast<size_t>(b) * H + h) * S;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's sums are done
      load_tile<T, DP>(sQ, q + q_off, q_stride, q0, S, D);
      load_tile<T, DP>(sO, dout + q_off, q_stride, q0, S, D);
      load_row(sL, lrow, q0, S);
      load_row(sD, drow, q0, S);
      __syncthreads();
      tile_p_ds<DP>(sQ, sO, sK, sV, sL, sD, sP, sS, q0, k0, S, scale,
                    causal, window, softcap);
      __syncthreads();
      for (int i = 0; i < kTile; ++i) {
        const float p = sP[i * LP + j];
        const float ds = sS[i * LP + j];
#pragma unroll
        for (int r = 0; r < NC; ++r) {
          const float4 o =
              *reinterpret_cast<const float4*>(sO + i * LD + c4 + 32 * r);
          const float4 qq =
              *reinterpret_cast<const float4*>(sQ + i * LD + c4 + 32 * r);
          adv[r].x += p * o.x;
          adv[r].y += p * o.y;
          adv[r].z += p * o.z;
          adv[r].w += p * o.w;
          adk[r].x += ds * qq.x;
          adk[r].y += ds * qq.y;
          adk[r].z += ds * qq.z;
          adk[r].w += ds * qq.w;
        }
      }
    }
  }

  const int kj = k0 + j;
  if (kj >= S) return;
  T* dkrow = dk + kv_off + static_cast<size_t>(kj) * kv_stride;
  T* dvrow = dv + kv_off + static_cast<size_t>(kj) * kv_stride;
#pragma unroll
  for (int r = 0; r < NC; ++r) {
    const int d = c4 + 32 * r;
    const float ka[4] = {adk[r].x, adk[r].y, adk[r].z, adk[r].w};
    const float va[4] = {adv[r].x, adv[r].y, adv[r].z, adv[r].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < D) {
        store(dkrow + d + e, ka[e]);
        store(dvrow + d + e, va[e]);
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, int B, int S, int H, int KV, int D,
           float scale, int causal, int window, float softcap) {
  constexpr int LD = DP + 4;
  constexpr int LP = kTile + 1;
  constexpr int NC = DP / 32;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sO = sQ + kTile * LD;
  float* sP = sO + kTile * LD;
  float* sS = sP + kTile * LP;
  float* sL = sS + kTile * LP;
  float* sD = sL + kTile;

  const int G = H / KV;
  const int nt = (S + kTile - 1) / kTile;
  const int per = B * H;
  // heaviest first: under the causal mask the last query tile meets
  // every key tile
  const int u = static_cast<int>(blockIdx.x) / per;
  const int qt = causal ? nt - 1 - u : u;
  const int rest = static_cast<int>(blockIdx.x) % per;
  const int b = rest / H;
  const int h = rest % H;
  const int kvh = h / G;
  const int q0 = qt * kTile;
  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const size_t q_off = static_cast<size_t>(b) * S * q_stride +
                       static_cast<size_t>(h) * D;
  const size_t kv_off = static_cast<size_t>(b) * S * kv_stride +
                        static_cast<size_t>(kvh) * D;

  load_tile<T, DP>(sQ, q + q_off, q_stride, q0, S, D);
  load_tile<T, DP>(sO, dout + q_off, q_stride, q0, S, D);
  load_row(sL, lse + (static_cast<size_t>(b) * H + h) * S, q0, S);
  load_row(sD, delta + (static_cast<size_t>(b) * H + h) * S, q0, S);

  // key tiles that can meet a query of [q0, q0 + 32)
  const int q_last = min(q0 + kTile, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kTile : 0;
  const int kt_hi = causal ? q_last / kTile : nt - 1;

  // thread: query row i, dims 4 c + 32 r (r < NC)
  const int i = threadIdx.x / 8;
  const int c4 = 4 * (threadIdx.x % 8);
  float4 adq[NC];
#pragma unroll
  for (int r = 0; r < NC; ++r) adq[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, DP>(sK, k + kv_off, kv_stride, k0, S, D);
    load_tile<T, DP>(sV, v + kv_off, kv_stride, k0, S, D);
    __syncthreads();
    tile_p_ds<DP>(sQ, sO, sK, sV, sL, sD, sP, sS, q0, k0, S, scale, causal,
                  window, softcap);
    __syncthreads();
    for (int jj = 0; jj < kTile; ++jj) {
      const float ds = sS[i * LP + jj];
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        const float4 kk =
            *reinterpret_cast<const float4*>(sK + jj * LD + c4 + 32 * r);
        adq[r].x += ds * kk.x;
        adq[r].y += ds * kk.y;
        adq[r].z += ds * kk.z;
        adq[r].w += ds * kk.w;
      }
    }
  }

  const int qi = q0 + i;
  if (qi >= S) return;
  T* row = dq + q_off + static_cast<size_t>(qi) * q_stride;
#pragma unroll
  for (int r = 0; r < NC; ++r) {
    const int d = c4 + 32 * r;
    const float a[4] = {adq[r].x, adq[r].y, adq[r].z, adq[r].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < D) store(row + d + e, a[e]);
  }
}

template <int DP>
size_t smem_bytes() {
  return sizeof(float) *
         (4 * kTile * (DP + 4) + 2 * kTile * (kTile + 1) + 2 * kTile);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int S, int H, int KV, int D,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(bwd_dq<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int nt = (S + kTile - 1) / kTile;
  const long long rows = static_cast<long long>(B) * S * H;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const long long kv_blocks = static_cast<long long>(nt) * B * KV;
  const long long q_blocks = static_cast<long long>(nt) * B * H;
  if (delta_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  bwd_delta<T><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, B, S, H,
      D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv<T, DP><<<static_cast<unsigned>(kv_blocks), kThreads, smem,
                    stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), B, S, H, KV, D, scale,
      causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq<T, DP><<<static_cast<unsigned>(q_blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), B, S, H, KV, D, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dp(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int B, int S, int H, int KV, int D,
              float scale, int causal, int window, float softcap,
              cudaStream_t st) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                         KV, D, scale, causal, window, softcap, st);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                          KV, D, scale, causal, window, softcap, st);
  return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                        KV, D, scale, causal, window, softcap, st);
}

}  // namespace

// C interface for ctypes.  q, o, dout, dq are device pointers to
// contiguous (B, S, H, D) tensors, k, v, dk, dv to (B, S, KV, D) ones, all
// of one dtype (0: float32, 1: bfloat16); lse is the forward's (B, H, S)
// float32 row logsumexp in log2 units and delta a (B, H, S) float32
// workspace; 1 <= D <= 256 and H % KV == 0 (the wrapper checks).  Three
// kernels run in order on `stream` (a cudaStream_t): bwd_delta, bwd_dkdv,
// bwd_dq.  Returns the first cudaError_t of the launches (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, int KV, int D, int dtype, float scale,
    int causal, int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (D < 1 || D > 256 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dp<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                            H, KV, D, scale, causal, window, softcap, st);
  if (dtype == 1)
    return launch_dp<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk,
                                    dv, B, S, H, KV, D, scale, causal,
                                    window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
