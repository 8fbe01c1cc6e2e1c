// chunk_scan: one chunk of the Mamba-1 selective scan, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (chunk_scan, body _body).  For h0 (Bt, DI, ST), x and dt (Bt, Q, DI),
// A (DI, ST) and B, C (Bt, Q, ST), every channel d of every batch row
// walks the Q steps of the chunk:
//   h[s] <- exp(dt_t A[d, s]) h[s] + (dt_t B_t[s]) x_t     (s < ST)
//   y_t  =  sum_s h[s] C_t[s]                               (no D x skip)
// and the chunk returns y (Bt, Q, DI) and h_out (Bt, DI, ST), both
// float32.  Math is float32; x, dt, B and C may be float32 or bfloat16
// (one dtype for the four); h0 and A are float32.  Any Q, any DI (the
// ragged last block masks its channels) and ST <= 64.
//
// Bound: every input is read once and every output written once, so
// at the serving shape (Bt = 1, Q = 128, DI = 8192, ST = 16, float32)
// the kernel moves h0, A and h_out (3 x 0.52 MB), x, dt and y
// (3 x 4.19 MB) and B, C (16 KB): 14.2 MB, 4.2 us at 3.35 TB/s.  It
// also takes Q DI ST = 16.8 M exponentials on the special-function
// units (16 per SM per clock, about 4 us) and about 7 other float32
// operations per (step, channel, state).  So it is bound by bytes,
// with the exponentials close behind.
//
// Design: the TPU grid (Bt, DI / 512) would be 16 blocks at the serving
// shape, on 132 SMs.  Here a group of L lanes (L a power of two, 4 at
// ST = 16) owns one channel, each lane kNS = 4 of its states in
// registers, so the grid has DI L / 128 blocks of 128 threads per
// batch row (256 at the serving shape).  The recurrence carries
// nothing but h from step to step: one fused multiply-add per state.
// The block stages kTQ steps at a time in shared memory: x and dt of
// its TC = 128 / L channels (rows of neighbouring addresses) and B and
// C, which every channel reads, all loaded at once, so a pass waits on
// device memory once and not once per step.  y_t is the lanes' partial
// sums reduced by shuffles, stored by the group's first lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNS = 4;      // states per lane
constexpr int kMaxST = 64;  // at most 16 lanes per channel
constexpr int kTQ = 32;     // steps staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    chunk_scan_fwd(const float* __restrict__ h0, const T* __restrict__ x,
                   const T* __restrict__ dt, const float* __restrict__ A,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   float* __restrict__ y, float* __restrict__ hout, int Q,
                   int DI, int ST) {
  constexpr int TC = kThreads / L;  // channels per block
  constexpr int STP = L * kNS;      // states padded to the lanes' total
  extern __shared__ float smem[];
  float* sX = smem;             // [kTQ][TC]
  float* sD = sX + kTQ * TC;    // [kTQ][TC]
  float* sB = sD + kTQ * TC;    // [kTQ][STP]
  float* sC = sB + kTQ * STP;   // [kTQ][STP]

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * TC;
  const int cl = threadIdx.x / L;  // channel within the block
  const int j = threadIdx.x % L;   // lane within the channel's group
  const int d = c0 + cl;
  const bool live = d < DI;

  float a[kNS], h[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    const int s = j * kNS + i;
    const bool ok = live && s < ST;
    a[i] = ok ? A[static_cast<size_t>(d) * ST + s] : 0.0f;
    h[i] = ok ? h0[(static_cast<size_t>(b) * DI + d) * ST + s] : 0.0f;
  }

  for (int t0 = 0; t0 < Q; t0 += kTQ) {
    const int nq = min(kTQ, Q - t0);
    __syncthreads();  // the previous pass is done with shared memory
    // fixed trip counts, unrolled: every load of the pass is in flight
    // before the first store to shared memory waits on one
#pragma unroll
    for (int k = 0; k < kTQ * TC / kThreads; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int tt = e / TC, dd = c0 + e % TC;
      float xv = 0.0f, dv = 0.0f;
      if (tt < nq && dd < DI) {
        const size_t off = (static_cast<size_t>(b) * Q + t0 + tt) * DI + dd;
        xv = to_f32(x[off]);
        dv = to_f32(dt[off]);
      }
      sX[e] = xv;
      sD[e] = dv;
    }
#pragma unroll
    for (int k = 0; k < kTQ * STP / kThreads; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int tt = e / STP, s = e % STP;
      float bv = 0.0f, cv = 0.0f;
      if (tt < nq && s < ST) {
        const size_t off = (static_cast<size_t>(b) * Q + t0 + tt) * ST + s;
        bv = to_f32(Bm[off]);
        cv = to_f32(Cm[off]);
      }
      sB[tt * STP + s] = bv;
      sC[tt * STP + s] = cv;
    }
    __syncthreads();
    for (int tt = 0; tt < nq; ++tt) {
      const float xv = sX[tt * TC + cl];
      const float dv = sD[tt * TC + cl];
      const float* bt = sB + tt * STP + j * kNS;
      const float* ct = sC + tt * STP + j * kNS;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const float da = __expf(dv * a[i]);
        h[i] = da * h[i] + (dv * bt[i]) * xv;
        acc += h[i] * ct[i];
      }
      // every lane of the warp takes part: L divides 32
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (live && j == 0)
        y[(static_cast<size_t>(b) * Q + t0 + tt) * DI + d] = acc;
    }
  }

#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    const int s = j * kNS + i;
    if (live && s < ST)
      hout[(static_cast<size_t>(b) * DI + d) * ST + s] = h[i];
  }
}

template <typename T, int L>
int launch_l(const void* h0, const void* x, const void* dt, const void* A,
             const void* Bm, const void* Cm, void* y, void* hout, int Bt,
             int Q, int DI, int ST, cudaStream_t stream) {
  constexpr int TC = kThreads / L;
  // at most 33 KB (L = 1), under the 48 KB a block gets without opting in
  constexpr size_t smem = sizeof(float) * kTQ * (2 * TC + 2 * L * kNS);
  const dim3 grid((DI + TC - 1) / TC, Bt);
  chunk_scan_fwd<T, L><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(h0), static_cast<const T*>(x),
      static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<float*>(y), static_cast<float*>(hout), Q, DI, ST);
  return static_cast<int>(cudaGetLastError());
}

// L, the lanes per channel: the least power of two with L kNS >= ST
template <typename T>
int launch(const void* h0, const void* x, const void* dt, const void* A,
           const void* Bm, const void* Cm, void* y, void* hout, int Bt,
           int Q, int DI, int ST, cudaStream_t stream) {
  if (ST <= 1 * kNS)
    return launch_l<T, 1>(h0, x, dt, A, Bm, Cm, y, hout, Bt, Q, DI, ST,
                          stream);
  if (ST <= 2 * kNS)
    return launch_l<T, 2>(h0, x, dt, A, Bm, Cm, y, hout, Bt, Q, DI, ST,
                          stream);
  if (ST <= 4 * kNS)
    return launch_l<T, 4>(h0, x, dt, A, Bm, Cm, y, hout, Bt, Q, DI, ST,
                          stream);
  if (ST <= 8 * kNS)
    return launch_l<T, 8>(h0, x, dt, A, Bm, Cm, y, hout, Bt, Q, DI, ST,
                          stream);
  return launch_l<T, 16>(h0, x, dt, A, Bm, Cm, y, hout, Bt, Q, DI, ST,
                         stream);
}

}  // namespace

// C interface for ctypes.  h0 (Bt, DI, ST) and A (DI, ST) are float32;
// x, dt (Bt, Q, DI) and B, C (Bt, Q, ST) are one dtype (0: float32,
// 1: bfloat16); y (Bt, Q, DI) and hout (Bt, DI, ST) are float32; all
// are contiguous device tensors, Bt <= 65535 and 1 <= ST <= 64 (the
// wrapper checks).  stream is a cudaStream_t.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int chunk_scan_launch(const void* h0, const void* x,
                                 const void* dt, const void* A,
                                 const void* Bm, const void* Cm, void* y,
                                 void* hout, int Bt, int Q, int DI, int ST,
                                 int dtype, void* stream) {
  if (Bt <= 0 || Q <= 0 || DI <= 0) return 0;
  if (ST < 1 || ST > kMaxST || Bt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(h0, x, dt, A, Bm, Cm, y, hout, Bt, Q, DI, ST, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h0, x, dt, A, Bm, Cm, y, hout, Bt, Q, DI,
                                 ST, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
