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
// with the exponentials close behind: the design has to hide the loads
// behind the exponentials.
//
// Design: a group of L lanes (L a power of two, 8 at ST = 16) owns one
// channel, each lane kNS = 2 of its states in registers, so a block of
// 256 threads holds TC = 256 / L channels and the grid has DI / TC
// blocks per batch row (256 at the serving shape, 15.5 warps an SM).
//  - Passes of kTQ = 32 steps, staged in a ring of kStages = 3 buffers
//    in shared memory: x and dt of the block's channels (rows of
//    neighbouring addresses) and B and C, which every channel reads.
//    They are filled with 16-byte cp.async copies (commit and wait
//    groups), so passes n + 1 and n + 2 are in flight while pass n runs
//    its steps.  (Where a row is not a multiple of 16 bytes, float32
//    copies 4 bytes at a time and bfloat16 loads through registers.)
//  - The step loop has the compile-time length kTQ and is unrolled;
//    steps past Q are masked in a ragged last pass only (h unchanged,
//    y not written), so the exponentials and dt B x of consecutive
//    steps overlap and only the one-FMA h chain is serial.  B and C
//    rows padded past ST are zero in shared memory, so the step has no
//    per-state test.
//  - y_t is the L lanes' partial sums: every L steps the lanes reduce
//    and scatter them at once (L - 1 shuffles for L steps, not
//    log2 L a step), lane j keeping step j's sum.  A pass's y is staged
//    in shared memory and written as whole rows of the block's channels.
// The update per state is as before: h = exp(dt A) h + (dt B) x in
// float32, one rounding per FMA; only y's summation order changed.
// Registers and spills: the ptxas lines chip_smoke.py phase 1 prints.
// Shared memory: 3 x 32 x (2 TC + 2 L kNS) elements and 32 (TC + 32/L)
// floats of y, 40 KB at the serving shape (float32, L = 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNS = 2;      // states per lane
constexpr int kMaxST = 64;  // at most 32 lanes per channel
constexpr int kTQ = 32;     // steps of a pass
constexpr int kStages = 3;  // passes staged at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// exp(x) as __expf computes it, 2^(x log2 e) on the special-function
// unit, with subnormal results flushed to zero: the non-flushing form
// costs extra instructions a state and step, and a factor under 2^-126
// on h is below float32's resolution of any term it is added to
__device__ __forceinline__ float exp_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

// how a stage is filled
enum Fill { kVec16 = 0, kAsync4 = 1, kSync = 2 };

template <typename T, int L>
struct Lay {
  static constexpr int TC = kThreads / L;  // channels per block
  static constexpr int STP = L * kNS;      // states padded to the lanes'
  static constexpr int STAGE = kTQ * (2 * TC + 2 * STP);  // elements of T
  static constexpr int YS = TC + 32 / L;   // y row stride, conflict-free
  static constexpr size_t smem =
      kStages * STAGE * sizeof(T) + sizeof(float) * kTQ * YS;
};

// Fill stage buffer st with the nq steps from t0: x, dt rows of the
// block's channels [c0, c0 + TC) and B, C rows.  VX elements a copy.
template <typename T, int L, int VX>
__device__ __forceinline__ void fill(T* st, const T* x, const T* dt,
                                     const T* Bm, const T* Cm, size_t row0,
                                     int nq, int c0, int DI, int ST,
                                     Fill mode) {
  using Y = Lay<T, L>;
  T* sX = st;
  T* sD = sX + kTQ * Y::TC;
  T* sB = sD + kTQ * Y::TC;
  T* sC = sB + kTQ * Y::STP;
  const int cx = Y::TC / VX, cs = (ST + VX - 1) / VX;
  const int nx = nq * cx, nb = nq * cs;
  for (int i = threadIdx.x; i < 2 * nx + 2 * nb; i += kThreads) {
    T* dst;
    const T* src;
    if (i < 2 * nx) {
      const int ii = i < nx ? i : i - nx;
      const int tt = ii / cx, ch = c0 + (ii % cx) * VX;
      if (ch >= DI) continue;
      dst = (i < nx ? sX : sD) + tt * Y::TC + (ii % cx) * VX;
      src = (i < nx ? x : dt) + (row0 + tt) * DI + ch;
    } else {
      const int ii = i - 2 * nx < nb ? i - 2 * nx : i - 2 * nx - nb;
      const int tt = ii / cs, s = (ii % cs) * VX;
      dst = (i - 2 * nx < nb ? sB : sC) + tt * Y::STP + s;
      src = (i - 2 * nx < nb ? Bm : Cm) + (row0 + tt) * ST + s;
    }
    if (mode == kVec16) {
      cp_async16(dst, src);
    } else if (mode == kAsync4) {
      cp_async4(dst, src);
    } else {
      *dst = *src;
    }
  }
}

// L lanes hold v[0..L) each; afterwards lane j (j = lane % L) returns
// the sum over the L lanes of their v[j]: L - 1 shuffles in all.  Stage
// W halves the values a lane holds (a template, so that every index is
// known at compile time and v stays in registers).
template <int L, int W>
__device__ __forceinline__ void scatter_stage(float (&v)[L], int j) {
  if constexpr (W >= 1) {
    const bool upper = (j & W) != 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float send = upper ? v[k] : v[k + W];
      const float keep = upper ? v[k + W] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, W);
    }
    scatter_stage<L, W / 2>(v, j);
  }
}

template <int L>
__device__ __forceinline__ float reduce_scatter(float (&v)[L], int j) {
  scatter_stage<L, L / 2>(v, j);
  return v[0];
}

// The kTQ steps of one staged pass for one lane: its kNS states of
// channel cl; y of the pass into sY.  MASK: steps past nq leave h as it
// is (only a ragged last pass needs the test).
template <typename T, int L, bool MASK>
__device__ __forceinline__ void pass(const T* st, float* sY, float (&h)[kNS],
                                     const float (&a)[kNS], int cl, int j,
                                     int nq) {
  using Y = Lay<T, L>;
  constexpr int TC = Y::TC, STP = Y::STP, YS = Y::YS;
  const T* sX = st;
  const T* sD = sX + kTQ * TC;
  const T* sB = sD + kTQ * TC;
  const T* sC = sB + kTQ * STP;
#pragma unroll
  for (int g0 = 0; g0 < kTQ; g0 += L) {
    float v[L];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int tt = g0 + u;
      const float xv = to_f32(sX[tt * TC + cl]);
      const float dv = to_f32(sD[tt * TC + cl]);
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const int s = j * kNS + i;
        const float bt = to_f32(sB[tt * STP + s]);
        const float ct = to_f32(sC[tt * STP + s]);
        const float hn = exp_ftz(dv * a[i]) * h[i] + (dv * bt) * xv;
        if (!MASK || tt < nq) h[i] = hn;  // a step past Q leaves h as is
        acc += h[i] * ct;
      }
      v[u] = acc;
    }
    const float yv = reduce_scatter<L>(v, j);
    if (!MASK || g0 + j < nq) sY[(g0 + j) * YS + cl] = yv;
  }
}

// (kThreads, 1): ptxas otherwise holds the bfloat16 L = 32 instance to
// 64 registers and spills
template <typename T, int L>
__global__ void __launch_bounds__(kThreads, 1)
    chunk_scan_fwd(const float* __restrict__ h0, const T* __restrict__ x,
                   const T* __restrict__ dt, const float* __restrict__ A,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   float* __restrict__ y, float* __restrict__ hout, int Q,
                   int DI, int ST, Fill mode) {
  using Y = Lay<T, L>;
  constexpr int TC = Y::TC, STP = Y::STP, YS = Y::YS;
  constexpr int VX = 16 / sizeof(T);
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  float* sY = reinterpret_cast<float*>(ring + kStages * Y::STAGE);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * TC;
  const int cl = threadIdx.x / L;  // channel within the block
  const int j = threadIdx.x % L;   // lane within the channel's group
  const int d = c0 + cl;
  const bool live = d < DI;
  const size_t row0 = static_cast<size_t>(b) * Q;
  const int npass = (Q + kTQ - 1) / kTQ;

  // B and C rows are padded from ST to STP states; the padding is zero
  // in every stage, so a padded state reads b = c = 0 and stays 0
  if (STP > ST) {
    for (int e = threadIdx.x; e < kStages * kTQ * (STP - ST);
         e += kThreads) {
      const int w = STP - ST, r = e / w, s = ST + e % w;
      T* st = ring + (r / kTQ) * Y::STAGE + 2 * kTQ * TC;
      st[(r % kTQ) * STP + s] = T(0.0f);
      st[kTQ * STP + (r % kTQ) * STP + s] = T(0.0f);
    }
  }
  auto issue = [&](int p) {
    if (p < npass) {
      T* st = ring + (p % kStages) * Y::STAGE;
      const int t0 = p * kTQ, nq = min(kTQ, Q - t0);
      if (mode == kVec16)
        fill<T, L, VX>(st, x, dt, Bm, Cm, row0 + t0, nq, c0, DI, ST, mode);
      else
        fill<T, L, 1>(st, x, dt, Bm, Cm, row0 + t0, nq, c0, DI, ST, mode);
    }
    cp_commit();  // an empty group past the last pass keeps the count
  };
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) issue(p);

  float a[kNS], h[kNS];
#pragma unroll
  for (int i = 0; i < kNS; ++i) {
    const int s = j * kNS + i;
    const bool ok = live && s < ST;
    a[i] = ok ? A[static_cast<size_t>(d) * ST + s] : 0.0f;
    h[i] = ok ? h0[(static_cast<size_t>(b) * DI + d) * ST + s] : 0.0f;
  }

  for (int p = 0; p < npass; ++p) {
    issue(p + kStages - 1);
    cp_wait<kStages - 1>();  // this thread's copies of pass p landed
    __syncthreads();         // and every thread's (and the zero padding)
    const T* st = ring + (p % kStages) * Y::STAGE;
    const int t0 = p * kTQ, nq = min(kTQ, Q - t0);
    if (nq == kTQ)
      pass<T, L, false>(st, sY, h, a, cl, j, nq);
    else
      pass<T, L, true>(st, sY, h, a, cl, j, nq);
    __syncthreads();  // sY is whole; the stage may be refilled
    for (int e = threadIdx.x; e < nq * TC; e += kThreads) {
      const int tt = e / TC, ch = c0 + e % TC;
      if (ch < DI) y[(row0 + t0 + tt) * DI + ch] = sY[tt * YS + e % TC];
    }
  }
  cp_wait<0>();

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
  using Y = Lay<T, L>;
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_scan_fwd<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Y::smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt) |
      reinterpret_cast<uintptr_t>(Bm) | reinterpret_cast<uintptr_t>(Cm);
  const bool vec = (DI * sizeof(T)) % 16 == 0 && (ST * sizeof(T)) % 16 == 0
                   && addr % 16 == 0;
  const Fill mode = vec ? kVec16 : (sizeof(T) == 4 ? kAsync4 : kSync);
  const dim3 grid((DI + Y::TC - 1) / Y::TC, Bt);
  chunk_scan_fwd<T, L><<<grid, kThreads, Y::smem, stream>>>(
      static_cast<const float*>(h0), static_cast<const T*>(x),
      static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<float*>(y), static_cast<float*>(hout), Q, DI, ST, mode);
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
  if (ST <= 16 * kNS)
    return launch_l<T, 16>(h0, x, dt, A, Bm, Cm, y, hout, Bt, Q, DI, ST,
                           stream);
  return launch_l<T, 32>(h0, x, dt, A, Bm, Cm, y, hout, Bt, Q, DI, ST,
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
