#!/usr/bin/env python3
"""The rate and latency of warp-level ``mma.sync`` on the card.

    python3 benchmarks_torch/mma_rate.py

Each warp issues, over and over, 8 products into 8 independent
accumulators: TF32 m16n8k8 (what ``flash_attention`` runs for float32)
and bfloat16 m16n8k16, with 4, 8 and 16 warps on each of the 132 SMs (1,
2 and 4 a sub-partition).  It prints TFLOP/s and the clocks one product
takes a sub-partition at the card's maximum SM clock.  Where one warp a
sub-partition cannot keep its tensor core busy, the clocks an mma times
8 (the chain a warp cycles through) bound the latency of one product's
result from above.  The source is built into ``build/`` with nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int KIND>
__global__ void rate(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b[2] = {threadIdx.x * 3u, threadIdx.x * 5u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int kind, float* out, int blocks, int threads, int iters,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    rate<0><<<blocks, threads, 0, st>>>(out, iters);
  else
    rate<1><<<blocks, threads, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
SMS, ITERS = 132, 4000
KINDS = {"tf32 m16n8k8": (0, 16 * 8 * 8), "bf16 m16n8k16": (1, 16 * 8 * 16)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    src = ROOT / "build" / "mma_rate.cu"
    src.parent.mkdir(exist_ok=True)
    src.write_text(SOURCE)
    lib_path = src.with_suffix(".so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    print(cs.card_line(), f"{mhz:.0f} MHz maximum SM clock", flush=True)
    out = torch.empty(SMS * 16 * 32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, (kind, macs) in KINDS.items():
        for warps in (4, 8, 16):
            lib.run(kind, out.data_ptr(), SMS, 32 * warps, 10, stream)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            err = lib.run(kind, out.data_ptr(), SMS, 32 * warps, ITERS,
                          stream)
            end.record()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            ms = start.elapsed_time(end)
            n = SMS * warps * ITERS * 8  # products
            clocks = ms * 1e-3 * mhz * 1e6 * 4 / (n / SMS)
            print(f"{name}, {warps // 4} warp(s) a sub-partition: "
                  f"{2 * n * macs / ms / 1e9:.1f} TFLOP/s, {clocks:.2f} "
                  f"clocks a product a sub-partition", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
