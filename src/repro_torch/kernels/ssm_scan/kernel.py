"""CUDA ``chunk_scan`` for Hopper: build, bind and launch.

The kernel (``csrc/chunk_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssm_scan/kernel.py:chunk_scan`` (``_body``).  It is
built with ``nvcc`` at first use (``kernels/_build.py``) and called
through ``ctypes`` on PyTorch's current stream.  The wrapper checks
device, dtype, shape and contiguity, allocates the outputs, and adds
one to ``chunk_scan.launches`` for every launch; there is no fallback:
a tensor not on a CUDA device raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensor, refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "chunk_scan.cu"
FLAGS = ()  # held to a tolerance, so fused multiply-adds are allowed
MAX_ST = 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# why chunk_scan refuses autograd: its gradient is a kernel still to write
BACKWARD_QUEUED = (
    "its backward, a reverse-scan kernel, is queued (ROADMAP §2, backward "
    "kernels: the chunk_scan backward); to train a Mamba model on the card "
    "pass impl='ref'"
)


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, FLAGS)
    fn = lib.chunk_scan_launch
    if fn.argtypes is None:
        # declared, or ctypes would pass each pointer as a 32-bit int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def build() -> Tuple[float, str]:
    """Build and load the kernel; returns (build seconds, nvcc log)."""
    _lib()
    return _build.build_info(SOURCE)


def chunk_scan(
    h0: torch.Tensor,
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; arguments and result as
    :func:`repro_torch.kernels.ssm_scan.ref.chunk_scan`.  h0 and A are
    float32; x, dt, B and C are float32 or bfloat16, one dtype for the
    four; ST is at most 64.  Under autograd it raises
    ``NotImplementedError``: its backward (a reverse scan) is queued."""
    refuse_grad("chunk_scan", BACKWARD_QUEUED, h0, x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(
            f"the CUDA chunk_scan needs tensors on a CUDA device, got "
            f"{x.device}; use the plain version (impl='ref') on the CPU"
        )
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"x must be (Bt, Q, DI) and A (DI, ST), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    Bt, Q, DI = x.shape
    ST = A.shape[1]
    if x.dtype not in DTYPES:
        raise ValueError(f"x has dtype {x.dtype}; the kernel takes "
                         f"{', '.join(map(str, DTYPES))}")
    if not 1 <= ST <= MAX_ST:
        raise ValueError(f"d_state must be in [1, {MAX_ST}], got {ST}")
    if Bt > 65535:
        raise ValueError(f"at most 65535 batch rows, got {Bt}")
    dev = x.device
    check_tensor("h0", h0, torch.float32, (Bt, DI, ST), dev)
    check_tensor("x", x, x.dtype, (Bt, Q, DI), dev)
    check_tensor("dt", dt, x.dtype, (Bt, Q, DI), dev)
    check_tensor("A", A, torch.float32, (DI, ST), dev)
    check_tensor("B", B, x.dtype, (Bt, Q, ST), dev)
    check_tensor("C", C, x.dtype, (Bt, Q, ST), dev)
    y = torch.empty((Bt, Q, DI), dtype=torch.float32, device=dev)
    if Bt * Q * DI == 0:
        return y, h0.clone()
    hout = torch.empty_like(h0)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chunk_scan_launch(
            h0.data_ptr(), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), hout.data_ptr(),
            Bt, Q, DI, ST, DTYPES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"chunk_scan launch failed: cudaError {err}")
    chunk_scan.launches += 1
    return y, hout


chunk_scan.launches = 0
