"""CUDA ``route_select`` for Hopper: build, bind and launch.

The kernel (``csrc/route_select.cu``) replaces the Pallas TPU kernel
``repro/kernels/midas_route/kernel.py:route_select`` (``_route_body``).
It is built with ``nvcc`` at first use (``kernels/_build.py``) and
called through ``ctypes`` on PyTorch's current stream.  The wrapper
checks device, dtype, shape and contiguity, allocates the outputs, and
adds one to ``route_select.launches`` for every launch; there is no
fallback: a tensor not on a CUDA device raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensor as _check
from repro_torch.kernels.midas_route.ref import ROUTE_MODES, check_mode

SOURCE = Path(__file__).resolve().parent / "csrc" / "route_select.cu"
MAX_D = 16
MAX_M = 6144  # 2·m float32 staged in 48 KB of shared memory
FLAGS = _build.EXACT_FLAGS  # bit-equal to the plain version


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, FLAGS)
    fn = lib.route_select_launch
    if fn.argtypes is None:
        # declared, or ctypes would pass each pointer as a 32-bit int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def build() -> Tuple[float, str]:
    """Build and load the kernel; returns (build seconds, nvcc log)."""
    _lib()
    return _build.build_info(SOURCE)


def route_select(
    feas: torch.Tensor,
    load: torch.Tensor,
    p50: torch.Tensor,
    sampled: torch.Tensor,
    tie: torch.Tensor,
    scalars: torch.Tensor,
    *,
    mode: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; arguments and results as
    :func:`repro_torch.kernels.midas_route.ref.route_select`."""
    check_mode(mode)
    if feas.device.type != "cuda":
        raise ValueError(
            f"the CUDA route_select needs tensors on a CUDA device, got "
            f"{feas.device}; use the plain version (route_impl='ref') "
            f"on the CPU"
        )
    dev = feas.device
    if feas.dim() != 2:
        raise ValueError(f"feas must be (R, d_max), got {feas.shape}")
    R, d_max = feas.shape
    m = load.shape[0]
    if not 1 <= d_max <= MAX_D:
        raise ValueError(f"d_max must be in [1, {MAX_D}], got {d_max}")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"m must be in [1, {MAX_M}], got {m}")
    _check("feas", feas, torch.int32, (R, d_max), dev)
    _check("sampled", sampled, torch.bool, (R, d_max), dev)
    _check("tie", tie, torch.float32, (R, d_max), dev)
    _check("load", load, torch.float32, (m,), dev)
    _check("p50", p50, torch.float32, (m,), dev)
    _check("scalars", scalars, torch.float32, (4,), dev)
    assign = torch.empty((R,), dtype=torch.int32, device=dev)
    ok_any = torch.empty((R,), dtype=torch.bool, device=dev)
    if R == 0:
        return assign, ok_any
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.route_select_launch(
            feas.data_ptr(), sampled.data_ptr(), tie.data_ptr(),
            load.data_ptr(), p50.data_ptr(), scalars.data_ptr(),
            assign.data_ptr(), ok_any.data_ptr(),
            R, d_max, m, ROUTE_MODES.index(mode), stream,
        )
    if err != 0:
        raise RuntimeError(f"route_select launch failed: cudaError {err}")
    route_select.launches += 1
    return assign, ok_any


route_select.launches = 0
