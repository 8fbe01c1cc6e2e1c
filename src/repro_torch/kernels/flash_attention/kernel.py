"""CUDA ``flash_attention`` for Hopper: build, bind and launch.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention`` (``_body``).
It is built with ``nvcc`` at first use (``kernels/_build.py``) and
called through ``ctypes`` on PyTorch's current stream.  The wrapper
checks device, dtype, shape and contiguity, allocates the output, and
adds one to ``flash_attention.launches`` for every launch; there is no
fallback: a tensor not on a CUDA device raises.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
FLAGS = ()  # held to a tolerance, so fused multiply-adds are allowed
MAX_D = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, FLAGS)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        # declared, or ctypes would pass each pointer as a 32-bit int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def build() -> Tuple[float, str]:
    """Build and load the kernel; returns (build seconds, nvcc log)."""
    _lib()
    return _build.build_info(SOURCE)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Launch the CUDA kernel; arguments and result as
    :func:`repro_torch.kernels.flash_attention.ref.mha`.  The logits
    are scaled by multiplying with ``1/sqrt(D)``, as the Pallas kernel
    does."""
    if q.device.type != "cuda":
        raise ValueError(
            f"the CUDA flash_attention needs tensors on a CUDA device, got "
            f"{q.device}; use the plain version (impl='ref') on the "
            f"CPU"
        )
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B, S, H|KV, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes "
                         f"{', '.join(map(str, DTYPES))}")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"head_dim must be in [1, {MAX_D}], got {D}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not split over {KV} KV heads")
    check_tensor("q", q, q.dtype, (B, S, H, D), q.device)
    check_tensor("k", k, q.dtype, (B, S, KV, D), q.device)
    check_tensor("v", v, q.dtype, (B, S, KV, D), q.device)
    out = torch.empty_like(q)
    if B * S == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, KV, D, DTYPES[q.dtype], 1.0 / math.sqrt(D),
            int(causal), int(window), float(softcap), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: cudaError {err}"
        )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
