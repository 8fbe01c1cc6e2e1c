"""CUDA ``decode_attention`` for Hopper: build, bind and launch.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU
kernel ``repro/kernels/decode_attention/kernel.py:decode_attention``
(``_body``).  It is built with ``nvcc`` at first use
(``kernels/_build.py``) and called through ``ctypes`` on PyTorch's
current stream.  ``pos`` stays on the card: the kernel reads it, so a
decode step never waits on the host.  The wrapper checks device, dtype,
shape and contiguity, allocates the output, and adds one to
``decode_attention.launches`` for every launch; there is no fallback: a
tensor not on a CUDA device raises.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
FLAGS = ()  # held to a tolerance, so fused multiply-adds are allowed
MAX_D = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, FLAGS)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        # declared, or ctypes would pass each pointer as a 32-bit int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def build() -> Tuple[float, str]:
    """Build and load the kernel; returns (build seconds, nvcc log)."""
    _lib()
    return _build.build_info(SOURCE)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Launch the CUDA kernel; arguments and result as
    :func:`repro_torch.kernels.decode_attention.ref.decode_attention`,
    with ``pos`` an int32 tensor on the card.  The logits are scaled by
    multiplying with ``1/sqrt(D)``, as the Pallas kernel does."""
    if q.device.type != "cuda":
        raise ValueError(
            f"the CUDA decode_attention needs tensors on a CUDA device, "
            f"got {q.device}; use the plain version (impl='ref') on "
            f"the CPU"
        )
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, H, D) and the caches (B, S, KV, "
                         f"D), got {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)}")
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes "
                         f"{', '.join(map(str, DTYPES))}")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"head_dim must be in [1, {MAX_D}], got {D}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not split over {KV} KV heads")
    if S < 1:
        raise ValueError("the cache must hold at least one row")
    dev = q.device
    check_tensor("q", q, q.dtype, (B, H, D), dev)
    check_tensor("k_cache", k_cache, q.dtype, (B, S, KV, D), dev)
    check_tensor("v_cache", v_cache, q.dtype, (B, S, KV, D), dev)
    check_tensor("pos", pos, torch.int32, (B,), dev)
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, S, H, KV, D,
            DTYPES[q.dtype], 1.0 / math.sqrt(D), int(window),
            float(softcap), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"decode_attention launch failed: cudaError {err}"
        )
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
