"""CUDA ``flash_attention`` for Hopper and its gradient: build, bind and
launch.

The forward kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU
kernel ``repro/kernels/flash_attention/kernel.py:flash_attention``
(``_body``).  The backward (``csrc/flash_attention_bwd.cu``) replaces no
TPU kernel: the JAX package differentiates the plain ``ref.mha`` off
the TPU, and training on the card needs the gradient of the forward
kernel.  Both are built with ``nvcc`` at first use
(``kernels/_build.py``) and called through ``ctypes`` on PyTorch's
current stream.  The wrappers check device, dtype, shape and
contiguity, allocate the outputs, and add one to
``flash_attention.launches`` or ``flash_attention_backward.launches``
for every launch; there is no fallback: a tensor not on a CUDA device
raises.  Under autograd (gradients enabled and an input that requires
one) :func:`flash_attention` runs through :class:`FlashAttention`, whose
forward also writes the row logsumexp the backward reads.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
FLAGS = ()  # held to a tolerance, so fused multiply-adds are allowed
MAX_D = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SUBPARTS = 132 * 4  # an H100 SXM's SM sub-partitions, a tensor core each


def tile_plan(B: int, S: int, H: int, KV: int, D: int) -> Tuple[int, int,
                                                                int]:
    """(gh, nb, ks) of a block: gh query heads of one KV group and nb
    16-row query strips, each strip's keys split over ks warps; a warp
    per (head, strip, split), at most 8 (4 for D > 128).  Warps split
    each strip's keys until there are two warps for every tensor core
    (an mma.sync needs two warps of a sub-partition to reach its rate;
    a causal strip's chain of key tiles sets the time of a short grid);
    then the block takes the most heads of the group that fit, so that
    a K/V tile is staged once for them, and the rest of its warps take
    more strips."""
    G = H // KV
    max_warps = 4 if D > 128 else 8
    max_ks = 2 if D > 128 else 4  # the kernel's instances
    strips = B * H * -(-S // 16)
    ks = 1
    while ks < max_ks and strips * ks < 2 * SUBPARTS:
        ks *= 2
    gh = max(x for x in range(1, max_warps // ks + 1) if G % x == 0)
    nb = max(1, min(4, max_warps // (gh * ks)))
    return gh, nb, ks


@functools.lru_cache(maxsize=None)
def _plan(B: int, S: int, H: int, KV: int, D: int) -> Tuple[int, int, int]:
    return tile_plan(B, S, H, KV, D)


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, FLAGS)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        # declared, or ctypes would pass each pointer as a 32-bit int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load(BWD_SOURCE, FLAGS)
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def build() -> Tuple[float, str]:
    """Build and load the forward kernel; returns (build seconds, nvcc
    log)."""
    _lib()
    return _build.build_info(SOURCE)


def build_backward() -> Tuple[float, str]:
    """Build and load the backward kernels; returns (build seconds, nvcc
    log)."""
    _bwd_lib()
    return _build.build_info(BWD_SOURCE)


def _check(q, k, v) -> None:
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


def _forward(q, k, v, causal, window, softcap, with_lse: bool):
    """One launch of the forward kernel: (out, the row logsumexp in log2
    units (B, H, S) float32 or None)."""
    _check(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B * S == 0:
        return out, lse
    gh, nb, ks = _plan(B, S, H, KV, D)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            B, S, H, KV, D, DTYPES[q.dtype], 1.0 / math.sqrt(D),
            int(causal), int(window), float(softcap), gh, nb, ks, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: cudaError {err}"
        )
    flash_attention.launches += 1
    return out, lse


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v), given its
    output ``out``, the output's gradient ``dout`` (both (B, S, H, D) in
    q's dtype) and the forward's row logsumexp ``lse`` (B, H, S) float32
    in log2 units: one call of the backward kernels (``bwd_delta``, then
    ``bwd_main``, whose blocks take dK and dV or dQ; no atomics, so a
    repeated call is bitwise equal).  The gradients are in q's dtype, dk
    and dv summed over each KV head's query heads."""
    _check(q, k, v)
    B, S, H, D = q.shape
    KV = k.shape[2]
    check_tensor("out", out, q.dtype, (B, S, H, D), q.device)
    check_tensor("dout", dout, q.dtype, (B, S, H, D), q.device)
    check_tensor("lse", lse, torch.float32, (B, H, S), q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B * S == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, KV, D, DTYPES[q.dtype], 1.0 / math.sqrt(D),
            int(causal), int(window), float(softcap), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_backward launch failed: cudaError {err}"
        )
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """The forward kernel with its row logsumexp saved, and the backward
    kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _forward(q, k, v, causal, window, softcap, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.opts
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout.to(q.dtype).contiguous(), lse, causal=causal,
            window=window, softcap=softcap)
        return dq, dk, dv, None, None, None


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
    does.  Under autograd the result carries the backward kernels as its
    gradient (:class:`FlashAttention`)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap, False)[0]


flash_attention.launches = 0
