"""CUDA ``decode_attention`` for Hopper: build, bind and launch.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU
kernel ``repro/kernels/decode_attention/kernel.py:decode_attention``
(``_body``).  It is built with ``nvcc`` at first use
(``kernels/_build.py``) and called through ``ctypes`` on PyTorch's
current stream.  ``pos`` stays on the card: the kernel reads it, so a
decode step never waits on the host.  The cache rows are split over
blocks (:func:`split_plan`) and merged in the same launch.  The wrapper
checks device, dtype, shape and contiguity, allocates the output, keeps
the merge's buffers for each (device, stream): a zeroed int32 buffer of
counters, which every launch leaves at zero, and a float32 workspace of
partial states, both grown on demand (so launches in one stream never
share them with another stream's), and adds one to
``decode_attention.launches`` for every launch; there is no fallback: a
tensor not on a CUDA device raises.  A decode step is bound by the
host, so a shape's plan is computed once and the buffers are reused.
The buffers cannot be made while a CUDA graph captures the stream (the
zeroing would run only in the graph): the first call at a shape on a
stream comes before its capture, or the call raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensor, refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
FLAGS = ()  # held to a tolerance, so fused multiply-adds are allowed
MAX_D = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132  # streaming multiprocessors of an H100 SXM
TILE = 32  # cache rows a block stages at once (kTile in the source)
# spans merged by one block at most: more, shorter spans made the merge
# longer than they made the blocks shorter
# (benchmarks_torch/kernel_steps.py at both serving shapes)
MAX_SPLITS = 24
MAX_THREADS = 512  # threads of a block at most (kMaxThreads)
MAX_SMEM = 232448 - 1024  # dynamic shared memory a block opts into
# (device index, stream) -> its counter or workspace buffers, the
# newest last; a buffer that a larger one replaced is kept, so a CUDA
# graph captured with it stays valid
_COUNTERS: Dict[Tuple[int, int], List[torch.Tensor]] = {}
_WORKSPACES: Dict[Tuple[int, int], List[torch.Tensor]] = {}
# why decode_attention refuses autograd: it serves decoding only
BACKWARD_QUEUED = (
    "it serves decoding only (ROADMAP §2, backward kernels: training "
    "differentiates flash_attention, whose backward is a kernel)"
)


def record_floats(G: int, D: int) -> int:
    """Floats of one partial state: acc (G, D), m (G,) and l (G,),
    padded to a multiple of 4."""
    return -(-(G * D + 2 * G) // 4) * 4


def split_plan(B: int, S: int, KV: int) -> Tuple[int, int]:
    """(span, splits): the cache rows are cut into ``splits`` spans of
    ``span`` consecutive rows (the last one ragged), so that about one
    block of (row, KV head, span) runs on each of the 132 SMs, with at
    most MAX_SPLITS spans to merge; a block walks its span TILE rows at
    a time."""
    target = max(1, min(MAX_SPLITS, SMS // (B * KV)))
    span = -(-S // target)
    return span, -(-S // span)


def smem_bytes(D: int, G: int, span: int, splits: int) -> int:
    """Dynamic shared memory of a block (``smem_bytes`` in the
    source): the staged rows, the running acc of a span of more than
    one tile, the tile's weights and the merge's."""
    DP = 64 if D <= 64 else (128 if D <= 128 else 256)
    tile = min(span, TILE)
    acc_rows = G if span > tile else 0
    return 4 * ((2 * tile + G + acc_rows) * (DP + 4) + G * TILE
                + 2 * splits * G + 3 * G + 4 * MAX_THREADS)


@functools.lru_cache(maxsize=None)
def _plan(B: int, S: int, H: int, KV: int, D: int) -> Tuple[int, int]:
    """(span, workspace floats) of a call's shape; raises on what the
    kernel does not take."""
    span, splits = split_plan(max(B, 1), S, KV)
    G = H // KV
    if smem_bytes(D, G, span, splits) > MAX_SMEM:
        raise ValueError(f"{G} query heads per KV head at head_dim {D} "
                         f"need more shared memory than a block has")
    return span, B * KV * splits * record_floats(G, D)


def _buffer(table: Dict[Tuple[int, int], List[torch.Tensor]],
            key: Tuple[int, int], n: int, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """``table``'s newest buffer for ``key``, made zeroed (at least
    ``n``, and 1024) where it is missing or smaller.  Made while the
    current stream is captured, its zeroing would run only in the
    graph: that raises."""
    bufs = table.setdefault(key, [])
    if not bufs or bufs[-1].numel() < n:
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                "decode_attention: call it once at this shape on this "
                "stream before a CUDA graph captures the stream (its "
                "counters and workspace cannot be made in a capture)")
        bufs.append(torch.zeros(max(n, 1024), dtype=dtype, device=device))
    return bufs[-1]


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, FLAGS)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        # declared, or ctypes would pass each pointer as a 32-bit int
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
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
    multiplying with ``1/sqrt(D)``, as the Pallas kernel does.  It
    serves decoding only: under autograd it raises
    ``NotImplementedError``."""
    refuse_grad("decode_attention", BACKWARD_QUEUED, q, k_cache, v_cache)
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
    if B > 65535 or KV > 65535:
        raise ValueError(f"at most 65535 batch rows and KV heads, got "
                         f"{B} and {KV}")
    span, n_ws = _plan(B, S, H, KV, D)
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
        key = (dev.index, stream)
        ws = _buffer(_WORKSPACES, key, n_ws, torch.float32, dev)
        cnt = _buffer(_COUNTERS, key, B * KV, torch.int32, dev)
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(), ws.data_ptr(), cnt.data_ptr(),
            B, S, H, KV, D, DTYPES[q.dtype], 1.0 / math.sqrt(D),
            int(window), float(softcap), span, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"decode_attention launch failed: cudaError {err}"
        )
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
