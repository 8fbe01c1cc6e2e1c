"""CUDA kernels of MIDAS routing for Hopper: build, bind and launch.

``route_select`` (``csrc/route_select.cu``) replaces the Pallas TPU
kernel ``repro/kernels/midas_route/kernel.py:route_select``
(``_route_body``).  ``route_tick`` (the same source) routes a whole tick
of one of its policies in one launch: route_select's test for each of
the tick's G waves (midas, power_of_d, or chbl with its cap from the
wave's view), for midas with the pins, the leaky bucket and the history
ring of ``repro/core/policies/midas.py:route_midas`` between them, and
the tick's steering dV summed in the plain version's order, bit for
bit the waves one at a time, and under fleet routing each wave on its
own proxy's view.  ``dispatch_fused`` and ``dispatch_candidates``
(both in ``csrc/midas_dispatch.cu``) replace the two passes of its
``midas_dispatch``: ``_body`` (``f_max >= 1``) and ``_cand_body``
(pass 1 of ``f_max < 1``); ``dispatch_steer`` (the same source) is
pass 2 of ``f_max < 1``, the f_max quantile and the steering that the
TPU code runs in XLA between them.  Each source is built with ``nvcc``
at first use (``kernels/_build.py``) and called through ``ctypes`` on
PyTorch's current stream.  A wrapper checks device, dtype, shape and
contiguity, allocates the outputs, and adds one to its own ``launches``
for every launch; there is no fallback: a tensor not on a CUDA device
raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_tensor as _check
from repro_torch.kernels.common import refuse_grad
from repro_torch.kernels.midas_route.ref import (
    C_LOAD,
    ROUTE_MODES,
    check_mode,
    quantile_plan,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "route_select.cu"
MAX_D = 16
MAX_M = 6144  # 2·m float32 staged in 48 KB of shared memory
# route_tick stages 2·m float32 and 4 bytes a row of one wave in shared
# memory, midas 3·m float32 and 17 bytes a row: at MAX_M and MAX_RG that
# is 80 KB and 208 KB of the block's 227 KB
MAX_RG = 8192
FLAGS = _build.EXACT_FLAGS  # bit-equal to the plain version
DISPATCH_SOURCE = Path(__file__).resolve().parent / "csrc" / \
    "midas_dispatch.cu"
MAX_E = 1024
MAX_KD = 16  # k + d: the reference's limit, and 4 bits of a best alternate
# dispatch_steer keeps a token in a thread's registers up to
# STEER_REG_T tokens (csrc kRegT); beyond, 8 bytes a token in shared
# memory up to STEER_SMEM_T tokens, beyond that in a scratch buffer
# (kSteerSmemT)
STEER_REG_T = 512
STEER_SMEM_T = 4096
# the register kernel's quantile counts ranks up to this many tokens and
# runs the radix select above (kernel_steps.py times both)
STEER_COUNT_MAX = 320


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE, FLAGS)
    if lib.route_select_launch.argtypes is None:
        # declared, or ctypes would pass each pointer as a 32-bit int
        lib.route_select_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.route_select_launch.restype = ctypes.c_int
        lib.route_tick_launch.argtypes = (
            [ctypes.c_void_p] * 25 + [ctypes.c_int] * 9
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.route_tick_launch.restype = ctypes.c_int
    return lib


def _dispatch_lib() -> ctypes.CDLL:
    lib = _build.load(DISPATCH_SOURCE, FLAGS)
    if lib.dispatch_fused_launch.argtypes is None:
        lib.dispatch_candidates_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.dispatch_candidates_launch.restype = ctypes.c_int
        lib.dispatch_fused_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_float] * 2 + [ctypes.c_int] + [ctypes.c_void_p])
        lib.dispatch_fused_launch.restype = ctypes.c_int
        lib.dispatch_steer_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
            + [ctypes.c_float] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.dispatch_steer_launch.restype = ctypes.c_int
    return lib


def build() -> Tuple[float, str]:
    """Build and load ``route_select`` and ``route_tick``; returns (build
    seconds, nvcc log)."""
    _lib()
    return _build.build_info(SOURCE)


def build_dispatch() -> Tuple[float, str]:
    """Build and load the three dispatch kernels; returns (build
    seconds, nvcc log)."""
    _dispatch_lib()
    return _build.build_info(DISPATCH_SOURCE)


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


def route_tick(
    keys: torch.Tensor,
    mask: torch.Tensor,
    feas: torch.Tensor,
    rank: Optional[torch.Tensor],
    tie: Optional[torch.Tensor],
    L_hat: torch.Tensor,
    p50: Optional[torch.Tensor] = None,
    pin_server: Optional[torch.Tensor] = None,
    pin_expiry: Optional[torch.Tensor] = None,
    steer_hist: Optional[torch.Tensor] = None,
    elig_hist: Optional[torch.Tensor] = None,
    hist_idx: Optional[torch.Tensor] = None,
    *,
    d: Optional[torch.Tensor] = None,
    delta_l: Optional[torch.Tensor] = None,
    delta_t: Optional[torch.Tensor] = None,
    f_max: Optional[torch.Tensor] = None,
    pin_ms: Optional[torch.Tensor] = None,
    now_ms: Optional[torch.Tensor] = None,
    mode: str = "midas",
) -> Tuple[Optional[torch.Tensor], ...]:
    """Route one tick's G waves of a ``route_select`` policy in one launch.

    mask (G, Rg) bool and feas (G, Rg, d_max) int32 are the waves; L_hat
    the stale queue view: (m,) float32, one view that wave g routes on
    plus the sends of waves 0..g-1, or (G, m), fleet routing's per-wave
    views, wave g routing on row g alone (the kernel's base views: no
    sends of earlier waves added).  What else a mode reads:
    ``"power_of_d"`` rank (G, Rg, d_max) int8 and tie (G, Rg, d_max)
    float32 (the wave draws) and d () int32 (``cfg.fixed_d``);
    ``"chbl"`` nothing more (the cap ``C_LOAD * (mean + 1)`` comes from
    each wave's view, rounded as ``core.policies.bounded_load.load_cap``
    rounds it); ``"midas"`` also keys (G, Rg) int64 in [0, N), p50 (m,)
    float32, the policy state pin_server (N,) int32, pin_expiry (N,)
    float32, steer_hist and elig_hist (W,) float32 and hist_idx () int32,
    and the knobs and the tick clock as 0-d tensors (d int32, the rest
    float32).  Arguments a mode does not read are ignored.

    Returns (assign (G, Rg) int32, views (G, m) float32: the view each
    wave was routed on, arrivals (m,) float32, steered () float32,
    eligible () float32, dv () float32: the waves' steering dV, each
    wave summed in ``xla.loop_sum``'s order and the sums added to +0.0
    in wave order, and the new hist_idx () int32, None outside midas).
    midas's pin tables and histories are updated in place.  Equal bit
    for bit to the waves one at a time through the mode's policy
    (``core/sim.py:_route_waves`` with the plain impl).
    """
    check_mode(mode)
    if feas.dim() != 3:
        raise ValueError(f"feas must be (G, Rg, d_max), got {feas.shape}")
    G, Rg, d_max = feas.shape
    m = L_hat.shape[-1]
    if not 1 <= d_max <= MAX_D:
        raise ValueError(f"d_max must be in [1, {MAX_D}], got {d_max}")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"m must be in [1, {MAX_M}], got {m}")
    if Rg > MAX_RG:
        raise ValueError(f"a wave's rows Rg must be <= {MAX_RG}, got {Rg}")
    midas = mode == "midas"
    N = 0 if pin_server is None else pin_server.numel()
    W = 0 if steer_hist is None else steer_hist.numel()
    if midas and pin_server is not None and not 1 <= N < 2**31:
        raise ValueError(f"N must be in [1, 2**31), got {N}")
    if midas and steer_hist is not None and W < 1:
        raise ValueError(f"the history window must hold >= 1 wave, got {W}")
    dev = feas.device
    reads = [
        ("mask", mask, torch.bool, (G, Rg)),
        ("feas", feas, torch.int32, (G, Rg, d_max)),
        ("L_hat", L_hat, torch.float32,
         (G, m) if L_hat.dim() == 2 else (m,)),
    ]
    if mode != "chbl":
        reads += [
            ("rank", rank, torch.int8, (G, Rg, d_max)),
            ("tie", tie, torch.float32, (G, Rg, d_max)),
            ("d", d, torch.int32, ()),
        ]
    if midas:
        reads += [
            ("keys", keys, torch.int64, (G, Rg)),
            ("p50", p50, torch.float32, (m,)),
            ("pin_server", pin_server, torch.int32, (N,)),
            ("pin_expiry", pin_expiry, torch.float32, (N,)),
            ("steer_hist", steer_hist, torch.float32, (W,)),
            ("elig_hist", elig_hist, torch.float32, (W,)),
            ("hist_idx", hist_idx, torch.int32, ()),
            ("delta_l", delta_l, torch.float32, ()),
            ("delta_t", delta_t, torch.float32, ()),
            ("f_max", f_max, torch.float32, ()),
            ("pin_ms", pin_ms, torch.float32, ()),
            ("now_ms", now_ms, torch.float32, ()),
        ]
    for name, t, dtype, shape in reads:
        if t is None:
            raise ValueError(f"route_tick in mode {mode!r} needs {name}")
        _check(name, t, dtype, shape, dev)
    # the base view's stride (0: one view for every wave) and whether
    # the earlier waves' sends are added to it
    base_stride, accumulate = (m, 0) if L_hat.dim() == 2 else (0, 1)
    if dev.type != "cuda":
        raise ValueError(
            f"the CUDA route_tick needs tensors on a CUDA device, got "
            f"{dev}; on the CPU the engine routes the waves one at a time"
        )
    read = {name: t for name, t, _, _ in reads}
    f32 = dict(dtype=torch.float32, device=dev)
    assign = torch.empty((G, Rg), dtype=torch.int32, device=dev)
    views = torch.empty((G, m), **f32)
    arrivals = torch.empty((m,), **f32)
    steered = torch.empty((), **f32)
    eligible = torch.empty((), **f32)
    dv = torch.empty((), **f32)
    new_idx = (torch.empty((), dtype=torch.int32, device=dev) if midas
               else None)
    ptrs = [None if t is None else t.data_ptr() for t in (
        *(read.get(name) for name in (
            "keys", "mask", "feas", "rank", "tie", "L_hat", "p50", "d",
            "delta_l", "delta_t", "f_max", "pin_ms", "now_ms",
            "pin_server", "pin_expiry", "steer_hist", "elig_hist",
            "hist_idx")),
        assign, views, arrivals, steered, eligible, dv, new_idx,
    )]
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.route_tick_launch(
            *ptrs, G, Rg, d_max, m, N, W, base_stride, accumulate,
            ROUTE_MODES.index(mode), float(np.float32(1.0 / m)),
            float(np.float32(C_LOAD)), _stream(dev))
    if err != 0:
        raise RuntimeError(f"route_tick launch failed: cudaError {err}")
    route_tick.launches += 1
    return assign, views, arrivals, steered, eligible, dv, new_idx


route_tick.launches = 0


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------


# the dispatch kernels differentiate only through ops.midas_dispatch
DISPATCH_GRAD = ("call ops.midas_dispatch, whose autograd function scatters "
                 "the weights' gradient into the gate logits")


def _check_logits(gate_logits: torch.Tensor, kd: int) -> Tuple[int, int]:
    refuse_grad("the dispatch kernels", DISPATCH_GRAD, gate_logits)
    if gate_logits.device.type != "cuda":
        raise ValueError(
            f"the CUDA dispatch kernels need tensors on a CUDA device, got "
            f"{gate_logits.device}; use the plain version (impl='ref') on "
            f"the CPU"
        )
    if gate_logits.dim() != 2:
        raise ValueError(f"gate_logits must be (T, E), got "
                         f"{tuple(gate_logits.shape)}")
    T, E = gate_logits.shape
    if not 1 <= E <= MAX_E:
        raise ValueError(f"E must be in [1, {MAX_E}], got {E}")
    if not 1 <= kd <= min(E, MAX_KD):
        raise ValueError(f"k + d must be in [1, min(E, {MAX_KD})], got {kd}")
    _check("gate_logits", gate_logits, torch.float32, (T, E),
           gate_logits.device)
    return T, E


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def select_plan(T: int, E: int) -> int:
    """Rows a block of the rank-counting selection.  A row takes one
    thread an element (E rounded up to 32, at most 256; past 256 a
    thread takes several), and rows fill blocks of 256 threads: a
    decode token's row of E = 128 over 128 threads, a prompt's two rows
    a block (kernel_steps.py times other plans)."""
    return max(1, min(T, 256 // min(-(-E // 32) * 32, 256)))


@functools.lru_cache(maxsize=None)
def _plan(T: int, E: int) -> int:
    return select_plan(T, E)


def dispatch_candidates(
    gate_logits: torch.Tensor, kd: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the f_max-capped dispatch on the card: the ``kd``
    largest logits of each row, as
    :func:`repro_torch.kernels.midas_route.ref.top_candidates` (ids
    (T, kd) int32, values (T, kd) float32, lowest id first on ties)."""
    T, E = _check_logits(gate_logits, kd)
    dev = gate_logits.device
    cand = torch.empty((T, kd), dtype=torch.int32, device=dev)
    vals = torch.empty((T, kd), dtype=torch.float32, device=dev)
    if T == 0:
        return cand, vals
    lib = _dispatch_lib()
    with torch.cuda.device(dev):
        err = lib.dispatch_candidates_launch(
            gate_logits.data_ptr(), cand.data_ptr(), vals.data_ptr(),
            T, E, kd, _plan(T, E), _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"dispatch_candidates launch failed: cudaError {err}")
    dispatch_candidates.launches += 1
    return cand, vals


dispatch_candidates.launches = 0


def dispatch_fused(
    gate_logits: torch.Tensor,
    load: torch.Tensor,
    k: int,
    d: int,
    *,
    delta_l: float = 2.0,
    gate_slack: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The margin-governed dispatch (``f_max >= 1``) in one launch:
    :func:`repro_torch.kernels.midas_route.ref.midas_dispatch` with
    ``f_max=1.0`` and ``1 <= d <= E - k``.  Returns (experts (T, k)
    int32, weights (T, k) float32, steered (T, k) bool)."""
    if k < 1 or d < 1:
        raise ValueError(f"k and d must be >= 1, got k={k}, d={d}")
    T, E = _check_logits(gate_logits, k + d)
    dev = gate_logits.device
    _check("load", load, torch.float32, (E,), dev)
    experts = torch.empty((T, k), dtype=torch.int32, device=dev)
    weights = torch.empty((T, k), dtype=torch.float32, device=dev)
    steered = torch.empty((T, k), dtype=torch.bool, device=dev)
    if T == 0:
        return experts, weights, steered
    lib = _dispatch_lib()
    with torch.cuda.device(dev):
        err = lib.dispatch_fused_launch(
            gate_logits.data_ptr(), load.data_ptr(), experts.data_ptr(),
            weights.data_ptr(), steered.data_ptr(), T, E, k, d,
            float(delta_l), float(gate_slack), _plan(T, E), _stream(dev))
    if err != 0:
        raise RuntimeError(f"dispatch_fused launch failed: cudaError {err}")
    dispatch_fused.launches += 1
    return experts, weights, steered


dispatch_fused.launches = 0


@functools.lru_cache(maxsize=1024)
def _steer_scalars(T: int, f_max: float, delta_l: float):
    """(mode, low, high, w_high, w_low, floor) of ``dispatch_steer``:
    mode 0 steers nothing (f_max <= 0), 1 by the f_max quantile, 2 by
    the margin alone (f_max >= 1), as ``ref.steer_from_candidates``."""
    floor = float(np.float32(delta_l - 1e-9))
    if f_max >= 1.0:
        return 2, 0, 0, 0.0, 0.0, floor
    if f_max <= 0.0:
        return 0, 0, 0, 0.0, 0.0, floor
    return (1, *quantile_plan(T, 1.0 - f_max), floor)


def steer_plan(T: int) -> Tuple[bool, int]:
    """(warp, count_max) of ``dispatch_steer``'s register kernel at T
    tokens: the quantile by shuffles within one warp at T <= 32, by
    counting ranks up to ``count_max`` tokens, by the radix select
    above; kernel_steps.py times other plans."""
    return True, STEER_COUNT_MAX


def steer_path(T: int) -> str:
    """Which of ``dispatch_steer``'s kernels takes T tokens: "registers"
    (a thread a token) or "shared memory"."""
    return "registers" if T <= STEER_REG_T else "shared memory"


def dispatch_steer(
    cand: torch.Tensor,
    vals: torch.Tensor,
    load: torch.Tensor,
    k: int,
    *,
    delta_l: float = 2.0,
    gate_slack: float = 1.0,
    f_max: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 2 of the f_max-capped dispatch on the card, in one launch:
    :func:`repro_torch.kernels.midas_route.ref.steer_from_candidates`
    over the (T, k+d) candidates ``cand`` (int32 ids in [0, E)) and
    ``vals`` (float32 logits) of :func:`dispatch_candidates`, with the
    (E,) float32 ``load``.  Returns (experts (T, k) int32, weights (T, k)
    float32, steered (T, k) bool): experts and steered bit for bit the
    plain version's, weights within 1e-6."""
    refuse_grad("dispatch_steer", DISPATCH_GRAD, vals, load)
    if cand.device.type != "cuda":
        raise ValueError(
            f"the CUDA dispatch_steer needs tensors on a CUDA device, got "
            f"{cand.device}; use ref.steer_from_candidates on the CPU"
        )
    if cand.dim() != 2 or load.dim() != 1:
        raise ValueError(f"cand must be (T, k + d) and load (E,), got "
                         f"{tuple(cand.shape)} and {tuple(load.shape)}")
    T, kd = cand.shape
    E = load.shape[0]
    if k < 1 or kd - k < 1:
        raise ValueError(f"k and d must be >= 1, got k={k}, d={kd - k}")
    if not 1 <= E <= MAX_E:
        raise ValueError(f"E must be in [1, {MAX_E}], got {E}")
    if kd > min(E, MAX_KD):
        raise ValueError(f"k + d must be in [1, min(E, {MAX_KD})], got {kd}")
    dev = cand.device
    _check("cand", cand, torch.int32, (T, kd), dev)
    _check("vals", vals, torch.float32, (T, kd), dev)
    _check("load", load, torch.float32, (E,), dev)
    experts = torch.empty((T, k), dtype=torch.int32, device=dev)
    weights = torch.empty((T, k), dtype=torch.float32, device=dev)
    steered = torch.empty((T, k), dtype=torch.bool, device=dev)
    if T == 0:
        return experts, weights, steered
    scratch = (torch.empty((2, T), dtype=torch.float32, device=dev)
               if T > STEER_SMEM_T else None)
    mode, low, high, w_high, w_low, floor = _steer_scalars(
        T, float(f_max), float(delta_l))
    warp, count_max = steer_plan(T)
    lib = _dispatch_lib()
    with torch.cuda.device(dev):
        err = lib.dispatch_steer_launch(
            cand.data_ptr(), vals.data_ptr(), load.data_ptr(),
            experts.data_ptr(), weights.data_ptr(), steered.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            T, E, k, kd - k, mode, low, high, w_high, w_low,
            float(delta_l), float(gate_slack), floor, int(count_max),
            int(warp), _stream(dev))
    if err != 0:
        raise RuntimeError(f"dispatch_steer launch failed: cudaError {err}")
    dispatch_steer.launches += 1
    return experts, weights, steered


dispatch_steer.launches = 0
