"""Migration shim: the control plane lives in :mod:`.controllers`.

The §IV-E fast/slow control loop used to be one module with a flat
``ControlState``.  The registry (:mod:`repro_torch.core.controllers`)
replaced it; this module keeps the historical names -- the constants,
the legacy flat ``ControlState``, ``init_control`` / ``fast_update``
(thin adapters over the registered hysteresis controller) and the
pressure / warmup / consensus / Lyapunov helpers -- so old call sites
keep working bit for bit.  New code imports from :mod:`.controllers`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.controllers import base as _base
from repro_torch.core.controllers import hysteresis as _hyst
from repro_torch.core.controllers.base import (  # noqa: F401
    ALPHA_FAST,
    BETA_SLOW,
    D_INIT,
    D_MAX,
    D_MIN,
    DELTA_L_INIT,
    DELTA_L_MAX,
    DELTA_L_MIN,
    EPS,
    F_CAP,
    F_MAX_HIGH,
    PIN_C_MS,
    T_FAST_MS,
    T_SLOW_MS,
    W_WINDOW_MS,
    W1,
    W2,
    lyapunov_delta_v,
    lyapunov_potential,
    warmup_targets,
)
from repro_torch.core.controllers.hysteresis import (  # noqa: F401
    H_DOWN,
    H_UP,
    K_DOWN,
    K_UP,
)
from repro_torch.kernels.common import resolve_device


class ControlState(NamedTuple):
    """Legacy flat control state (pre-registry layout)."""

    d: torch.Tensor  # () int32 in {1..4}
    delta_l: torch.Tensor  # () float32 in [2, 8]
    delta_t: torch.Tensor  # () float32 ms latency margin
    f_max: torch.Tensor  # () float32 steering cap
    above_cnt: torch.Tensor  # () int32 consecutive P > H_up
    below_cnt: torch.Tensor  # () int32 consecutive P < H_down
    b_tgt: torch.Tensor  # () float32
    p99_tgt: torch.Tensor  # () float32 ms
    pressure: torch.Tensor  # () float32 (last computed, for logging)


def _to_registry(ctrl: ControlState) -> _base.ControlState:
    """Legacy flat layout -> registry ControlState (hysteresis inner)."""
    knobs = _base.init_knobs(0.0, ctrl.d.device)._replace(
        d=ctrl.d, delta_l=ctrl.delta_l, delta_t=ctrl.delta_t,
        f_max=ctrl.f_max,
    )
    return _base.ControlState(
        knobs=knobs,
        b_tgt=ctrl.b_tgt,
        p99_tgt=ctrl.p99_tgt,
        pressure=ctrl.pressure,
        inner=_hyst.HysteresisInner(
            above_cnt=ctrl.above_cnt, below_cnt=ctrl.below_cnt
        ),
    )


def _from_registry(st: _base.ControlState) -> ControlState:
    k = st.knobs
    return ControlState(
        d=k.d,
        delta_l=k.delta_l,
        delta_t=k.delta_t,
        f_max=k.f_max,
        above_cnt=st.inner.above_cnt,
        below_cnt=st.inner.below_cnt,
        b_tgt=st.b_tgt,
        p99_tgt=st.p99_tgt,
        pressure=st.pressure,
    )


def init_control(
    rtt_ms: float, b_tgt: float = 0.15, p99_tgt: float = 500.0,
    device=None,
) -> ControlState:
    """The legacy state at its inits, on ``device`` (the card when
    None)."""
    dev = resolve_device(device)

    def t(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=dev)

    return ControlState(
        d=t(D_INIT, torch.int32),
        delta_l=t(DELTA_L_INIT),
        delta_t=t(rtt_ms),
        f_max=t(F_CAP),
        above_cnt=t(0, torch.int32),
        below_cnt=t(0, torch.int32),
        b_tgt=t(b_tgt),
        p99_tgt=t(p99_tgt),
        pressure=t(0.0),
    )


def consensus_view(
    views_p: torch.Tensor, reducer: str = "mean"
) -> torch.Tensor:
    """See :func:`repro_torch.core.controllers.consensus_view`."""
    return _base.consensus_view(views_p, reducer)


def pressure_score(
    B: torch.Tensor, p99: torch.Tensor, ctrl: ControlState
) -> torch.Tensor:
    return _base.pressure_score(B, p99, ctrl.b_tgt, ctrl.p99_tgt)


def fast_update(
    ctrl: ControlState,
    B,
    p99,
    rtt_ms: float,
    jitter,
) -> ControlState:
    """One fast-loop knob update (Alg. 1 lines 26-35): the registered
    ``hysteresis`` controller on the legacy flat state."""
    sig = _base.make_signals(B=B, p99=p99, jitter=jitter, rtt_ms=rtt_ms,
                             device=ctrl.d.device)
    st, _ = _hyst.Hysteresis().fast(_to_registry(ctrl), sig)
    return _from_registry(st)
