"""Deadband integral controller on the pressure score.

An anti-windup integrator ``I ∈ [0, 1]`` accumulates how far pressure
sits OUTSIDE the deadband (the hysteresis controller's [H↓, H↑] band):

    I ← clip(I + KI·[P − H↑]₊ − KR·[H↓ − P]₊, 0, 1)

Inside the deadband the integrator -- and every knob -- is frozen;
above it knobs ramp smoothly, and release (KR < KI) is slower than
attack.  Knobs derive from ``I`` with the AIMD controller's affine map.

The slow hook retunes ``ttl_scale`` from the write-mix signal: under
mutation-dominated traffic TTL-mode cache entries die before reuse, so
the controller halves the TTL multiplier (floor TTL_SCALE_MIN) and
doubles it back toward 1 when reads dominate.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.controllers import base
from repro_torch.core.controllers.aimd import _knobs_from_axis
from repro_torch.core.controllers.base import (
    ControlState,
    Controller,
    Knobs,
    Signals,
    register,
)
from repro_torch.core.controllers.hysteresis import H_DOWN, H_UP
from repro_torch.core.xla import fma

KI = 0.10  # integral attack gain (per fast tick above the band)
KR = 0.02  # integral release gain (per fast tick below the band)
W_SHRINK = 0.3  # write-mix threshold for the slow TTL retune


@register("deadband_pid")
class DeadbandPid(Controller):
    """Anti-windup integral control with a frozen deadband."""

    def init_inner(self, cfg, device=None) -> torch.Tensor:
        # the integrator I
        return torch.zeros((), dtype=torch.float32, device=device)

    def fast(
        self, state: ControlState, sig: Signals
    ) -> Tuple[ControlState, Knobs]:
        P = base.pressure_score(sig.B, sig.p99, state.b_tgt, state.p99_tgt)
        # the two multiply-adds fused, as the reference engine fuses them
        i = fma(-KR, torch.relu(H_DOWN - P),
                fma(KI, torch.relu(P - H_UP), state.inner))
        i = torch.clamp(i, 0.0, 1.0)
        state = state._replace(
            knobs=base.clip_knobs(
                _knobs_from_axis(state.knobs, i, sig.rtt_ms)
            ),
            pressure=P,
            inner=i,
        )
        return state, self.view(state)

    def slow(
        self, state: ControlState, sig: Signals
    ) -> Tuple[ControlState, Knobs]:
        k = state.knobs
        scale = torch.where(
            sig.write_mix > W_SHRINK,
            k.ttl_scale * 0.5,
            torch.clamp(k.ttl_scale * 2.0, max=1.0),
        )
        scale = torch.clamp(scale, base.TTL_SCALE_MIN, base.TTL_SCALE_MAX)
        state = state._replace(knobs=k._replace(ttl_scale=scale))
        return state, self.view(state)
