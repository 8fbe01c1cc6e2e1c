"""AIMD controller: additive-increase / multiplicative-decrease on one
aggressiveness axis.

The controller carries a single scalar ``a ∈ [0, 1]`` ("routing
aggressiveness").  While the pressure score is positive, ``a`` ramps
*additively* (+AI per fast tick); the moment pressure clears, ``a``
collapses *multiplicatively* (×MD).  Knobs derive from ``a`` along each
spec's range:

    d       = round(D_MIN     + a·(D_MAX − D_MIN))
    Δ_L     = Δ_L_MAX         − a·(Δ_L_MAX − Δ_L_MIN)
    f_max   = F_CAP           + a·(F_MAX_HIGH − F_CAP)

so bounds hold by construction.  Each line is one multiply-add, fused
as the reference engine computes it on the CPU (``xla.fma``); ``round``
is half to even in both packages.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.controllers import base
from repro_torch.core.controllers.base import (
    ControlState,
    Controller,
    Knobs,
    Signals,
    register,
)
from repro_torch.core.xla import fma

AI = 0.05  # additive aggressiveness step per pressured fast tick
MD = 0.5  # multiplicative back-off once pressure clears


def _knobs_from_axis(k: Knobs, a: torch.Tensor, rtt_ms: float) -> Knobs:
    """Affine map from the aggressiveness axis to every routing knob."""
    d = torch.round(fma(a, base.D_MAX - base.D_MIN, base.D_MIN))
    delta_l = fma(-a, base.DELTA_L_MAX - base.DELTA_L_MIN, base.DELTA_L_MAX)
    f_max = fma(a, base.F_MAX_HIGH - base.F_CAP, base.F_CAP)
    return k._replace(
        d=d.to(torch.int32),
        delta_l=delta_l,
        delta_t=torch.full_like(k.delta_t, rtt_ms),
        f_max=f_max,
    )


@register("aimd")
class Aimd(Controller):
    """Probe additively under pressure, back off multiplicatively."""

    def init_inner(self, cfg, device=None) -> torch.Tensor:
        # the aggressiveness axis a
        return torch.zeros((), dtype=torch.float32, device=device)

    def fast(
        self, state: ControlState, sig: Signals
    ) -> Tuple[ControlState, Knobs]:
        P = base.pressure_score(sig.B, sig.p99, state.b_tgt, state.p99_tgt)
        a = torch.where(P > 0.0, state.inner + AI, state.inner * MD)
        a = torch.clamp(a, 0.0, 1.0)
        state = state._replace(
            knobs=base.clip_knobs(
                _knobs_from_axis(state.knobs, a, sig.rtt_ms)
            ),
            pressure=P,
            inner=a,
        )
        return state, self.view(state)
