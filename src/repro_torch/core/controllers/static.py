"""Static controller: knobs pinned at their spec inits forever.

The ablation baseline for the whole control plane -- running MIDAS
routing with ``controller="static"`` measures what the adaptive loop
itself buys.  The pressure score is still computed (it surfaces in
``TickOut.pressure``), but no knob ever moves.
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.core.controllers import base
from repro_torch.core.controllers.base import (
    ControlState,
    Controller,
    Knobs,
    Signals,
    register,
)


@register("static")
class Static(Controller):
    """Fixed-knob baseline: d=2, Δ_L=4, f_max=0.10, TTL scale 1."""

    def fast(
        self, state: ControlState, sig: Signals
    ) -> Tuple[ControlState, Knobs]:
        P = base.pressure_score(sig.B, sig.p99, state.b_tgt, state.p99_tgt)
        state = state._replace(pressure=P)
        return state, self.view(state)
