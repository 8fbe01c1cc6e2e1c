"""The paper's hysteresis controller (§IV-E, Algorithm 1 lines 26-35).

Pressure P = w1·[B − B_tgt]₊ + w2·[(p̃99 − tgt)/tgt]₊ is compared
against a hysteresis band (H↓ = 0.02 < H↑ = 0.10); only after K↑ = 3
consecutive ticks above (K↓ = 8 below) do the knobs move, in single
bounded steps -- d ± 1, Δ_L ∓ 1, f_max ×2/×½ -- and the counter that
fired resets.  While detected membership is degraded
(``Signals.avail < AVAIL_FULL``) it escalates at once and never
de-escalates; with full availability that test is constant-false.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.controllers import base
from repro_torch.core.controllers.base import (
    AVAIL_FULL,
    ControlState,
    Controller,
    Knobs,
    Signals,
    register,
)
from repro_torch.core.xla import fma

# Hysteresis thresholds and counters (paper defaults).
H_DOWN, H_UP = 0.02, 0.10
K_UP, K_DOWN = 3, 8


class HysteresisInner(NamedTuple):
    above_cnt: torch.Tensor  # () int32 consecutive P > H_up
    below_cnt: torch.Tensor  # () int32 consecutive P < H_down


@register("hysteresis")
class Hysteresis(Controller):
    """Counter-gated single-step knob moves inside a pressure deadband."""

    def init_inner(self, cfg, device=None) -> HysteresisInner:
        z = torch.zeros((), dtype=torch.int32, device=device)
        return HysteresisInner(above_cnt=z, below_cnt=z)

    def fast(
        self, state: ControlState, sig: Signals
    ) -> Tuple[ControlState, Knobs]:
        k = state.knobs
        P = base.pressure_score(sig.B, sig.p99, state.b_tgt, state.p99_tgt)
        above = torch.where(P > H_UP, state.inner.above_cnt + 1, 0)
        below = torch.where(P < H_DOWN, state.inner.below_cnt + 1, 0)

        degraded = sig.avail < AVAIL_FULL
        go_up = (above >= K_UP) | degraded
        go_down = (below >= K_DOWN) & ~degraded

        d = torch.where(
            go_up,
            torch.clamp(k.d + 1, max=base.D_MAX),
            torch.where(go_down, torch.clamp(k.d - 1, min=base.D_MIN), k.d),
        )
        delta_l = torch.where(
            go_up,
            torch.clamp(k.delta_l - 1.0, min=base.DELTA_L_MIN),
            torch.where(
                go_down,
                torch.clamp(k.delta_l + 1.0, max=base.DELTA_L_MAX),
                k.delta_l,
            ),
        )
        f_max = torch.where(
            go_up,
            torch.clamp(k.f_max * 2.0, max=base.F_MAX_HIGH),
            torch.where(
                go_down, torch.clamp(k.f_max * 0.5, min=base.F_CAP), k.f_max
            ),
        )
        # reset the counter that fired
        above = torch.where(go_up, 0, above)
        below = torch.where(go_down, 0, below)

        # rtt·(1 + 0.1·jitter), fused as the reference engine computes it
        delta_t = fma(0.1 * sig.rtt_ms, sig.jitter, sig.rtt_ms)

        state = state._replace(
            knobs=k._replace(
                d=d, delta_l=delta_l, delta_t=delta_t, f_max=f_max
            ),
            pressure=P,
            inner=HysteresisInner(above_cnt=above, below_cnt=below),
        )
        return state, self.view(state)
