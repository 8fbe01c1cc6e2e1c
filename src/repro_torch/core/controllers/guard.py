"""Oscillation guard: a limit-cycle circuit breaker around a controller.

Adversarial traffic tuned to the controllers' own cadences can drive a
reactive control law into a sustained limit cycle -- d flapping between
bounds in lockstep with the attacker's burst period.  The guard is a
decorator in the shape of :class:`~.base.Ablated` that *watches the
stored d knob* and freezes it when it flips too often.

* **watch** -- every fast tick the guard counts flips of the stored
  ``d`` since the last slow tick; the wrapped controller runs untouched.
* **trip** -- at each slow tick a window with ``>= TRIP_FLIPS`` flips
  trips the breaker: the guard records the current ``d`` / ``f_max`` as
  holds and freezes for ``HOLD_WINDOWS`` slow windows.
* **frozen** -- while frozen, the *stored* knobs are overridden each
  control tick: ``d`` pinned at the hold, ``delta_l`` at the top of its
  spec (steer only on large imbalance), ``f_max`` pinned.  Consumers,
  ``TickOut`` and the oscillation metric all read the stored knobs, and
  the wrapped controller's next step departs from the held point.
* **release** -- the freeze counts down one per slow window; a calm
  window lets it expire, a hostile one re-trips it.

``wrap_guard(ctrl, False)`` returns ``ctrl`` unchanged.  The engine
composes ``wrap_guard(wrap_ablations(ctrl, ablate), guard)``: the guard
sees the same masked signals the ablated controller does.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.controllers import base
from repro_torch.core.controllers.base import (
    ControlState,
    Controller,
    Knobs,
    Signals,
)

# d flips within one T_slow window that trip the breaker
TRIP_FLIPS = 8
# slow windows one trip freezes (re-tripped while the attack persists)
HOLD_WINDOWS = 2


class GuardInner(NamedTuple):
    """Guard-owned carry wrapped around the inner controller's state."""

    wrapped: Any               # the decorated controller's own inner
    flips: torch.Tensor        # () int32 d flips since the last slow tick
    last_d: torch.Tensor       # () int32 stored d at the last control tick
    frozen: torch.Tensor       # () int32 freeze windows remaining
    hold_d: torch.Tensor       # () int32 d pinned while frozen
    hold_f: torch.Tensor       # () float32 f_max pinned while frozen


class Guarded(Controller):
    """Decorator freezing d / widening the band on detected thrash."""

    def __init__(self, inner: Controller):
        self.inner = inner
        self.name = f"{inner.name}+guard"

    def init_inner(self, cfg, device=None) -> GuardInner:
        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)

        return GuardInner(
            wrapped=self.inner.init_inner(cfg, device),
            flips=i32(0),
            last_d=i32(base.D_INIT),
            frozen=i32(0),
            hold_d=i32(base.D_INIT),
            hold_f=torch.tensor(base.F_CAP, dtype=torch.float32,
                                device=device),
        )

    def init(
        self, cfg, targets: Tuple[float, float], device=None
    ) -> ControlState:
        state = self.inner.init(cfg, targets, device)
        return state._replace(
            inner=self.init_inner(cfg, device)._replace(wrapped=state.inner)
        )

    def _freeze(self, knobs: Knobs, gi: GuardInner) -> Knobs:
        frz = gi.frozen > 0
        return knobs._replace(
            d=torch.where(frz, gi.hold_d, knobs.d),
            delta_l=torch.where(frz, base.DELTA_L_MAX, knobs.delta_l),
            f_max=torch.where(frz, gi.hold_f, knobs.f_max),
        )

    def fast(self, state: ControlState, sig: Signals):
        gi = state.inner
        istate, _ = self.inner.fast(state._replace(inner=gi.wrapped), sig)
        knobs = self._freeze(istate.knobs, gi)
        flips = gi.flips + (knobs.d != gi.last_d).to(torch.int32)
        state = istate._replace(
            knobs=knobs,
            inner=gi._replace(
                wrapped=istate.inner, flips=flips, last_d=knobs.d
            ),
        )
        return state, self.view(state)

    def slow(self, state: ControlState, sig: Signals):
        gi = state.inner
        istate, _ = self.inner.slow(state._replace(inner=gi.wrapped), sig)
        trip = gi.flips >= TRIP_FLIPS
        newly = trip & (gi.frozen <= 0)
        gi = gi._replace(
            wrapped=istate.inner,
            flips=torch.zeros_like(gi.flips),
            frozen=torch.where(trip, HOLD_WINDOWS,
                               torch.clamp(gi.frozen - 1, min=0)),
            hold_d=torch.where(newly, istate.knobs.d, gi.hold_d),
            hold_f=torch.where(newly, istate.knobs.f_max, gi.hold_f),
        )
        knobs = self._freeze(istate.knobs, gi)
        state = istate._replace(knobs=knobs,
                                inner=gi._replace(last_d=knobs.d))
        return state, self.view(state)

    def view(self, state: ControlState) -> Knobs:
        # stored knobs already carry the freeze; delegate so ablation
        # masks compose (the guard wraps the Ablated decorator)
        return self.inner.view(state._replace(inner=state.inner.wrapped))


def wrap_guard(ctrl: Controller, enabled: bool) -> Controller:
    """``ctrl`` unchanged when disabled, else the :class:`Guarded`
    oscillation breaker around it."""
    return Guarded(ctrl) if enabled else ctrl
