"""Parametric adversarial workload: traffic tuned to break controllers.

An :class:`AdversaryParams` vector shapes a burst train out of the
combinators -- ``scale_rate`` over a ``skewed`` burst, ``shift_hotset``
rotating the hot directory set each cycle, ``concat`` stitching
burst/quiet phases, ``mix`` folding in a light background tenant --
with parameters able to resonate with the control plane's own cadences
(the hysteresis controller escalates after ``K_UP`` fast ticks above
the band and releases after ``K_DOWN`` below).  :func:`save_trace`
exports any realized grid as a ``trace_replay``-compatible ``.npz``.

The parameter box, the numpy draws of :func:`random_params` and
:func:`perturb`, and :func:`to_events` are the reference's
(``repro/core/workloads/adversary.py``) bit for bit; the grid's arrival
counts are ``torch.poisson`` draws (:mod:`.base`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.workloads import combinators
from repro_torch.core.workloads.base import (
    Workload,
    WorkloadParams,
    WorkloadSpec,
    register,
)

#: (lo, hi) per parameter, the search box the hill-climb explores.
BOUNDS = {
    "period": (20.0, 240.0),   # burst period in ticks
    "duty": (0.10, 0.90),      # burst fraction of each period
    "shift_frac": (0.0, 1.0),  # hotset rotation per cycle, × N
    "write_hi": (0.0, 0.80),   # write fraction inside bursts
    "amp": (0.5, 4.0),         # burst rate, × aggregate capacity
}

# skewed builds at 0.70 × capacity; amp is expressed in capacities
_SKEWED_RATE = 0.70
# background tenant share of (tick, slot) cells in the final mix
_BG_MIX = 0.15


@dataclasses.dataclass(frozen=True)
class AdversaryParams:
    """The continuous adversary vector.

    The defaults sit in the resonant regime for the default hysteresis
    cadence: each ~24-tick burst at ~capacity clears ``K_UP`` and each
    ~136-tick quiet phase clears ``K_DOWN``, so d climbs and releases
    every cycle -- a sustained limit cycle rather than a saturating
    overload."""

    period: float = 160.0
    duty: float = 0.15
    shift_frac: float = 0.37
    write_hi: float = 0.50
    amp: float = 1.0

    def to_vector(self) -> np.ndarray:
        return np.array([getattr(self, k) for k in BOUNDS], np.float64)

    @classmethod
    def from_vector(cls, v) -> "AdversaryParams":
        """Clip ``v`` into the search box and build the params."""
        kw = {}
        for (name, (lo, hi)), x in zip(BOUNDS.items(), np.asarray(v)):
            kw[name] = float(np.clip(x, lo, hi))
        return cls(**kw)

    def clipped(self) -> "AdversaryParams":
        return AdversaryParams.from_vector(self.to_vector())


def random_params(rng: np.random.Generator) -> AdversaryParams:
    """Uniform draw from the search box (a hill-climb restart)."""
    v = [rng.uniform(lo, hi) for lo, hi in BOUNDS.values()]
    return AdversaryParams.from_vector(v)


def perturb(
    params: AdversaryParams,
    rng: np.random.Generator,
    scale: float = 0.2,
) -> AdversaryParams:
    """Gaussian step in box-normalized coordinates (clipped)."""
    v = params.to_vector()
    for i, (lo, hi) in enumerate(BOUNDS.values()):
        v[i] += rng.normal(0.0, scale) * (hi - lo)
    return AdversaryParams.from_vector(v)


@register("adversarial")
class Adversarial(WorkloadSpec):
    """Resonant burst train shaped by an :class:`AdversaryParams`.

    ``make_workload("adversarial", ..., params=AdversaryParams(...))``
    or individual overrides (``period=..., duty=..., ...``).
    """

    def __init__(self, params: AdversaryParams = None, **overrides):
        base = params if params is not None else AdversaryParams()
        if overrides:
            unknown = set(overrides) - set(BOUNDS)
            if unknown:
                raise ValueError(
                    f"unknown adversary parameter(s) "
                    f"{sorted(unknown)}; available: {', '.join(BOUNDS)}"
                )
            base = dataclasses.replace(base, **overrides)
        self.params = base.clipped()

    def build(self, p: WorkloadParams) -> Workload:
        ap = self.params
        period = max(int(round(ap.period)), 2)
        burst_len = int(np.clip(round(period * ap.duty), 1, period - 1))
        cycles = -(-p.T // period)  # ceil: cover the horizon, then trim
        shift_step = int(round(ap.shift_frac * p.N))
        train = None
        for c in range(cycles):
            # decorrelate cycles: each burst is a different hostile job
            sc = p.seed * 1_000_003 + 7919 * c
            burst = combinators.scale_rate(
                p.make("skewed", T=burst_len, seed=sc,
                       write_frac=ap.write_hi),
                ap.amp / _SKEWED_RATE,
                seed=sc + 1,
            )
            part = combinators.shift_hotset(burst, (c * shift_step) % p.N)
            if burst_len < period:
                quiet = p.make("light", T=period - burst_len, seed=sc + 2)
                part = combinators.concat(part, quiet)
            train = part if train is None else combinators.concat(
                train, part)
        train = train._replace(
            keys=train.keys[: p.T],
            mask=train.mask[: p.T],
            is_write=train.is_write[: p.T],
        )
        bg = p.make("light", seed=p.seed + 101)
        wl = combinators.mix(train, bg, _BG_MIX, seed=p.seed + 211)
        return wl._replace(name="adversarial")


# ---------------------------------------------------------------------------
# Trace export: realized grid -> trace_replay-compatible events
# ---------------------------------------------------------------------------


def to_events(
    wl: Workload, dt_ms: float = 50.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a realized grid into ``(t_ms, key, is_write)`` events
    (host-side numpy).

    Slots spread inside their tick (preserving slot order, never
    crossing the tick boundary), so a ``trace_replay`` with the same
    ``T``/``R``/``N``/``dt_ms`` and ``loop=False`` reproduces each
    tick's event multiset exactly.
    """
    keys = wl.keys.cpu().numpy()
    mask = wl.mask.cpu().numpy().astype(bool)
    wr = wl.is_write.cpu().numpy().astype(bool)
    t_idx, slot = np.nonzero(mask)  # row-major: slot order kept per tick
    R = mask.shape[1]
    t_ms = t_idx * dt_ms + (slot + 0.5) * (dt_ms / (R + 1))
    return (
        t_ms.astype(np.float64),
        keys[t_idx, slot].astype(np.int64),
        wr[t_idx, slot],
    )


def save_trace(path, wl: Workload, dt_ms: float = 50.0) -> None:
    """Write ``wl`` as a ``trace_replay`` ``.npz`` (``trace.TRACE_FIELDS``)."""
    t_ms, key, is_write = to_events(wl, dt_ms)
    np.savez(path, t_ms=t_ms, key=key, is_write=is_write)
