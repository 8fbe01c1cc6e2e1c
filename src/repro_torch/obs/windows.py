"""The warmup/stable/cooldown windowing contract.

Every E-series number the repo publishes is a steady-state claim, but a
raw whole-run mean mixes the transient (queues filling from empty, the
controller still hunting for its operating point) with the steady state
the paper's claims are about.  This module is the ONE shared detector
every benchmark runner uses, so "steady state" is a measured, recorded,
machine-checkable property of each artifact cell instead of an implicit
assumption of each script.

Algorithm (``method="ewma_plateau"``), over a per-tick scalar series
(the per-tick across-server mean queue the engine now emits in both
metrics modes):

1. Smooth with :func:`repro_torch.core.telemetry.ewma_series`, initialized at
   the first sample (``init=x[0]``) so the filter itself adds no
   artificial ramp.
2. **EWMA slope**: normalized step ``|s[t]-s[t-1]| / max|s|`` must stay
   below ``slope_tol`` — the smoothed level has stopped moving.
3. **Variance plateau**: the trailing ``hold``-tick rolling std of the
   RAW series must fall to its long-run level (``var_tol`` × the std of
   the trailing half) — the local noise floor has flattened, not just
   the mean.
4. ``begin`` is the first tick opening a ``hold``-long run where both
   conditions hold; ``end`` trims the trailing run where they fail
   (cooldown).  No such run within ``max_warmup_frac`` of the horizon,
   a horizon shorter than ``2*hold`` (pure transient), or a non-finite
   series ⇒ a **censored** window (``begin == end == T``,
   ``method="censored"``) — recorded, never a crash.

Invariant: ``0 <= begin <= end <= T`` for arbitrary timelines, and
windowed statistics fall back to whole-run statistics when the window
is censored (with the parity shift reported as 0).  Host-side numpy:
the same numbers as the reference's module on the same series.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# defaults shared by every runner
ALPHA = 0.2  # EWMA smoothing, same fast-loop constant as the controller
SLOPE_TOL = 0.02  # normalized per-tick EWMA step bound
VAR_TOL = 1.5  # rolling-std bound, × the trailing-half std
HOLD = 8  # ticks both conditions must hold to open/keep the window
MAX_WARMUP_FRAC = 0.5  # later onsets are censored, not believed


@dataclasses.dataclass(frozen=True)
class Window:
    """One detected stable window over a T-tick series: stable ticks
    are the half-open ``[begin, end)``; ``[0, begin)`` is warmup and
    ``[end, T)`` cooldown.  ``begin == end`` means no stable region."""

    begin: int
    end: int
    T: int
    method: str

    def __post_init__(self):
        if not 0 <= self.begin <= self.end <= self.T:
            raise ValueError(
                f"window invariant violated: begin={self.begin} "
                f"end={self.end} T={self.T}"
            )

    @property
    def censored(self) -> bool:
        return self.method == "censored"

    @property
    def n_stable(self) -> int:
        return self.end - self.begin

    def to_json(self, dt_ms: Optional[float] = None) -> dict:
        doc = {
            "begin": self.begin,
            "end": self.end,
            "T": self.T,
            "method": self.method,
            "censored": self.censored,
        }
        if dt_ms is not None:
            doc["begin_ms"] = round(self.begin * dt_ms, 1)
            doc["end_ms"] = round(self.end * dt_ms, 1)
        return doc


def _rolling_std(x: np.ndarray, w: int) -> np.ndarray:
    """Trailing-window std: ``rstd[t] = std(x[max(0, t-w+1) : t+1])``
    via cumulative sums (O(T), exact up to fp cancellation, clipped)."""
    c1 = np.cumsum(np.concatenate(([0.0], x)))
    c2 = np.cumsum(np.concatenate(([0.0], x * x)))
    t = np.arange(x.size)
    lo = np.maximum(t - w + 1, 0)
    n = (t - lo + 1).astype(np.float64)
    mean = (c1[t + 1] - c1[lo]) / n
    var = (c2[t + 1] - c2[lo]) / n - mean * mean
    return np.sqrt(np.maximum(var, 0.0))


def detect(
    series,
    *,
    alpha: float = ALPHA,
    slope_tol: float = SLOPE_TOL,
    var_tol: float = VAR_TOL,
    hold: int = HOLD,
    max_warmup_frac: float = MAX_WARMUP_FRAC,
) -> Window:
    """Detect the stable window of a per-tick scalar series (see the
    module docstring for the algorithm and the censoring contract)."""
    x = np.asarray(series, np.float64).reshape(-1)
    T = int(x.size)
    if T < 2 * hold or not np.all(np.isfinite(x)):
        return Window(begin=T, end=T, T=T, method="censored")
    from repro_torch.core.telemetry import ewma_series  # lazy: no cycle

    # init at x[0]: the filter itself must not add an artificial ramp
    s = ewma_series(x, alpha, init=x[0])
    scale = float(np.max(np.abs(s))) + 1e-9
    slope = np.abs(np.diff(s, prepend=s[0])) / scale
    rstd = _rolling_std(x, hold)
    half = T // 2
    ref_std = float(np.std(x[half:]))
    ok = (slope < slope_tol) & (
        rstd <= var_tol * ref_std + 1e-9 + 1e-6 * scale
    )
    # first index opening a hold-long all-ok run
    runs = np.convolve(ok.astype(np.float64), np.ones(hold), "valid")
    starts = np.flatnonzero(runs >= hold - 0.5)
    if starts.size == 0 or starts[0] > max_warmup_frac * T:
        return Window(begin=T, end=T, T=T, method="censored")
    begin = int(starts[0])
    # cooldown: trim the trailing not-ok run (never past the last
    # stable run, which ends at or after begin + hold)
    end = int(np.flatnonzero(ok)[-1]) + 1
    end = max(end, begin + hold)
    return Window(begin=begin, end=end, T=T, method="ewma_plateau")


# ---------------------------------------------------------------------------
# Row/cell helpers the E-series runners share
# ---------------------------------------------------------------------------


def q_mean_series(row) -> np.ndarray:
    """The per-tick across-server mean-queue series of one engine row.

    Full-metrics :class:`repro_torch.core.sim.SimResult` rows reduce
    their ``(T, m)`` queue timeline; streaming :class:`SummaryResult`
    rows carry the same series as ``q_mean_timeline`` (a ``KnobTrace``
    field: O(T) scalars survive ``metrics="summary"``).
    """
    q = getattr(row, "q_mean_timeline", None)
    if q is not None:
        return np.asarray(q, np.float64)
    tl = getattr(row, "queue_timeline", None)
    if tl is not None:
        return np.asarray(tl, np.float64).mean(axis=1)
    raise ValueError(
        f"row {type(row).__name__} carries no mean-queue series; "
        f"expected a SimResult or a SummaryResult with q_mean_timeline"
    )


def windowed_stats(series, window: Window) -> dict:
    """Raw vs stable-only mean of one series, plus the parity shift
    (relative move of the windowed number; 0.0 when censored — the
    stable number falls back to the raw one rather than vanishing)."""
    x = np.asarray(series, np.float64).reshape(-1)
    raw = float(x.mean()) if x.size else 0.0
    if window.n_stable > 0:
        stable = float(x[window.begin:window.end].mean())
    else:
        stable = raw
    shift = (stable - raw) / (abs(raw) + 1e-9)
    return {"raw": raw, "stable": stable, "shift": shift}


def cell_block(
    rows: Sequence,
    dt_ms: Optional[float] = None,
    **detect_kw,
) -> dict:
    """The ``window`` block every E-series artifact cell records.

    Detects ONE window on the seed-averaged mean-queue series (the
    cell's configuration has one steady state; averaging seeds before
    detection stops per-seed noise from fragmenting it), then computes
    stable-only statistics per seed inside that shared window and
    averages — so the stable numbers aggregate exactly like the raw
    numbers they sit next to.  ``window_shift`` is the parity field:
    how far (relative) the windowed mean queue moved from the raw one.
    """
    series = [q_mean_series(r) for r in rows]
    w = detect(np.mean(series, axis=0), **detect_kw)
    per_seed = [windowed_stats(s, w) for s in series]
    raw = float(np.mean([p["raw"] for p in per_seed]))
    stable = float(np.mean([p["stable"] for p in per_seed]))
    return {
        "window": w.to_json(dt_ms),
        "stable": {"mean_queue": round(stable, 4)},
        "window_shift": {
            "mean_queue": round((stable - raw) / (abs(raw) + 1e-9), 4)
        },
    }
