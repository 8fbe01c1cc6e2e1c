"""Controller protocol, knob/signal schema, and the controller registry.

A *controller* is the control-plane stage of the MIDAS middleware: on
the paper's fast cadence (T_fast = 250 ms) it ingests a
:class:`Signals` bundle -- the smoothed telemetry every proxy already
maintains -- and emits a :class:`Knobs` bundle, the one typed contract
every knob consumer reads (routing policies through ``RouteContext``,
the cache's slow-loop TTL retune through ``ttl_scale``).

Protocol: ``Controller.init(cfg, targets, device) -> ControlState``;
``fast(state, signals) -> (state, Knobs)`` on the fast cadence;
``slow(state, signals) -> (state, Knobs)`` on T_slow (default no-op);
``view(state) -> Knobs`` is what consumers see each tick -- the
ablation decorators (:func:`wrap_ablations`) override it to mask out a
stability mechanism while leaving the controller's dynamics untouched,
which is what the §IV-E ablation study measures.  Knobs are 0-d device
tensors, so a controller step never reads back to the host.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core import registry as registry_lib
from repro_torch.core import telemetry
from repro_torch.core.faults.base import AVAIL_FULL  # noqa: F401
from repro_torch.core.xla import reduce_sum
from repro_torch.kernels.common import resolve_device

# Paper cadences and shared control constants (Algorithm 1 lines 1-20).
T_FAST_MS = 250.0
T_SLOW_MS = 30_000.0
W_WINDOW_MS = 1000.0
PIN_C_MS = 300.0
W1, W2 = 1.0, 1.0
EPS = 1e-6
ALPHA_FAST = 0.2
BETA_SLOW = 0.1

# Knob bound constants (paper §IV-E); KNOB_SPECS is the declarative
# source of truth.
D_INIT, D_MIN, D_MAX = 2, 1, 4
DELTA_L_INIT, DELTA_L_MIN, DELTA_L_MAX = 4.0, 2.0, 8.0
F_CAP = 0.10
F_MAX_HIGH = 1.0
TTL_SCALE_MIN, TTL_SCALE_MAX = 0.25, 4.0

# ``AVAIL_FULL`` (imported above) is the fault layer's threshold: a
# detected live fraction below it counts as degraded membership.

ABLATIONS = ("no_margin", "no_pin", "no_bucket", "no_fault_signal")


class KnobSpec(NamedTuple):
    """Declarative schema of one control knob: bounds, init, step rule."""

    name: str
    lo: float
    hi: float
    init: Optional[float]  # None: derived from config (delta_t <- rtt_ms)
    step: str  # human-readable step rule
    dtype: Any = torch.float32


class Knobs(NamedTuple):
    """The typed knob bundle -- one field per :class:`KnobSpec`."""

    d: torch.Tensor  # () int32 sample width in {1..4}
    delta_l: torch.Tensor  # () float32 queue margin
    delta_t: torch.Tensor  # () float32 latency margin (ms)
    f_max: torch.Tensor  # () float32 steering-bucket cap
    pin_ms: torch.Tensor  # () float32 pin duration C (ms)
    ttl_scale: torch.Tensor  # () float32 slow-loop TTL multiplier


KNOB_SPECS: Tuple[KnobSpec, ...] = (
    KnobSpec("d", D_MIN, D_MAX, D_INIT,
             "single +1/-1 steps under hysteresis", torch.int32),
    KnobSpec("delta_l", DELTA_L_MIN, DELTA_L_MAX, DELTA_L_INIT,
             "single -1.0/+1.0 steps, opposite d"),
    KnobSpec("delta_t", 0.0, float(np.inf), None,
             "rtt·(1 ± 0.1·jitter) to avoid lockstep proxies"),
    KnobSpec("f_max", F_CAP, F_MAX_HIGH, F_CAP,
             "×2 up / ×0.5 down (bounded multiplicative)"),
    KnobSpec("pin_ms", 0.0, float(np.inf), PIN_C_MS, "static"),
    KnobSpec("ttl_scale", TTL_SCALE_MIN, TTL_SCALE_MAX, 1.0,
             "controller slow-loop hook"),
)

if tuple(s.name for s in KNOB_SPECS) != Knobs._fields:
    raise RuntimeError("KNOB_SPECS and Knobs disagree")


def spec(name: str) -> KnobSpec:
    """The :class:`KnobSpec` registered under ``name``."""
    for s in KNOB_SPECS:
        if s.name == name:
            return s
    raise ValueError(
        f"unknown knob {name!r}; available: "
        f"{', '.join(s.name for s in KNOB_SPECS)}"
    )


def init_knobs(rtt_ms: float, device=None) -> Knobs:
    """Every knob at its spec init (delta_t derives from the RTT), on
    ``device`` (the card when None)."""
    device = resolve_device(device)
    return Knobs(**{
        s.name: torch.tensor(
            rtt_ms if s.init is None else s.init, dtype=s.dtype,
            device=device,
        )
        for s in KNOB_SPECS
    })


def clip_knobs(knobs: Knobs) -> Knobs:
    """Clip every knob to its spec bounds (d stays int32)."""
    return Knobs(**{
        s.name: torch.clamp(v, s.lo, s.hi).to(s.dtype)
        for s, v in zip(KNOB_SPECS, knobs)
    })


class Signals(NamedTuple):
    """Telemetry bundle handed to controllers on each control ingest --
    the smoothed, stale view a real proxy holds (§IV-E assumption 1)."""

    B: torch.Tensor  # () float32 smoothed imbalance of the consensus view
    p99: torch.Tensor  # () float32 worst smoothed p99 across servers (ms)
    L_hat: torch.Tensor  # (m,) float32 consensus queue view
    views_p: torch.Tensor  # (P, m) float32 per-proxy views (fleet)
    write_mix: torch.Tensor  # () float32 write fraction of the T_slow
    #   window (windowed, resets each slow tick)
    jitter: torch.Tensor  # () float32 uniform in [-1, 1]
    rtt_ms: float  # transport RTT (ms)
    avail: torch.Tensor  # () float32 detected live fraction in (0, 1]
    member: torch.Tensor  # (m,) float32 detected membership (1=live)


def make_signals(
    B=0.0,
    p99=0.0,
    L_hat=None,
    views_p=None,
    write_mix=0.0,
    jitter=0.0,
    rtt_ms: float = 2.0,
    avail=1.0,
    member=None,
    device=None,
) -> Signals:
    """Signals bundle with neutral fillers -- unit tests and the legacy
    ``control.fast_update`` shim drive controllers without an engine.
    Scalars become float32 tensors on ``device`` (the card when None,
    else the device of ``L_hat`` when given)."""
    if L_hat is not None:
        device = L_hat.device
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    L = torch.zeros((1,), dtype=torch.float32, device=device) \
        if L_hat is None else L_hat
    return Signals(
        B=f32(B),
        p99=f32(p99),
        L_hat=L,
        views_p=L[None, :] if views_p is None else views_p,
        write_mix=f32(write_mix),
        jitter=f32(jitter),
        rtt_ms=rtt_ms,
        avail=f32(avail),
        member=torch.ones_like(L) if member is None else member,
    )


class ControlState(NamedTuple):
    """Carried control-plane state: knobs + targets + controller-owned
    ``inner`` state (counters, integrators, ...)."""

    knobs: Knobs
    b_tgt: torch.Tensor  # () float32 imbalance target (§III-B)
    p99_tgt: torch.Tensor  # () float32 latency target (ms)
    pressure: torch.Tensor  # () float32 last computed (logging/TickOut)
    inner: Any


def pressure_score(
    B: torch.Tensor,
    p99: torch.Tensor,
    b_tgt: torch.Tensor,
    p99_tgt: torch.Tensor,
) -> torch.Tensor:
    """P = w1·[B − B_tgt]₊ + w2·[(p̃99 − tgt)/tgt]₊ -- the shared
    pressure score every controller regulates on (w1 = w2 = 1)."""
    return W1 * torch.relu(B - b_tgt) + W2 * torch.relu(
        (p99 - p99_tgt) / torch.clamp(p99_tgt, min=EPS)
    )


def warmup_targets(
    B_series: np.ndarray, p99_warm: float, rtt_ms: float
) -> Tuple[float, float]:
    """§III-B target selection from the low-utilization warmup window
    (host-side)."""
    b_tgt = float(np.median(B_series) + 0.05)
    p99_tgt = float(max(p99_warm * 1.25, rtt_ms + 2.0))
    return b_tgt, p99_tgt


def consensus_view(
    views_p: torch.Tensor, reducer: str = "mean"
) -> torch.Tensor:
    """Collapse (P, m) per-proxy telemetry views into the single view the
    one control loop consumes (fleet mode): ``mean``, ``median`` (robust
    to one lagged proxy) or ``max`` (conservative)."""
    return telemetry.reduce_views(views_p, reducer)


# ---------------------------------------------------------------------------
# Lyapunov stability helpers (paper §IV-E, eq. 2)
# ---------------------------------------------------------------------------


def lyapunov_delta_v(
    L: torch.Tensor, p: torch.Tensor, j: torch.Tensor
) -> torch.Tensor:
    """ΔV for moving one request p→j:  2(L̂_j − L̂_p) + 2  (paper eq. 2)."""
    return 2.0 * (L[j] - L[p]) + 2.0


def lyapunov_potential(L: torch.Tensor) -> torch.Tensor:
    """V(L̂) = Σ_i (L̂_i − L̄)² of an (m,) view, with the sums in XLA's
    CPU order and the mean as jnp takes it (the sum times 1/m)."""
    c = L - reduce_sum(L) * float(np.float32(1.0 / L.shape[0]))
    return reduce_sum(c * c)


class Controller:
    """Base class for registered control-plane implementations."""

    name: str = "?"

    def init_inner(self, cfg, device=None) -> Any:
        """Controller-owned state (default: stateless)."""
        return ()

    def init(
        self, cfg, targets: Tuple[float, float], device=None
    ) -> ControlState:
        b_tgt, p99_tgt = targets
        return ControlState(
            knobs=init_knobs(cfg.rtt_ms, device),
            b_tgt=torch.tensor(b_tgt, dtype=torch.float32, device=device),
            p99_tgt=torch.tensor(
                p99_tgt, dtype=torch.float32, device=device
            ),
            pressure=torch.zeros((), dtype=torch.float32, device=device),
            inner=self.init_inner(cfg, device),
        )

    def fast(
        self, state: ControlState, sig: Signals
    ) -> Tuple[ControlState, Knobs]:
        raise NotImplementedError

    def slow(
        self, state: ControlState, sig: Signals
    ) -> Tuple[ControlState, Knobs]:
        return state, self.view(state)

    def view(self, state: ControlState) -> Knobs:
        """Knobs as consumers see them."""
        return state.knobs


REGISTRY = registry_lib.Registry("controller")


def register(name: str):
    """Class decorator adding a Controller subclass under ``name``."""
    return REGISTRY.register(name)


def unregister(name: str) -> None:
    REGISTRY.unregister(name)


def available() -> Tuple[str, ...]:
    return REGISTRY.available()


def get_class(name: str) -> Type[Controller]:
    return REGISTRY.get_class(name)


def get(name: str) -> Controller:
    return REGISTRY.get(name)


def parse_ablations(flags: str) -> Tuple[str, ...]:
    """Split an ``ablate`` spec ("no_margin,no_pin") into known tokens;
    unknown tokens raise with the alternatives listed."""
    toks = tuple(t for t in (s.strip() for s in flags.split(",")) if t)
    for t in toks:
        if t not in ABLATIONS:
            raise ValueError(
                f"unknown ablation {t!r}; available: "
                f"{', '.join(ABLATIONS)}"
            )
    return toks


class Ablated(Controller):
    """Decorator removing §IV-E stability mechanisms from the *emitted*
    knob view while leaving the wrapped controller's dynamics untouched
    -- the ablation study measures what breaks without a guard, not a
    differently-tuned controller.

      no_margin -- steer on any lighter candidate (Δ_L = 0, Δ_t = −1e9)
      no_pin    -- re-evaluate every request (C = 0)
      no_bucket -- uncapped steering (f_max = 1)
      no_fault_signal -- the controller never sees availability
                  degradation (Signals.avail/member forced healthy)
    """

    def __init__(self, inner: Controller, flags: str):
        self.inner = inner
        self.flags = parse_ablations(flags)
        self.name = f"{inner.name}[{','.join(self.flags)}]"

    def init_inner(self, cfg, device=None) -> Any:
        return self.inner.init_inner(cfg, device)

    def init(
        self, cfg, targets: Tuple[float, float], device=None
    ) -> ControlState:
        return self.inner.init(cfg, targets, device)

    def _mask_signals(self, sig: Signals) -> Signals:
        if "no_fault_signal" in self.flags:
            sig = sig._replace(avail=torch.ones_like(sig.avail),
                               member=torch.ones_like(sig.member))
        return sig

    def fast(self, state, sig):
        state, _ = self.inner.fast(state, self._mask_signals(sig))
        return state, self.view(state)

    def slow(self, state, sig):
        state, _ = self.inner.slow(state, self._mask_signals(sig))
        return state, self.view(state)

    def view(self, state: ControlState) -> Knobs:
        k = self.inner.view(state)
        if "no_margin" in self.flags:
            k = k._replace(delta_l=torch.zeros_like(k.delta_l),
                           delta_t=torch.full_like(k.delta_t, -1e9))
        if "no_pin" in self.flags:
            k = k._replace(pin_ms=torch.zeros_like(k.pin_ms))
        if "no_bucket" in self.flags:
            k = k._replace(f_max=torch.ones_like(k.f_max))
        return k


def wrap_ablations(ctrl: Controller, flags: str) -> Controller:
    """``ctrl`` unchanged for an empty spec, else the :class:`Ablated`
    decorator applying every named mechanism removal."""
    return Ablated(ctrl, flags) if parse_ablations(flags) else ctrl


# ---------------------------------------------------------------------------
# Host-side trajectory stability metrics
# ---------------------------------------------------------------------------


def trajectory_stats(
    d: np.ndarray,
    delta_l: np.ndarray,
    f_max: np.ndarray,
    pressure: np.ndarray,
    dt_ms: float,
) -> Dict[str, float]:
    """Stability metrics of one run's knob trajectories (host-side).

    * ``oscillation_per_min`` -- d-knob flips per minute (the paper's
      oscillation measure);
    * ``settle_ms`` -- time from the LAST pressure onset (final rising
      edge of P) to the last knob change at or after it; 0.0 if
      pressure never rose or knobs never moved after that onset;
    * ``knob_churn`` -- mean per-tick |Δknob| normalized by each knob's
      spec range, summed over (d, delta_l, f_max);
    * ``settled`` -- 1.0 when the final 10% of the horizon is
      change-free.
    """
    d = np.asarray(d, np.float64)
    dl = np.asarray(delta_l, np.float64)
    fm = np.asarray(f_max, np.float64)
    pr = np.asarray(pressure, np.float64)
    T = d.shape[0]
    if T < 2:
        return {"oscillation_per_min": 0.0, "settle_ms": 0.0,
                "knob_churn": 0.0, "settled": 1.0}
    minutes = T * dt_ms / 60_000.0
    flips = int(np.sum(np.diff(d) != 0))
    change = (
        (np.diff(d) != 0) | (np.diff(dl) != 0) | (np.diff(fm) != 0)
    )
    rising = np.flatnonzero((pr[1:] > 0.0) & (pr[:-1] <= 0.0)) + 1
    if pr[0] > 0.0:
        rising = np.concatenate([[0], rising])
    if rising.size == 0 or not change.any():
        settle_ms = 0.0
    else:
        onset = int(rising[-1])
        chg = np.flatnonzero(change) + 1  # tick indices of knob changes
        after = chg[chg >= onset]
        settle_ms = float(after[-1] - onset) * dt_ms if after.size else 0.0
    churn = 0.0
    for series, name in ((d, "d"), (dl, "delta_l"), (fm, "f_max")):
        s = spec(name)
        rng = (s.hi - s.lo) if np.isfinite(s.hi) else 1.0
        churn += float(np.mean(np.abs(np.diff(series))) / max(rng, EPS))
    tail = change[-max(T // 10, 1):]
    return {
        "oscillation_per_min": flips / minutes,
        "settle_ms": settle_ms,
        "knob_churn": churn,
        "settled": float(not tail.any()),
    }
