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
``view(state) -> Knobs`` is what consumers see each tick.  Knobs are
0-d device tensors, so a controller step never reads back to the host.

The ablation decorators and the oscillation guard are not ported yet:
:func:`wrap_ablations` and :func:`wrap_guard` accept only their
identity settings.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core import registry as registry_lib
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

# Detected live fraction below which membership counts as degraded (the
# fault layer's threshold; constant 1.0 while faults are not ported).
AVAIL_FULL = 1.0 - 1e-6

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


def wrap_ablations(ctrl: Controller, flags: str) -> Controller:
    """``ctrl`` unchanged for an empty spec; the ablation decorators are
    not ported yet (ROADMAP §1 item 14)."""
    if parse_ablations(flags):
        raise NotImplementedError(
            "ablations are not ported yet (ROADMAP §1 item 14)"
        )
    return ctrl


def wrap_guard(ctrl: Controller, guard: bool) -> Controller:
    """``ctrl`` unchanged without the guard; the oscillation guard is
    not ported yet (ROADMAP §1 item 14)."""
    if guard:
        raise NotImplementedError(
            "the oscillation guard is not ported yet (ROADMAP §1 item 14)"
        )
    return ctrl
