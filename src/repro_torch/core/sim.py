"""Queue-network simulator for the MIDAS evaluation (paper §VI).

m metadata servers, each a FIFO queue with constant 100 ms service time
(the paper's stress bound).  Time advances in dt_ms ticks; each tick
first runs the middleware pipeline (the cooperative cache absorbs read
hits at the proxy), then routes the surviving batch in ``n_groups``
sequential waves with the policy resolved from the registry, applies
service, refreshes the (delayed) telemetry, and runs the fast/slow
control loops on their paper cadences.  Every wave sees the stale EWMA
telemetry *plus* the proxies' own sends from earlier waves of the tick.
Under fleet routing each of the ``P`` proxies routes one wave (the
slots r ≡ g mod P) on its own staggered telemetry view, with no sends
shared within the tick, and one control loop reads the fleet's
consensus view.

The tick loop is a Python loop with the tick clock as a Python int, so
the fast and slow cadences are host ``if``s.  Nothing inside a tick
reads a device value back to the host: knobs stay 0-d device tensors.
Work that does not depend on the simulation state is hoisted out of the
loop, as the reference engine hoists it out of its scan
(``_scan_inputs``): the feasible sets of the whole horizon, and every
random draw -- the per-tick key chain is walked once on the host and the
per-wave draws for all ticks are made in a few batched threefry calls,
bit-for-bit the reference's.

Faults (``SimConfig.faults``, :mod:`repro_torch.core.faults`) compile on
the host into per-tick schedules, uploaded once per run.  The storm
overlay and the member-aware feasible sets (one gather per membership
epoch) join the hoisted work; in the tick, ground-truth membership and
brownouts scale the service rate, the detected row feeds the
controller's availability signal and the survivors-only imbalance, and
on each epoch flip -- a host-known tick -- the stages drop the keys
whose owner moved before anything is served.  Every fault hook is gated
on a host flag of the compiled schedule, so a run without faults, or
with a benign one, takes the fault-free engine's operations.

``simulate`` runs one config and returns a :class:`SimResult` with the
paper metrics.  ``run_ticks(..., metrics="summary")`` folds each tick
into O(m) accumulators on the device instead of stacking (T, m)
timelines (:class:`SummaryAcc`, :class:`KnobTrace`); :func:`summarize`
folds a full result the same way, and ``repro_torch.core.sweep`` runs
grids of cells in either mode.  The engine runs on the CUDA device
unless the caller passes ``device="cpu"``.

``SimConfig(unroll_waves=True)`` selects the reference's pre-scan
engine: no feasible set and no policy draw is hoisted out of the tick;
each wave gathers its own feasible set (member-aware on the tick's
detected row under a membership fault), takes its key ``fold_in(r_route,
g)`` and its draws (made for the tick's waves at its start) and routes
through ``Policy.route``, so midas, power_of_d and chbl launch
``route_select`` once a wave and never ``route_tick``.  It gives the
hoisted engine's results bit for bit, and is E10's "before" engine.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core import controllers as ctrl_lib
from repro_torch.core import faults as faults_lib
from repro_torch.core import fleet as fleet_lib
from repro_torch.core import hashring, prng, telemetry
from repro_torch.core import middleware as mw_lib
from repro_torch.core import policies as policy_lib
from repro_torch.core import registry as registry_lib
from repro_torch.core.controllers.base import Knobs, Signals
from repro_torch.core.policies.base import (
    RouteContext,
    RouteStats,
    TickRoute,
    slice_draws,
)
from repro_torch.core.workloads import Workload, make_workload
from repro_torch.core.xla import reduce_sum
from repro_torch.kernels import common as kernels_common
from repro_torch.obs import trace as obs_trace

CONSENSUS_REDUCERS = telemetry.CONSENSUS_REDUCERS
METRICS_MODES = ("full", "summary")


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP §1 item {item})"
    )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    m: int = 8  # metadata servers
    P: int = 8  # independent proxies (fleet size)
    N: int = 4096  # namespace size (keys)
    dt_ms: float = 50.0
    service_ms: float = 100.0  # paper: constant 100 ms per RPC
    policy: str = "midas"  # any name in policies.available()
    d_max: int = 4
    V: int = 64  # virtual nodes per server
    rtt_ms: float = 2.0
    n_groups: int = 8  # routing waves per tick
    middleware: Tuple[str, ...] = ()  # pipeline stages, applied in order
    cache_enabled: bool = False  # legacy alias for middleware=("cache",)
    cache_mode: str = "lease"  # lease | ttl_aggregate | ttl_per_key
    lease_ms: float = 5000.0
    p_star: float = 1e-4
    # fleet knobs (core/fleet.py): gossip propagation delay for the
    # "fleet_cache" stage, and per-proxy routing (one wave per proxy, own
    # staggered telemetry view, no within-tick sharing across proxies --
    # replaces the n_groups waves when enabled)
    gossip_ms: float = 0.0
    fleet_routing: bool = False
    fixed_d: int = 2  # d for power_of_d policy
    controller: str = "hysteresis"
    consensus: str = "mean"  # mean | median | max (fleet view reducer)
    ablate: str = ""  # comma-joined subset of controllers.ABLATIONS
    guard: bool = False  # oscillation guard (controllers.guard)
    # fault injection (repro_torch.core.faults): a tuple of registered
    # fault names, FaultEvent or CascadeEvent; None and () are the
    # untouched fault-free engine
    faults: Optional[Tuple] = None
    # the pre-scan engine: per-wave gathers and draws in the tick, each
    # wave through Policy.route (the hoisted engine's oracle; E10)
    unroll_waves: bool = False
    # wave-routing implementation: "auto" is the CUDA kernel on the card
    # and the plain version on the CPU; "ref" pins the plain version;
    # "cuda" forces the kernel -- bit-for-bit with "ref" by contract
    route_impl: str = "auto"
    seed: int = 0

    def __post_init__(self):
        """Eager validation: bad names and sizes fail at construction
        with the alternatives spelled out."""
        for name in ("m", "P", "N", "V", "n_groups", "d_max", "fixed_d"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                raise ValueError(
                    f"SimConfig.{name} must be a positive int, got {v!r}"
                )
        policy_lib.get_class(self.policy)
        for stage in self.middleware:
            registry_lib.validate_choice(
                stage, "middleware stage", mw_lib.available()
            )
        ctrl_lib.get_class(self.controller)
        registry_lib.validate_choice(
            self.consensus, "consensus reducer", CONSENSUS_REDUCERS
        )
        ctrl_lib.parse_ablations(self.ablate)  # raises on unknown tokens
        if not isinstance(self.guard, bool):
            raise ValueError(
                f"SimConfig.guard must be a bool, got {self.guard!r}"
            )
        registry_lib.validate_choice(
            self.cache_mode, "cache_mode", cache_lib.MODES
        )
        registry_lib.validate_choice(
            self.route_impl, "route_impl", kernels_common.IMPLS
        )
        if self.gossip_ms < 0:
            raise ValueError(
                f"SimConfig.gossip_ms must be >= 0, got {self.gossip_ms!r}"
            )
        if self.faults is not None:
            if not isinstance(self.faults, (tuple, list)):
                raise ValueError(
                    f"SimConfig.faults must be a tuple of fault names "
                    f"or FaultEvent, got {self.faults!r}"
                )
            # canonical and hashable: names become default events, lists
            # tuples (the fault compiler caches on the config)
            object.__setattr__(
                self, "faults", faults_lib.normalize(self.faults)
            )
            faults_lib.validate_events(self.faults, m=self.m, P=self.P)

    @property
    def fault_events(self) -> Tuple:
        """Canonical tuple of fault events (empty when faults is None)."""
        return faults_lib.normalize(self.faults)

    @property
    def t_fast_ticks(self) -> int:
        return max(int(round(ctrl_lib.T_FAST_MS / self.dt_ms)), 1)

    @property
    def t_slow_ticks(self) -> int:
        return max(int(round(ctrl_lib.T_SLOW_MS / self.dt_ms)), 1)

    @property
    def w_ticks(self) -> int:
        return max(int(round(ctrl_lib.W_WINDOW_MS / self.dt_ms)), 1)

    @property
    def serve_per_tick(self) -> float:
        return self.dt_ms / self.service_ms

    @property
    def middleware_chain(self) -> Tuple[str, ...]:
        """Resolved pipeline: the legacy cache flag prepends the cache."""
        chain = tuple(self.middleware)
        if self.cache_enabled and "cache" not in chain:
            chain = ("cache",) + chain
        return chain


class SimState(NamedTuple):
    L: torch.Tensor  # (m,) float32 queue length
    L_hat: torch.Tensor  # (m,) float32 EWMA of observed L
    L_hat_p: torch.Tensor  # (P, m) float32 per-proxy views (fleet)
    p50_hat: torch.Tensor  # (m,) float32 EWMA p50 (ms)
    p99_hat: torch.Tensor  # (m,) float32 EWMA p99 (ms)
    sketch: telemetry.LatencySketch
    policy: tuple  # policy-owned state (see policies.base)
    ctrl: ctrl_lib.ControlState  # knobs + targets + controller inner
    mw: tuple  # per-stage middleware states, chain order
    win_writes: torch.Tensor  # () float32 writes this T_slow window
    win_events: torch.Tensor  # () float32 valid requests this window
    rng: torch.Tensor  # (2,) int64 threefry key


class TickOut(NamedTuple):
    L: torch.Tensor  # (m,) queue snapshot after tick
    arrivals: torch.Tensor  # (m,) arrivals routed this tick
    lat_pred: torch.Tensor  # (m,) predicted latency of a new arrival (ms)
    d: torch.Tensor  # () int32 control knob
    delta_l: torch.Tensor  # ()
    f_max: torch.Tensor  # () steering-bucket cap this tick
    pressure: torch.Tensor  # ()
    steered: torch.Tensor  # ()
    eligible: torch.Tensor  # ()
    cache_hits: torch.Tensor  # () requests absorbed by the pipeline
    dV: torch.Tensor  # () potential change from steering this tick


class SimResult(NamedTuple):
    queue_timeline: np.ndarray  # (T, m)
    arrivals: np.ndarray  # (T, m)
    lat_pred: np.ndarray  # (T, m)
    d_timeline: np.ndarray  # (T,)
    delta_l_timeline: np.ndarray
    pressure: np.ndarray  # (T,)
    steered: np.ndarray  # (T,)
    eligible: np.ndarray  # (T,)
    cache_hits: np.ndarray  # (T,)
    final_cache: Optional[object]  # CacheState / FleetState on the device
    config: SimConfig
    f_max_timeline: Optional[np.ndarray] = None  # (T,) bucket cap

    # ---- paper metrics -------------------------------------------------
    def mean_queue(self) -> float:
        return float(self.queue_timeline.mean())

    def max_queue(self) -> float:
        return float(self.queue_timeline.max())

    def worst_case_queue(self, q: float = 99.9) -> float:
        return float(np.percentile(self.queue_timeline, q))

    def dispersion(self) -> float:
        """CV of per-server time-averaged queue length (paper §VI-C)."""
        per_server = self.queue_timeline.mean(axis=0)
        mu = per_server.mean()
        if mu < 1e-9:
            return 0.0
        return float(per_server.std() / mu)

    def dispersion_t(self) -> float:
        """Time-average of instantaneous CV across servers."""
        mu = self.queue_timeline.mean(axis=1)
        sd = self.queue_timeline.std(axis=1)
        ok = mu > 1e-9
        if not ok.any():
            return 0.0
        return float((sd[ok] / mu[ok]).mean())

    def latency_quantiles(self, qs=(50, 99)) -> Tuple[float, ...]:
        """Arrival-weighted request latency quantiles (ms)."""
        return telemetry.weighted_quantiles(self.lat_pred, self.arrivals, qs)


# ---------------------------------------------------------------------------
# Streaming summary metrics (metrics="summary")
# ---------------------------------------------------------------------------


class KnobTrace(NamedTuple):
    """The per-tick control-plane scalars a summary run keeps: O(T) in
    all, so knob trajectories survive ``metrics="summary"`` though the
    (T, m) queue timelines do not.  ``q_mean`` (the across-server mean
    queue a tick) is the series ``repro_torch.obs.windows`` detects the
    steady state on, in both metrics modes."""

    d: torch.Tensor  # (T,) int32
    delta_l: torch.Tensor  # (T,) float32
    f_max: torch.Tensor  # (T,) float32
    pressure: torch.Tensor  # (T,) float32
    q_mean: torch.Tensor  # (T,) float32 across-server mean queue


class SummaryAcc(NamedTuple):
    """O(m) accumulators a summary run carries through the tick loop in
    place of the stacked (T, m) ``TickOut`` timeline."""

    n_ticks: torch.Tensor  # () int32
    queue_sum: torch.Tensor  # (m,) per-server queue-length sums
    queue_max: torch.Tensor  # ()
    cv_sum: torch.Tensor  # () sum of instantaneous CV over ok ticks
    cv_count: torch.Tensor  # () number of ok ticks
    queue_hist: telemetry.HistSketch  # all (t, server) queue samples
    lat_hist: telemetry.HistSketch  # lat_pred weighted by arrivals
    arrivals: torch.Tensor  # ()
    steered: torch.Tensor  # ()
    eligible: torch.Tensor  # ()
    cache_hits: torch.Tensor  # ()


def _summary_init(m: int, device) -> SummaryAcc:
    f32 = dict(dtype=torch.float32, device=device)
    return SummaryAcc(
        n_ticks=torch.zeros((), dtype=torch.int32, device=device),
        queue_sum=torch.zeros((m,), **f32),
        queue_max=torch.zeros((), **f32),
        cv_sum=torch.zeros((), **f32),
        cv_count=torch.zeros((), **f32),
        queue_hist=telemetry.make_hist(device),
        lat_hist=telemetry.make_hist(device),
        arrivals=torch.zeros((), **f32),
        steered=torch.zeros((), **f32),
        eligible=torch.zeros((), **f32),
        cache_hits=torch.zeros((), **f32),
    )


def _queue_mean(L: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(L)`` as XLA computes it on the CPU: the sum in its
    order times the float32 reciprocal of m."""
    return reduce_sum(L) * float(np.float32(1.0 / L.shape[0]))


def _summary_update(
    acc: SummaryAcc, out: TickOut, mu: Optional[torch.Tensor] = None
) -> SummaryAcc:
    """Fold one tick into the accumulators (``mu``: the tick's
    :func:`_queue_mean`, when the caller has it).

    The instantaneous CV is ``std(L) / mean(L)`` rounded as the
    reference's jitted update (read off its optimized HLO): the squared
    deviations from the rounded mean summed in :func:`xla.reduce_sum`'s
    order (folded into the adds up to m = 32, rounded first above),
    times 1/m, a correctly rounded square root (float64, rounded once)
    and a true division; no FMA joins the mean, as no ε is added.  The
    other sums are of integer counts, exact in any order."""
    L = out.L
    inv = float(np.float32(1.0 / L.shape[0]))
    if mu is None:
        mu = _queue_mean(L)
    ok = mu > float(np.float32(1e-9))
    var = reduce_sum(L - mu, squares=True) * inv
    sd = torch.sqrt(var.double()).float()
    cv = torch.where(ok, sd / torch.where(ok, mu, 1.0), 0.0)
    return SummaryAcc(
        n_ticks=acc.n_ticks + 1,
        queue_sum=acc.queue_sum + L,
        queue_max=torch.maximum(acc.queue_max, L.max()),
        cv_sum=acc.cv_sum + cv,
        cv_count=acc.cv_count + ok.float(),
        queue_hist=telemetry.hist_add(acc.queue_hist, L, torch.ones_like(L)),
        lat_hist=telemetry.hist_add(acc.lat_hist, out.lat_pred,
                                    out.arrivals),
        arrivals=acc.arrivals + out.arrivals.sum(),
        steered=acc.steered + out.steered,
        eligible=acc.eligible + out.eligible,
        cache_hits=acc.cache_hits + out.cache_hits,
    )


@dataclasses.dataclass(frozen=True)
class SummaryResult:
    """Streaming summary of one (policy, workload, seed) run.

    The same paper-metric API as :class:`SimResult`, so callers need
    not know the metrics mode.  Mean, max and dispersion are exact up to
    the float32 sums; worst-case and latency quantiles come from
    :class:`telemetry.HistSketch` (bin resolution).  A summary row equals
    :func:`summarize` of the same run's full row bit for bit."""

    n_ticks: int
    queue_sum: np.ndarray  # (m,)
    queue_max_v: float
    cv_sum: float
    cv_count: float
    queue_hist: np.ndarray  # (HIST_BINS + 2,)
    lat_hist: np.ndarray  # (HIST_BINS + 2,)
    arrivals_total: float
    steered_total: float
    eligible_total: float
    cache_hits_total: float
    config: SimConfig
    # control-plane trajectories (KnobTrace): O(T) scalars per run
    d_timeline: Optional[np.ndarray] = None  # (T,)
    delta_l_timeline: Optional[np.ndarray] = None  # (T,)
    f_max_timeline: Optional[np.ndarray] = None  # (T,)
    pressure: Optional[np.ndarray] = None  # (T,)
    q_mean_timeline: Optional[np.ndarray] = None  # (T,) mean queue

    # ---- paper metrics (SimResult-compatible) --------------------------
    def mean_queue(self) -> float:
        n = max(self.n_ticks * self.queue_sum.shape[0], 1)
        return float(self.queue_sum.sum() / n)

    def max_queue(self) -> float:
        return float(self.queue_max_v)

    def worst_case_queue(self, q: float = 99.9) -> float:
        return telemetry.hist_quantile(self.queue_hist, q)

    def dispersion(self) -> float:
        """CV of per-server time-averaged queue length (paper §VI-C)."""
        per_server = self.queue_sum / max(self.n_ticks, 1)
        mu = per_server.mean()
        if mu < 1e-9:
            return 0.0
        return float(per_server.std() / mu)

    def dispersion_t(self) -> float:
        """Time-average of instantaneous CV across servers."""
        if self.cv_count <= 0:
            return 0.0
        return float(self.cv_sum / self.cv_count)

    def latency_quantiles(self, qs=(50, 99)) -> Tuple[float, ...]:
        """Arrival-weighted latency quantiles (ms), sketch resolution."""
        return tuple(telemetry.hist_quantile(self.lat_hist, q) for q in qs)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _to_summary(
    cfg: SimConfig, acc: SummaryAcc, trace: Optional[KnobTrace] = None
) -> SummaryResult:
    """Host-side SummaryResult from a SummaryAcc (and its KnobTrace)."""
    return SummaryResult(
        n_ticks=int(acc.n_ticks),
        queue_sum=_host(acc.queue_sum),
        queue_max_v=float(acc.queue_max),
        cv_sum=float(acc.cv_sum),
        cv_count=float(acc.cv_count),
        queue_hist=_host(acc.queue_hist.counts),
        lat_hist=_host(acc.lat_hist.counts),
        arrivals_total=float(acc.arrivals),
        steered_total=float(acc.steered),
        eligible_total=float(acc.eligible),
        cache_hits_total=float(acc.cache_hits),
        config=cfg,
        d_timeline=None if trace is None else _host(trace.d),
        delta_l_timeline=None if trace is None else _host(trace.delta_l),
        f_max_timeline=None if trace is None else _host(trace.f_max),
        pressure=None if trace is None else _host(trace.pressure),
        q_mean_timeline=None if trace is None else _host(trace.q_mean),
    )


def _reduce_ticks(m: int, outs: TickOut) -> SummaryAcc:
    """Fold a stacked (T, ...) TickOut through the summary accumulators,
    tick by tick: the updates a summary run makes in its loop."""
    acc = _summary_init(m, outs.L.device)
    for t in range(outs.L.shape[0]):
        acc = _summary_update(acc, TickOut(*(x[t] for x in outs)))
    return acc


def summarize(result: SimResult, device=None) -> SummaryResult:
    """Reduce a full-timeline result through the same accumulators as
    ``metrics="summary"``, on ``device`` (the card when None): a summary
    row equals ``summarize`` of the same run's full row bit for bit."""
    dev = kernels_common.resolve_device(device)
    T, m = result.queue_timeline.shape

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    zeros = torch.zeros((T,), dtype=torch.float32, device=dev)
    outs = TickOut(
        L=f32(result.queue_timeline),
        arrivals=f32(result.arrivals),
        lat_pred=f32(result.lat_pred),
        d=torch.zeros((T,), dtype=torch.int32, device=dev),
        delta_l=zeros,
        f_max=zeros,
        pressure=zeros,
        steered=f32(result.steered),
        eligible=f32(result.eligible),
        cache_hits=f32(result.cache_hits),
        dV=zeros,
    )
    f_max_tl = (
        np.zeros_like(np.asarray(result.d_timeline, np.float32))
        if result.f_max_timeline is None
        else np.asarray(result.f_max_timeline)
    )
    trace = KnobTrace(
        d=np.asarray(result.d_timeline),
        delta_l=np.asarray(result.delta_l_timeline),
        f_max=f_max_tl,
        pressure=np.asarray(result.pressure),
        # the same mean as a summary run's loop: bit for bit
        q_mean=torch.stack([_queue_mean(L) for L in outs.L]),
    )
    return _to_summary(result.config, _reduce_ticks(m, outs), trace)


# ---------------------------------------------------------------------------
# The tick: middleware pipeline -> wave routing -> dynamics
# ---------------------------------------------------------------------------


def _middlewares(cfg: SimConfig) -> Tuple[mw_lib.Middleware, ...]:
    return tuple(mw_lib.get(name) for name in cfg.middleware_chain)


def _controller(cfg: SimConfig) -> ctrl_lib.Controller:
    ctrl = ctrl_lib.wrap_ablations(ctrl_lib.get(cfg.controller), cfg.ablate)
    return ctrl_lib.wrap_guard(ctrl, cfg.guard)


def _wave_split(cfg: SimConfig, x: torch.Tensor) -> torch.Tensor:
    """Reshape a (..., R) batch into (..., G, R/G) routing waves, padding
    R to a multiple of G with zeros (False).

    Legacy: G = n_groups contiguous waves.  Fleet: one wave per proxy --
    wave g holds slots r ≡ g (mod P), served by proxy (g + tick) % P to
    match ``fleet.proxy_assign``."""
    R = x.shape[-1]
    G = cfg.P if cfg.fleet_routing else cfg.n_groups
    pad = (-R) % G
    if pad:
        z = torch.zeros(x.shape[:-1] + (pad,), dtype=x.dtype,
                        device=x.device)
        x = torch.cat([x, z], dim=-1)
    if cfg.fleet_routing:
        x = x.reshape(x.shape[:-1] + (-1, G))
        return x.transpose(-1, -2).contiguous()
    return x.reshape(x.shape[:-1] + (G, -1))


def _wave_counts(m: int, mask, assign) -> torch.Tensor:
    """(m,) routed-arrival counts of one wave (masked scatter-add)."""
    sink = torch.where(mask, assign, 0).long()
    counts = torch.zeros((m,), dtype=torch.float32, device=mask.device)
    return counts.index_put_((sink,), mask.to(torch.float32),
                             accumulate=True)


class Horizon(NamedTuple):
    """Everything a run needs that does not depend on the simulation
    state, made once before the tick loop."""

    t0: int  # tick clock of the first row
    now_ms: torch.Tensor  # (T,) float32 tick clock
    keys: torch.Tensor  # (T, R) int64
    mask: torch.Tensor  # (T, R) bool
    is_write: torch.Tensor  # (T, R) bool
    keysg: torch.Tensor  # (T, G, R/G) int64 keys per wave
    # (T, G, R/G, d_max) int32 feasible sets; None for the unrolled engine
    feasg: Optional[torch.Tensor]
    rng: torch.Tensor  # (T, 2) state key after each tick's split
    r_route: torch.Tensor  # (T, 2) each tick's routing key
    draws: Optional[tuple]  # (T, G, ...) the policy's draws (hoisted only)
    jitter: torch.Tensor  # (T,) float32 fast-loop jitter in [-1, 1)
    fc: Optional[faults_lib.CompiledFaults]  # host schedule, or None
    fx: Optional[faults_lib.FaultXs]  # its per-tick rows on the device
    flips: frozenset  # host ticks that open a membership epoch
    ring: hashring.Ring  # the consistent-hash ring the sets come from


def _scan_inputs(
    cfg: SimConfig,
    ring: hashring.Ring,
    policy: policy_lib.Policy,
    rng0: torch.Tensor,
    keys: torch.Tensor,
    mask: torch.Tensor,
    is_write: torch.Tensor,
    t0: int = 0,
    fc: Optional[faults_lib.CompiledFaults] = None,
) -> Horizon:
    """Hoist the state-independent work of a (T, R) workload grid whose
    first row is tick ``t0``.

    With a compiled fault schedule ``fc``, storm traffic is overlaid on
    the grid first (so the hoisted gathers see the storm keys), the
    feasible sets are gathered per membership epoch, and the per-tick
    fault rows are uploaded to the grid's device.

    The reference splits ``state.rng`` into (rng, r_mw, r_route) each
    tick, folds the wave index into r_route, and draws the policy's
    randomness and the fast-loop jitter from those keys (r_mw feeds
    middleware stages that draw; the cache draws nothing).  None of it
    depends on the simulation state, so the key chain is walked once
    here (Python ints, on the host) and all draws of the horizon are
    made in batched calls on the device.  The unrolled engine
    (``cfg.unroll_waves``) hoists neither the feasible sets nor the
    policy's draws: its waves make them in the tick.
    """
    T = keys.shape[0]
    dev = keys.device
    if fc is not None:
        keys, mask, is_write = faults_lib.apply_traffic(
            fc, keys, mask, is_write
        )
    k1, k2 = prng.key_ints(rng0)
    chain = []
    for _ in range(T):
        (k1, k2), r_mw, r_route = prng.split_ints(k1, k2, 3)
        chain.append(((k1, k2), r_mw, r_route))
    chain = torch.tensor(chain, dtype=torch.int64, device=dev)
    chain = chain.reshape(T, 3, 2)
    rng, _, r_route = chain.unbind(1)

    keys = keys.long()
    keysg = _wave_split(cfg, keys)
    G, Rg = keysg.shape[-2:]
    ticks = torch.arange(t0, t0 + T, dtype=torch.float32, device=dev)
    if cfg.unroll_waves:
        feasg = draws = None
    else:
        waves = prng.fold_in(
            r_route[:, None, :], torch.arange(G, device=dev)
        )  # (T, G, 2)
        draws = policy.wave_draws(waves, cfg, Rg)
        if fc is None:
            feasg = hashring.feasible_set(ring, keysg, cfg.d_max)
        else:
            feasg = faults_lib.feasible_by_epoch(ring, keysg, cfg.d_max,
                                                 fc)
    return Horizon(
        t0=t0,
        now_ms=ticks * cfg.dt_ms,
        keys=keys,
        mask=mask,
        is_write=is_write,
        keysg=keysg,
        feasg=feasg,
        rng=rng,
        r_route=r_route,
        draws=draws,
        jitter=prng.uniform(prng.fold_in(rng, 3), (), -1.0, 1.0),
        fc=fc,
        fx=None if fc is None else faults_lib.make_xs(fc, dev),
        flips=frozenset(()) if fc is None or not fc.has_remap
        else frozenset(int(t) for t in fc.flips),
        ring=ring,
    )


class _Consts(NamedTuple):
    """Device constants made once per run (no host copy per tick)."""

    zero: torch.Tensor  # () float32 0
    avail: torch.Tensor  # () float32 1: every server detected live
    member: torch.Tensor  # (m,) float32 1
    # (m,) float32 serve_per_tick, the service rate a fault scales
    rate: Optional[torch.Tensor] = None
    # () int32 cfg.fixed_d, power_of_d's d in a tick's route_tick launch
    fixed_d: Optional[torch.Tensor] = None


def _route_waves(
    cfg: SimConfig,
    policy: policy_lib.Policy,
    state: SimState,
    knobs: Knobs,
    now_ms: torch.Tensor,
    keysg: torch.Tensor,
    maskg: torch.Tensor,
    feasg: torch.Tensor,
    draws: Optional[tuple],
    impl: str,
    consts: _Consts,
    views: Optional[torch.Tensor] = None,
):
    """Route one tick's G waves in order; each wave sees the stale EWMA
    view plus this tick's own sends from the earlier waves, or, with
    ``views`` (fleet routing: (G, m), row g the view of the proxy
    serving wave g), its own row alone.  With the CUDA impl a policy
    that has a kernel for a whole tick (``Policy.route_tick``: midas,
    power_of_d, chbl) routes it in one launch; otherwise, and always on
    the CPU, the waves run one at a time, which is that kernel's plain
    version.  Returns (policy state, TickRoute)."""
    ps = state.policy
    if impl == "cuda":
        tick = policy.route_tick(ps, RouteContext(
            keys=keysg,
            mask=maskg,
            feas=feasg,
            L_view=state.L_hat if views is None else views,
            p50_view=state.p50_hat,
            knobs=knobs,
            now_ms=now_ms,
            draws=draws,
            m=cfg.m,
            fixed_d=consts.fixed_d,
            route_impl=impl,
        ))
        if tick is not None:
            return tick
    sent = torch.zeros_like(state.L)
    stats = RouteStats(consts.zero, consts.zero, consts.zero)
    assigns = []
    for g in range(keysg.shape[0]):
        ctx = RouteContext(
            keys=keysg[g],
            mask=maskg[g],
            feas=feasg[g],
            L_view=state.L_hat + sent if views is None else views[g],
            p50_view=state.p50_hat,
            knobs=knobs,
            now_ms=now_ms,
            draws=slice_draws(draws, g),
            m=cfg.m,
            fixed_d=cfg.fixed_d,
            route_impl=impl,
        )
        ps, assign, st = policy.route(ps, ctx)
        sent = sent + _wave_counts(cfg.m, maskg[g], assign)
        stats = stats + st
        assigns.append(assign)
    return ps, TickRoute(assign=torch.stack(assigns), arrivals=sent,
                         stats=stats)


def _route_waves_unrolled(
    cfg: SimConfig,
    policy: policy_lib.Policy,
    state: SimState,
    knobs: Knobs,
    now_ms: torch.Tensor,
    hz: Horizon,
    t: int,
    maskg: torch.Tensor,
    impl: str,
    consts: _Consts,
):
    """The reference's ``_route_waves_unrolled``: a tick's G waves one
    at a time, each gathering its own feasible set (member-aware on
    this tick's detected row under a membership fault, at the
    schedule's scan width), drawing from its own key ``fold_in(r_route,
    g)``, and routing through ``Policy.route`` on the stale EWMA view
    plus this tick's earlier sends (under fleet routing on the view of
    the proxy serving it).  Never ``route_tick``.  The G keys and their
    draws are made at the tick's start in one call each: threefry is
    elementwise, so they are the per-wave calls' bit for bit, at ~800
    ops a tick on the card instead of ~800 a wave.  Returns (policy
    state, TickRoute)."""
    keysg, tick = hz.keysg[t], hz.t0 + t
    G, Rg = keysg.shape
    member = (hz.fx.detected[t] if hz.fc is not None and hz.fc.has_remap
              else None)
    waves = prng.fold_in(hz.r_route[t][None, :],
                         torch.arange(G, device=keysg.device))  # (G, 2)
    draws = policy.wave_draws(waves, cfg, Rg)
    ps = state.policy
    sent = torch.zeros_like(state.L)
    stats = RouteStats(consts.zero, consts.zero, consts.zero)
    assigns = []
    for g in range(G):
        if member is None:
            feas = hashring.feasible_set(hz.ring, keysg[g], cfg.d_max)
        else:
            feas = hashring.feasible_set(
                hz.ring, keysg[g], cfg.d_max,
                scan_width=hz.fc.scan_width, member=member,
            )
        ctx = RouteContext(
            keys=keysg[g],
            mask=maskg[g],
            feas=feas,
            L_view=(state.L_hat_p[(g + tick) % G] if cfg.fleet_routing
                    else state.L_hat + sent),
            p50_view=state.p50_hat,
            knobs=knobs,
            now_ms=now_ms,
            draws=slice_draws(draws, g),
            m=cfg.m,
            fixed_d=cfg.fixed_d,
            route_impl=impl,
        )
        ps, assign, st = policy.route(ps, ctx)
        sent = sent + _wave_counts(cfg.m, maskg[g], assign)
        stats = stats + st
        assigns.append(assign)
    return ps, TickRoute(assign=torch.stack(assigns), arrivals=sent,
                         stats=stats)


def _signals(
    cfg: SimConfig, consts: _Consts, s: SimState, B, p99, jitter,
    hz: Horizon, t: int,
) -> Signals:
    # availability and membership: constants on the fault-free path,
    # this tick's detected row under a schedule
    if hz.fx is None:
        avail, member = consts.avail, consts.member
    else:
        avail, member = hz.fx.avail[t], hz.fx.detected[t].float()
    return Signals(
        B=B,
        p99=p99,
        L_hat=s.L_hat,
        views_p=s.L_hat_p,
        write_mix=s.win_writes / torch.clamp(s.win_events, min=1.0),
        jitter=jitter,
        rtt_ms=cfg.rtt_ms,
        avail=avail,
        member=member,
    )


def _imbalance(hz: Horizon, t: int, L_hat: torch.Tensor) -> torch.Tensor:
    """B(t); under a membership fault over the detected-live servers
    only, so a dead server's frozen queue does not pin it."""
    if hz.fc is not None and hz.fc.has_remap:
        return telemetry.imbalance_masked(L_hat, hz.fx.detected[t])
    return telemetry.imbalance(L_hat)


def _ingest(cfg, controller, consts, hz: Horizon, t: int,
            s: SimState) -> SimState:
    """Fast loop: telemetry ingest, then the controller's fast step."""
    p50_o, p99_o = telemetry.sketch_quantiles(s.sketch)
    a = ctrl_lib.ALPHA_FAST
    if cfg.fleet_routing:
        # one control loop fed by the fleet's consensus view
        L_hat = ctrl_lib.consensus_view(s.L_hat_p, cfg.consensus)
    else:
        L_hat = telemetry.ewma(s.L_hat, s.L, a)
    s = s._replace(
        L_hat=L_hat,
        p50_hat=telemetry.ewma(s.p50_hat, p50_o, a),
        p99_hat=telemetry.ewma(s.p99_hat, p99_o, a),
    )
    B = _imbalance(hz, t, s.L_hat)
    ctrl, _ = controller.fast(
        s.ctrl,
        _signals(cfg, consts, s, B, s.p99_hat.max(), hz.jitter[t], hz, t),
    )
    return s._replace(ctrl=ctrl)


def _slow(cfg, controller, mws, consts, hz: Horizon, t: int,
          s: SimState) -> SimState:
    """Slow loop: the controller's slow step and the stages' retunes;
    the write-mix window restarts."""
    B = _imbalance(hz, t, s.L_hat)
    ctrl, k = controller.slow(
        s.ctrl,
        _signals(cfg, consts, s, B, s.p99_hat.max(), consts.zero, hz, t),
    )
    return s._replace(
        ctrl=ctrl,
        mw=tuple(mw.on_slow(ms, cfg, k) for mw, ms in zip(mws, s.mw)),
        win_writes=torch.zeros_like(s.win_writes),
        win_events=torch.zeros_like(s.win_events),
    )


def _tick(
    cfg: SimConfig,
    policy: policy_lib.Policy,
    mws: Tuple[mw_lib.Middleware, ...],
    controller: ctrl_lib.Controller,
    impl: str,
    consts: _Consts,
    hz: Horizon,
    t: int,
    state: SimState,
) -> Tuple[SimState, TickOut]:
    now_ms = hz.now_ms[t]
    keys, mask, is_write = hz.keys[t], hz.mask[t], hz.is_write[t]
    # the offered batch's write mix (pre-middleware) accumulates into the
    # T_slow window that Signals.write_mix reports
    state = state._replace(
        rng=hz.rng[t],
        win_writes=state.win_writes + (is_write & mask).sum(),
        win_events=state.win_events + mask.sum(),
    )

    # --- fault context: remap invalidation BEFORE any stage serves -------
    finfo = None
    if hz.fc is not None:
        inval = None
        if t in hz.flips:
            inval = faults_lib.moved_mask(hz.fc, hz.fx, t)
        finfo = faults_lib.tick_info(hz.fc, hz.fx, t, inval)
        if inval is not None:
            state = state._replace(mw=tuple(
                mw.on_fault(ms, finfo, cfg)
                for mw, ms in zip(mws, state.mw)
            ))

    # --- middleware pipeline: stages may absorb requests at the proxy ----
    absorbed = consts.zero
    mw_states = list(state.mw)
    for i, mw in enumerate(mws):
        batch = mw_lib.BatchView(
            keys=keys,
            mask=mask,
            is_write=is_write,
            now_ms=now_ms,
            faults=finfo,
        )
        mw_states[i], mask, took = mw.on_batch(mw_states[i], batch, cfg)
        absorbed = absorbed + took
    state = state._replace(mw=tuple(mw_states))

    # --- route in waves (hoisted engine; the unrolled one on request) ---
    tick = hz.t0 + t
    knobs = controller.view(state.ctrl)
    if cfg.unroll_waves:
        ps, routed = _route_waves_unrolled(
            cfg, policy, state, knobs, now_ms, hz, t,
            _wave_split(cfg, mask), impl, consts,
        )
    else:
        # each proxy routes from its OWN staggered telemetry view
        views = (fleet_lib.wave_views(state.L_hat_p, tick)
                 if cfg.fleet_routing else None)
        ps, routed = _route_waves(
            cfg, policy, state, knobs, now_ms, hz.keysg[t],
            _wave_split(cfg, mask), hz.feasg[t], slice_draws(hz.draws, t),
            impl, consts, views,
        )
    arrivals, stats = routed.arrivals, routed.stats

    # --- queue dynamics: constant-rate servers, work-conserving ----------
    L = state.L + arrivals
    fc = hz.fc
    if fc is not None and (fc.has_brownout or fc.has_downtime):
        # ground-truth faults bite at once: browned-out servers drain
        # slower, dead ones not at all (their queue freezes until rejoin)
        rate = consts.rate
        if fc.has_brownout:
            rate = rate * hz.fx.scale[t]
        if fc.has_downtime:
            rate = rate * hz.fx.member[t].float()
        L = L - torch.minimum(L, rate)
    else:
        L = L - torch.clamp(L, max=cfg.serve_per_tick)
    lat_pred = (state.L + arrivals) * cfg.service_ms  # wait of new arrival
    state = state._replace(
        L=L, policy=ps, sketch=telemetry.sketch_add(state.sketch, lat_pred)
    )

    # --- telemetry ingest + control on the post-tick clock ---------------
    t1 = tick + 1
    if cfg.fleet_routing:
        # per-proxy views: each proxy polls on its own staggered phase
        state = state._replace(L_hat_p=telemetry.ewma_staggered(
            state.L_hat_p, L, t1, cfg.t_fast_ticks, ctrl_lib.ALPHA_FAST))
    if t1 % cfg.t_fast_ticks == 0:
        state = _ingest(cfg, controller, consts, hz, t, state)
    if t1 % cfg.t_slow_ticks == 0:
        state = _slow(cfg, controller, mws, consts, hz, t, state)

    k = state.ctrl.knobs
    out = TickOut(
        L=L,
        arrivals=arrivals,
        lat_pred=lat_pred,
        d=k.d,
        delta_l=k.delta_l,
        f_max=k.f_max,
        pressure=state.ctrl.pressure,
        steered=stats.steered,
        eligible=stats.eligible,
        cache_hits=absorbed,
        dV=stats.dV,
    )
    return state, out


def init_state(
    cfg: SimConfig,
    b_tgt: float = 0.15,
    p99_tgt: float = 500.0,
    device=None,
) -> SimState:
    dev = kernels_common.resolve_device(device)
    policy = policy_lib.get(cfg.policy)
    ring = hashring.make_ring(cfg.m, cfg.V, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return SimState(
        L=torch.zeros((cfg.m,), **f32),
        L_hat=torch.zeros((cfg.m,), **f32),
        L_hat_p=torch.zeros((cfg.P, cfg.m), **f32),
        p50_hat=torch.zeros((cfg.m,), **f32),
        p99_hat=torch.zeros((cfg.m,), **f32),
        sketch=telemetry.make_sketch(cfg.m, device=dev),
        policy=policy.init(cfg, ring, dev),
        ctrl=_controller(cfg).init(cfg, (b_tgt, p99_tgt), dev),
        mw=tuple(mw.init(cfg, dev) for mw in _middlewares(cfg)),
        win_writes=torch.zeros((), **f32),
        win_events=torch.zeros((), **f32),
        rng=prng.PRNGKey(cfg.seed, dev),
    )


def run_ticks(
    cfg: SimConfig,
    state: SimState,
    keys: torch.Tensor,
    mask: torch.Tensor,
    is_write: torch.Tensor,
    t0: int = 0,
    metrics: str = "full",
):
    """Run the (T, R) grid from ``state`` on the grid's device; returns
    the final state and, under ``metrics="full"``, the (T, ...) stacked
    per-tick outputs (a ``TickOut``), still on the device.  ``t0`` is
    the tick clock of the grid's first row, so a run can resume from the
    state another run returned.  The (N,) tables of ``state`` are
    updated in place.

    Under ``metrics="summary"`` each tick is folded into O(m)
    accumulators on the device, and the second value is the pair
    (``SummaryAcc``, ``KnobTrace``): no (T, m) timeline is stacked and
    nothing is read back to the host in the loop.

    A fault schedule is compiled over this grid from its first row, as
    the reference compiles it over its scan, so a faulted run cannot
    resume mid-schedule: ``t0`` must then be 0."""
    registry_lib.validate_choice(metrics, "metrics mode", METRICS_MODES)
    dev = keys.device
    fc = faults_lib.compile_faults(cfg, int(keys.shape[0]))
    if fc is not None and t0 != 0:
        raise ValueError(
            f"a faulted run compiles its schedule over the grid from its "
            f"first row and cannot resume at t0={t0}; run the whole "
            f"horizon from t0=0"
        )
    impl = kernels_common.resolve_impl(cfg.route_impl, dev, "route_impl")
    ring = hashring.make_ring(cfg.m, cfg.V, device=dev)
    policy = policy_lib.get(cfg.policy)
    mws = _middlewares(cfg)
    controller = _controller(cfg)
    hz = _scan_inputs(
        cfg, ring, policy, state.rng, keys, mask, is_write, t0, fc
    )
    consts = _Consts(
        zero=torch.zeros((), dtype=torch.float32, device=dev),
        avail=torch.ones((), dtype=torch.float32, device=dev),
        member=torch.ones((cfg.m,), dtype=torch.float32, device=dev),
        rate=torch.full((cfg.m,), cfg.serve_per_tick, dtype=torch.float32,
                        device=dev),
        fixed_d=torch.full((), cfg.fixed_d, dtype=torch.int32, device=dev),
    )
    if keys.shape[0] == 0:
        raise ValueError("the workload grid has no ticks")
    acc = _summary_init(cfg.m, dev) if metrics == "summary" else None
    rows: List[tuple] = []  # TickOuts, or the summary's knob scalars
    for t in range(keys.shape[0]):
        state, out = _tick(
            cfg, policy, mws, controller, impl, consts, hz, t, state
        )
        if acc is None:
            rows.append(out)
        else:
            mu = _queue_mean(out.L)
            acc = _summary_update(acc, out, mu)
            rows.append((out.d, out.delta_l, out.f_max, out.pressure, mu))
    stacked = (torch.stack(f) for f in zip(*rows))
    if acc is None:
        return state, TickOut(*stacked)
    return state, (acc, KnobTrace(*stacked))


def warmup(
    cfg: SimConfig,
    T: int = 1200,
    seed: int = 99,
    device=None,
    wl: Optional[Workload] = None,
) -> Tuple[float, float]:
    """§III-B: run the ``light`` workload (≤ 40% utilization) with the
    static ``hash`` policy and no middleware, and derive the control
    targets.  ``wl`` replaces the generated ``light`` grid (the parity
    tests pass the reference's realized grid)."""
    dev = kernels_common.resolve_device(device)
    if wl is None:
        wl = make_workload(
            "light", T=T, m=cfg.m, seed=seed, dt_ms=cfg.dt_ms,
            service_ms=cfg.service_ms, N=cfg.N, device=dev,
        )
    warm_cfg = dataclasses.replace(
        cfg, policy="hash", cache_enabled=False, middleware=(), faults=None
    )
    st = init_state(warm_cfg, device=dev)
    with obs_trace.span("sim/warmup", cat="warmup", T=int(wl.keys.shape[0]),
                        m=cfg.m):
        _, outs = run_ticks(
            warm_cfg, st, wl.keys.to(dev), wl.mask.to(dev),
            wl.is_write.to(dev),
        )
        L = outs.L.cpu().numpy()
    # EWMA'd imbalance series, the same smoothing as the controller
    L_hat = telemetry.ewma_series(L, ctrl_lib.ALPHA_FAST)
    B = L_hat.std(axis=1) / (L_hat.mean(axis=1) + ctrl_lib.EPS)
    w = outs.arrivals.cpu().numpy()
    if w.sum() > 0:
        (p99_warm,) = telemetry.weighted_quantiles(
            outs.lat_pred.cpu().numpy(), w, (99,)
        )
    else:
        p99_warm = cfg.service_ms
    return ctrl_lib.warmup_targets(B, p99_warm, cfg.rtt_ms)


def _final_cache(cfg: SimConfig, final: SimState):
    """The final cache state: the shared table's CacheState for "cache",
    the FleetState (converged table + per-proxy counters) for
    "fleet_cache"."""
    chain = cfg.middleware_chain
    for name in ("cache", "fleet_cache"):
        if name in chain:
            return final.mw[chain.index(name)]
    return None


def _to_result(cfg: SimConfig, outs: TickOut, final_cache) -> SimResult:
    host = TickOut(*(x.cpu().numpy() for x in outs))
    return SimResult(
        queue_timeline=host.L,
        arrivals=host.arrivals,
        lat_pred=host.lat_pred,
        d_timeline=host.d,
        delta_l_timeline=host.delta_l,
        pressure=host.pressure,
        steered=host.steered,
        eligible=host.eligible,
        cache_hits=host.cache_hits,
        final_cache=final_cache,
        config=cfg,
        f_max_timeline=host.f_max,
    )


def _targets(cfg: SimConfig, do_warmup: bool, device) -> Tuple[float, float]:
    if do_warmup and policy_lib.get_class(cfg.policy).adaptive:
        return warmup(cfg, device=device)
    return 0.15, 5.0 * cfg.service_ms


def simulate(
    cfg: SimConfig, wl: Workload, do_warmup: bool = True, device=None
) -> SimResult:
    """Run ``wl`` under ``cfg`` on ``device`` (the CUDA device unless
    the caller passes ``device="cpu"``; without a card this raises)."""
    dev = kernels_common.resolve_device(device)
    kernels_common.resolve_impl(cfg.route_impl, dev, "route_impl")
    b_tgt, p99_tgt = _targets(cfg, do_warmup, dev)
    state = init_state(cfg, b_tgt, p99_tgt, dev)
    with obs_trace.span("sim/run", cat="execute", policy=cfg.policy,
                        controller=cfg.controller,
                        T=int(wl.keys.shape[0])):
        final, outs = run_ticks(
            cfg, state, wl.keys.to(dev), wl.mask.to(dev),
            wl.is_write.to(dev)
        )
        _synchronize(dev)
    with obs_trace.span("sim/host_result", cat="host"):
        return _to_result(cfg, outs, _final_cache(cfg, final))


def _synchronize(dev: torch.device) -> None:
    """Wait for the card, so that a span around queued work times the
    work and not its enqueue; nothing on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# per-seed rows of one (policy, workload) combination
SweepRows = Tuple[Union[SimResult, SummaryResult], ...]

# Once-per-process guard of simulate_sweep's DeprecationWarning: sweeps
# call the shim in loops, and one warning a process is enough.  Tests
# reset it to check the exactly-once contract.
_SWEEP_DEPRECATION_WARNED = [False]


def simulate_sweep(
    cfg: SimConfig,
    wl: Union[Workload, Sequence[Workload]],
    policies: Optional[Tuple[str, ...]] = None,
    seeds: Tuple[int, ...] = (0,),
    do_warmup: bool = True,
    metrics: str = "full",
    targets: Optional[Tuple[float, float]] = None,
    device=None,
) -> Union[Dict[str, SweepRows], Dict[str, Dict[str, SweepRows]]]:
    """Run ``policies × workloads × seeds`` and return the legacy shapes:
    ``{policy: (row per seed, ...)}`` for a single workload and
    ``{policy: {workload_name: (row per seed, ...)}}`` for a sequence.

    .. deprecated::
        A shim over the declarative API: build a
        :class:`repro_torch.core.sweep.SweepSpec` and call
        :func:`repro_torch.core.sweep.run_sweep`, which adds the
        controller axis and a coordinate-addressable result.
    """
    if not _SWEEP_DEPRECATION_WARNED[0]:
        _SWEEP_DEPRECATION_WARNED[0] = True
        warnings.warn(
            "simulate_sweep is deprecated; build a repro_torch.core.sweep."
            "SweepSpec and call run_sweep",
            DeprecationWarning,
            stacklevel=2,
        )
    from repro_torch.core import sweep as sweep_lib

    single = isinstance(wl, Workload)
    spec = sweep_lib.SweepSpec(
        config=cfg,
        workloads=wl,
        policies=tuple(policies) if policies is not None else None,
        seeds=tuple(seeds),
        metrics=metrics,
        do_warmup=do_warmup,
        targets=targets,
    )
    return sweep_lib.run_sweep(spec, device=device).to_legacy(single=single)
