"""Fault-event schema, registry, and the host-side schedule compiler.

A *fault* is a typed, registered event (``proxy_crash``,
``server_brownout``, ``gossip_partition``, ...) injected into a run via
``SimConfig(faults=(...,))``.  The whole fault program is compiled here,
on the host, into dense time-indexed numpy schedules (ground-truth
membership, service-rate scale, gossip partitions, storm intensity).
The engine uploads the per-tick rows to the run's device once
(:func:`make_xs`) and slices them by the host tick index, so no tick
reads a device value back.

Two planes.  ``member`` is ground truth: a crashed server serves zero
requests at once.  ``detected`` is what the proxies believe: a server
is presumed alive until it has been silent for ``DETECT_TIMEOUT_MS``
(the windowed-heartbeat rule of a failure detector with injected
clocks).  Routing, feasible sets, remap invalidation and the
controller's availability signal follow ``detected``.

Membership epochs.  Consecutive runs of identical ``detected`` rows form
epochs.  The per-key primary owner per epoch (``owner_by_epoch``, numpy)
gives the remap-invalidation mask on an epoch flip: exactly the keys
whose owner changed are dropped from every cache view.  The flips are
host-known (``epoch`` is numpy), so the engine clears caches on those
ticks alone.

Zero cost when off.  ``compile_faults`` returns ``None`` for an absent
or empty schedule, and every hook in the engine is gated on the host
``has_*`` flags of the compiled schedule, so a benign (never-firing)
schedule runs the fault-free engine's operations on equal values.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core import hashring
from repro_torch.core import registry as registry_lib

# Detection timeout: a member silent for longer is presumed FAILED.
DETECT_TIMEOUT_MS = 500.0
# Signals.avail below this means "detected membership degraded": the
# cache install guard and availability-aware controllers key off it.
AVAIL_FULL = 1.0 - 1e-6
# Writer lanes a fleet-scale checkpoint storm hammers.
STORM_LANES = 16


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault occurrence (hashable: rides ``SimConfig``).

    ``t0``/``duration`` are in ticks; ``duration <= 0`` means "until the
    end of the horizon".  ``target`` selects a server (or proxy, for
    ``gossip_partition``); ``-1`` picks each kind's documented default.
    ``magnitude`` is the kind-specific intensity in (0, 1].
    """

    kind: str
    t0: int = 100
    duration: int = 200
    target: int = -1
    magnitude: float = 0.5


class Schedule:
    """Mutable host-side schedule the registered specs write into."""

    def __init__(self, T: int, m: int, P: int):
        self.T, self.m, self.P = T, m, P
        self.member = np.ones((T, m), bool)
        self.service_scale = np.ones((T, m), np.float32)
        self.partition = np.zeros((T, P), bool)
        self.storm = np.zeros((T,), np.float32)
        self.active = np.zeros((T,), bool)

    def window(self, ev: FaultEvent) -> Tuple[int, int]:
        """[t0, t1) clipped to the horizon; open-ended when duration<=0."""
        t0 = max(int(ev.t0), 0)
        t1 = self.T if ev.duration <= 0 else min(t0 + int(ev.duration),
                                                 self.T)
        return min(t0, self.T), max(min(t0, self.T), t1)


class FaultSpec:
    """Base class for registered fault kinds.

    ``validate(ev, m, P)`` raises ``ValueError`` on a bad event at
    ``SimConfig`` construction time; ``apply(ev, sched)`` writes the
    event's effect into the host-side :class:`Schedule`.
    """

    kind: str = "?"

    def validate(self, ev: FaultEvent, m: int, P: int) -> None:
        pass

    def apply(self, ev: FaultEvent, sched: Schedule) -> None:
        raise NotImplementedError


REGISTRY = registry_lib.Registry("fault", name_attr="kind")


def register(kind: str):
    """Class decorator: ``@faults.register("my_fault")`` adds a
    FaultSpec subclass under ``kind`` (``SimConfig(faults=(kind,))``)."""
    return REGISTRY.register(kind)


def unregister(kind: str) -> None:
    """Remove a registered fault kind (for tests and plugins)."""
    REGISTRY.unregister(kind)


def available() -> Tuple[str, ...]:
    """Sorted names of every registered fault kind."""
    return REGISTRY.available()


def get_class(kind: str) -> Type[FaultSpec]:
    return REGISTRY.get_class(kind)


def get(kind: str) -> FaultSpec:
    """Instantiate the spec registered under ``kind``."""
    return REGISTRY.get(kind)


def normalize(faults) -> Tuple[Any, ...]:
    """Canonical event tuple: names become default-parameter events.

    Cascade entries (:class:`programs.CascadeEvent`) pass through: they
    stay unresolved until the compiler knows ``dt_ms`` and the horizon.
    """
    if not faults:
        return ()
    from repro_torch.core.faults import programs  # programs imports base

    out = []
    for f in faults:
        if isinstance(f, str):
            f = FaultEvent(kind=f)
        elif not isinstance(f, (FaultEvent, programs.CascadeEvent)):
            raise ValueError(
                f"SimConfig.faults entries must be fault names, "
                f"FaultEvent, or CascadeEvent, got {f!r}"
            )
        out.append(f)
    return tuple(out)


def _validate_one(ev: FaultEvent, m: int, P: int) -> None:
    get_class(ev.kind)  # raises with alternatives on unknown kind
    if ev.t0 < 0:
        raise ValueError(f"fault t0 must be >= 0, got {ev!r}")
    get(ev.kind).validate(ev, m, P)


def validate_events(faults, m: int, P: int) -> None:
    """Eager list-alternatives validation (SimConfig.__post_init__)."""
    from repro_torch.core.faults import programs  # programs imports base

    for ev in normalize(faults):
        if isinstance(ev, programs.CascadeEvent):
            if ev.offset < 0:
                raise ValueError(f"cascade offset must be >= 0, got {ev!r}")
            _validate_one(ev.trigger, m, P)
            # the effect's t0 is a placeholder resolve() overwrites, so
            # only its kind-specific parameters are checked here
            get_class(ev.effect.kind)
            get(ev.effect.kind).validate(ev.effect, m, P)
        else:
            _validate_one(ev, m, P)


def parse_fault(spec: str) -> FaultEvent:
    """Parse ``"kind"`` or ``"kind:t0=200,duration=300,..."`` (CLI)."""
    spec = spec.strip()
    kind, _, rest = spec.partition(":")
    if kind not in REGISTRY:
        raise ValueError(
            f"unknown fault {kind!r}; available: {', '.join(available())}"
        )
    kw: Dict[str, Any] = {}
    fields = {f.name for f in dataclasses.fields(FaultEvent)}
    for tok in filter(None, (t.strip() for t in rest.split(","))):
        k, sep, v = tok.partition("=")
        if not sep or k not in fields or k == "kind":
            raise ValueError(
                f"bad fault parameter {tok!r} in {spec!r}; expected "
                f"key=value with key in t0, duration, target, magnitude"
            )
        kw[k] = float(v) if k == "magnitude" else int(v)
    return FaultEvent(kind=kind, **kw)


# ---------------------------------------------------------------------------
# Detection, epochs, and the compiled schedule
# ---------------------------------------------------------------------------


def detect_ticks(dt_ms: float) -> int:
    """Detection timeout in whole ticks (>= 1)."""
    return max(int(math.ceil(DETECT_TIMEOUT_MS / dt_ms)), 1)


def detect_available(member: np.ndarray, timeout_ticks: int) -> np.ndarray:
    """(T, m) detected-alive mask from ground-truth membership.

    A member is detected alive at tick t iff it heartbeat within the
    last ``timeout_ticks`` ticks (inclusive window [t-K, t]), with every
    member presumed alive before t=0.
    """
    member = np.asarray(member, bool)
    T, m = member.shape
    ext = np.concatenate([np.ones((timeout_ticks, m), bool), member])
    det = np.zeros((T, m), bool)
    for j in range(timeout_ticks + 1):
        det |= ext[j:j + T]
    return det


def _epochs(detected: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse (T, m) detected rows into (epoch_masks, epoch_index)."""
    T = detected.shape[0]
    masks = [detected[0]]
    idx = np.zeros((T,), np.int32)
    for t in range(1, T):
        if not np.array_equal(detected[t], masks[-1]):
            masks.append(detected[t])
        idx[t] = len(masks) - 1
    return np.stack(masks), idx


def _scan_width(m: int, V: int, masks: np.ndarray) -> int:
    """Feasible-set window wide enough to find d_max live owners: the
    default 16 slots, stretched by the worst epoch's dead fraction."""
    min_live = max(min(int(mk.sum()) for mk in masks), 1)
    return int(min(max(16, math.ceil(16 * m / min_live)), m * V))


class CompiledFaults(NamedTuple):
    """Host-compiled fault program for one (config, horizon) pair.

    Every array is numpy; the ``has_*`` flags are Python bools that gate
    the engine's fault hooks, so inert schedules cost nothing.
    """

    member: np.ndarray          # (T, m) bool ground-truth membership
    service_scale: np.ndarray   # (T, m) f32 service-rate multiplier
    partition: np.ndarray       # (T, P) bool gossip-partitioned proxies
    storm: np.ndarray           # (T,) f32 storm intensity in [0, 1]
    detected: np.ndarray        # (T, m) bool detected membership
    avail: np.ndarray           # (T,) f32 detected live fraction
    epoch: np.ndarray           # (T,) i32 membership epoch index
    epoch_prev: np.ndarray      # (T,) i32 previous tick's epoch
    epoch_masks: np.ndarray     # (E, m) bool detected mask per epoch
    owner_by_epoch: Optional[np.ndarray]  # (E, N) i32 primary per epoch
    active: np.ndarray          # (T,) bool any event window active
    timeout_ticks: int          # detection window K
    scan_width: int             # member-aware feasible-set window
    has_downtime: bool          # any ground-truth dead tick
    has_remap: bool             # >1 detected-membership epoch
    has_brownout: bool          # any service_scale != 1
    has_partition: bool         # any partitioned (proxy, tick)
    has_storm: bool             # any storm intensity > 0

    @property
    def flips(self) -> np.ndarray:
        """Ticks whose epoch differs from the previous tick's."""
        return np.flatnonzero(self.epoch != self.epoch_prev)


class FaultXs(NamedTuple):
    """Per-tick fault rows on the run's device (leading T axis)."""

    member: torch.Tensor     # (T, m) bool
    scale: torch.Tensor      # (T, m) f32
    detected: torch.Tensor   # (T, m) bool
    avail: torch.Tensor      # (T,) f32
    partition: torch.Tensor  # (T, P) bool
    epoch: torch.Tensor      # (T,) i32
    epoch_prev: torch.Tensor  # (T,) i32
    owners: Optional[torch.Tensor]  # (E, N) i32 owner_by_epoch, or None


class FaultTickInfo(NamedTuple):
    """One tick's fault context, handed to middleware via BatchView."""

    member: torch.Tensor     # (m,) bool ground truth
    detected: torch.Tensor   # (m,) bool detected membership
    partition: torch.Tensor  # (P,) bool partitioned proxies
    avail: torch.Tensor      # () f32 detected live fraction
    inval: Optional[torch.Tensor]  # (N,) bool owner-changed keys


class _Key(NamedTuple):
    """The config fields a schedule depends on: configs that differ only
    elsewhere (the policy, the route impl, ...) share one compile."""

    faults: tuple
    dt_ms: float
    m: int
    P: int
    N: int
    V: int


def _compile(cfg: _Key, T: int) -> CompiledFaults:
    from repro_torch.core.faults import programs  # programs imports base

    # cascade entries resolve here: detection time needs dt_ms + horizon
    events = programs.resolve(
        normalize(cfg.faults), dt_ms=cfg.dt_ms, T=T, m=cfg.m, P=cfg.P
    )
    sched = Schedule(T, cfg.m, cfg.P)
    for ev in events:
        get(ev.kind).apply(ev, sched)
    K = detect_ticks(cfg.dt_ms)
    detected = detect_available(sched.member, K)
    masks, epoch = _epochs(detected)
    for mk in masks:
        if not mk.any():
            raise ValueError(
                "fault schedule leaves no detected-live server in some "
                "epoch; keep at least one member alive"
            )
    epoch_prev = np.concatenate([epoch[:1], epoch[:-1]])
    has_remap = masks.shape[0] > 1
    owner_by_epoch = None
    if has_remap:
        keys = np.arange(cfg.N)
        owner_by_epoch = np.stack([
            hashring.np_member_primary(cfg.m, cfg.V, mk, keys)
            for mk in masks
        ]).astype(np.int32)
    return CompiledFaults(
        member=sched.member,
        service_scale=sched.service_scale,
        partition=sched.partition,
        storm=sched.storm,
        detected=detected,
        avail=detected.mean(axis=1).astype(np.float32),
        epoch=epoch,
        epoch_prev=epoch_prev.astype(np.int32),
        epoch_masks=masks,
        owner_by_epoch=owner_by_epoch,
        active=sched.active,
        timeout_ticks=K,
        scan_width=_scan_width(cfg.m, cfg.V, masks),
        has_downtime=bool((~sched.member).any()),
        has_remap=has_remap,
        has_brownout=bool((sched.service_scale != 1.0).any()),
        has_partition=bool(sched.partition.any()),
        has_storm=bool((sched.storm > 0.0).any()),
    )


# a few entries: owner_by_epoch is (E, N), and at N = 10**6 a compile
# takes ~0.3 s of host time (its E subring searches)
_compile_cached = functools.lru_cache(maxsize=8)(_compile)


def compile_faults(cfg, T: int) -> Optional[CompiledFaults]:
    """The compiled fault program for ``cfg`` over a T-tick horizon, or
    ``None`` when the config carries no fault events (``faults=None``
    and ``faults=()`` are both the untouched engine)."""
    events = normalize(cfg.faults)
    if not events:
        return None
    key = _Key(events, cfg.dt_ms, cfg.m, cfg.P, cfg.N, cfg.V)
    return _compile_cached(key, int(T))


def make_xs(fc: CompiledFaults, device) -> FaultXs:
    """The per-tick rows, and the per-epoch owner table when membership
    changes, uploaded to ``device`` once per run."""

    def up(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return FaultXs(
        member=up(fc.member, torch.bool),
        scale=up(fc.service_scale, torch.float32),
        detected=up(fc.detected, torch.bool),
        avail=up(fc.avail, torch.float32),
        partition=up(fc.partition, torch.bool),
        epoch=up(fc.epoch, torch.int32),
        epoch_prev=up(fc.epoch_prev, torch.int32),
        owners=(None if fc.owner_by_epoch is None
                else up(fc.owner_by_epoch, torch.int32)),
    )


def moved_mask(fc: CompiledFaults, fx: FaultXs, t: int) -> torch.Tensor:
    """(N,) bool on the device: the keys whose epoch owner differs
    between tick ``t`` and the tick before it (all False off an epoch
    flip); ``t`` and the epochs are host values, so no device read."""
    return fx.owners[int(fc.epoch[t])] != fx.owners[int(fc.epoch_prev[t])]


def tick_info(
    fc: CompiledFaults, fx: FaultXs, t: int,
    inval: Optional[torch.Tensor] = None,
) -> FaultTickInfo:
    """Tick ``t``'s fault context: views of its rows in ``fx``, and the
    remap-invalidation mask ``inval`` (:func:`moved_mask`) where the
    caller made one."""
    return FaultTickInfo(
        member=fx.member[t],
        detected=fx.detected[t],
        partition=fx.partition[t],
        avail=fx.avail[t],
        inval=inval,
    )


def feasible_by_epoch(
    ring: hashring.Ring, keysg: torch.Tensor, d_max: int,
    fc: CompiledFaults,
) -> torch.Tensor:
    """Membership-aware feasible sets for a whole (T, ...) key grid.

    The ticks of each membership epoch are gathered with that epoch's
    live mask at the schedule's scan width, each in one batched call
    (E is small: one per membership change).  Elementwise in the keys,
    so this equals gathering the whole horizon per epoch and selecting
    each tick's epoch row, as the reference does.
    """
    if not fc.has_remap:
        return hashring.feasible_set(ring, keysg, d_max)
    dev = keysg.device
    out = torch.empty(keysg.shape + (d_max,), dtype=torch.int32,
                      device=dev)
    for e, mk in enumerate(fc.epoch_masks):
        ticks = np.flatnonzero(fc.epoch == e)
        if not ticks.size:
            continue
        idx = torch.as_tensor(ticks, device=dev)
        out[idx] = hashring.feasible_set(
            ring, keysg[idx], d_max, scan_width=fc.scan_width,
            member=torch.as_tensor(mk, device=dev),
        )
    return out


def apply_traffic(
    fc: CompiledFaults,
    keys: torch.Tensor,
    mask: torch.Tensor,
    is_write: torch.Tensor,
):
    """Overlay storm traffic on a (T, R) workload grid.

    A storm of intensity s activates the trailing s-fraction of each
    tick's inactive request slots as WRITES against the hot writer-lane
    keys (r mod STORM_LANES).  The slot test ``(R - r - 0.5) / R < s``
    depends on the schedule alone and is made in float32 on the host.
    """
    if not fc.has_storm:
        return keys, mask, is_write
    R = keys.shape[-1]
    r = np.arange(R, dtype=np.int32)
    tail_frac = (np.float32(R) - r.astype(np.float32)
                 - np.float32(0.5)) / np.float32(R)
    lit = tail_frac[None, :] < fc.storm[:, None]
    dev = keys.device
    extra = ~mask & torch.as_tensor(lit, device=dev)
    lane_keys = torch.as_tensor((r % STORM_LANES), device=dev).to(
        keys.dtype)
    keys = torch.where(extra, lane_keys[None, :], keys)
    return keys, mask | extra, is_write | extra
