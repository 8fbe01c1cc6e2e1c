"""Registered fault events (the built-in fault vocabulary).

Each spec documents its schedule effect; detection, epochs and remap
invalidation are shared machinery in :mod:`repro_torch.core.faults.base`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.faults.base import (
    FaultEvent,
    FaultSpec,
    Schedule,
    register,
)


def _server(ev: FaultEvent, m: int) -> int:
    """Resolve a server target: -1 means the last server (m-1)."""
    return m - 1 if ev.target < 0 else ev.target


def _check_server(ev: FaultEvent, m: int) -> None:
    if not -1 <= ev.target < m:
        raise ValueError(
            f"fault {ev.kind!r} target must be a server in [0, {m}) "
            f"or -1, got {ev.target}"
        )


def _check_magnitude(ev: FaultEvent) -> None:
    if not 0.0 < ev.magnitude <= 1.0:
        raise ValueError(
            f"fault {ev.kind!r} magnitude must be in (0, 1], "
            f"got {ev.magnitude}"
        )


@register("proxy_crash")
class ProxyCrash(FaultSpec):
    """A metadata server vanishes for the event window: it serves zero
    requests at once (ground truth), but proxies keep routing to it
    until the heartbeat timeout expires; then the detected ring drops
    it, its keys remap to ring successors, and remapped cache entries
    are invalidated.  Rejoin at the window's end flips back."""

    def validate(self, ev: FaultEvent, m: int, P: int) -> None:
        _check_server(ev, m)

    def apply(self, ev: FaultEvent, sched: Schedule) -> None:
        t0, t1 = sched.window(ev)
        sched.member[t0:t1, _server(ev, sched.m)] = False
        sched.active[t0:t1] = True


@register("proxy_join")
class ProxyJoin(FaultSpec):
    """A server is absent from the start of the run and joins at t0.
    Its keys remap onto it at join (heartbeats make detection
    immediate), so the caches revalidate every entry it now owns.
    ``duration`` is ignored; the fault window is [0, t0)."""

    def validate(self, ev: FaultEvent, m: int, P: int) -> None:
        _check_server(ev, m)
        if m < 2:
            raise ValueError(
                "proxy_join needs m >= 2: the ring must stay non-empty "
                "before the join"
            )

    def apply(self, ev: FaultEvent, sched: Schedule) -> None:
        t0 = min(max(int(ev.t0), 0), sched.T)
        sched.member[:t0, _server(ev, sched.m)] = False
        sched.active[:t0] = True


@register("server_brownout")
class ServerBrownout(FaultSpec):
    """The target server's service rate is multiplied by ``magnitude``
    for the window (a slow disk, a noisy neighbour).  Membership never
    changes; the controller sees the brownout through queue telemetry
    alone."""

    def validate(self, ev: FaultEvent, m: int, P: int) -> None:
        _check_server(ev, m)
        _check_magnitude(ev)

    def apply(self, ev: FaultEvent, sched: Schedule) -> None:
        t0, t1 = sched.window(ev)
        sched.service_scale[t0:t1, _server(ev, sched.m)] *= ev.magnitude
        sched.active[t0:t1] = True


@register("gossip_partition")
class GossipPartition(FaultSpec):
    """Gossip stops reaching the target proxy (-1: every proxy) for the
    window: remote installs and invalidations stay invisible to it until
    the partition heals, so its stale serves rise."""

    def validate(self, ev: FaultEvent, m: int, P: int) -> None:
        if not -1 <= ev.target < P:
            raise ValueError(
                f"gossip_partition target must be a proxy in [0, {P}) "
                f"or -1 (all), got {ev.target}"
            )

    def apply(self, ev: FaultEvent, sched: Schedule) -> None:
        t0, t1 = sched.window(ev)
        if ev.target < 0:
            sched.partition[t0:t1, :] = True
        else:
            sched.partition[t0:t1, ev.target] = True
        sched.active[t0:t1] = True


@register("ckpt_storm_fleet")
class CkptStormFleet(FaultSpec):
    """Fleet-scale checkpoint storm: for the window, the trailing
    ``magnitude`` fraction of each tick's idle request slots fire as
    WRITES against the ``STORM_LANES`` hot writer-lane keys, which
    stresses the install guard and lease invalidation."""

    def validate(self, ev: FaultEvent, m: int, P: int) -> None:
        _check_magnitude(ev)

    def apply(self, ev: FaultEvent, sched: Schedule) -> None:
        t0, t1 = sched.window(ev)
        sched.storm[t0:t1] = np.maximum(sched.storm[t0:t1], ev.magnitude)
        sched.active[t0:t1] = True


def storm_from_pool(pool, t0: int = 100, duration: int = 200) -> FaultEvent:
    """A ``ckpt_storm_fleet`` event calibrated from a writer pool: any
    object with a ``backlogs()`` method giving each lane's queued
    backlog.  The intensity is the worst lane's share of the backlog
    (1.0 = one lane holds everything)."""
    b = [float(x) for x in pool.backlogs()]
    total = sum(b)
    mag = (max(b) / total) if total > 0 and b else 1.0 / max(len(b), 1)
    return FaultEvent(
        kind="ckpt_storm_fleet",
        t0=t0,
        duration=duration,
        magnitude=min(max(mag, 1e-3), 1.0),
    )
