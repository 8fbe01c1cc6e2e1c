"""Compound fault programs: overlap, sequence, and cascade triggers.

Real outages compound: a server crashes during a checkpoint storm,
brownouts roll across the servers one disk at a time, a partition
follows a crash because the gossip fabric reacts to the membership
flap.  This module composes :class:`~repro_torch.core.faults.base.
FaultEvent` values into programs that compile into the same host-side
:class:`Schedule`.

* :func:`overlap` -- events whose windows all intersect, checked at
  construction;
* :func:`sequence` -- events re-timed to fire one after another with a
  ``stagger`` (:func:`rolling` for one kind across targets); an empty
  sequence is ``()``, the untouched engine;
* :class:`CascadeEvent` -- event B fires at event A's *detection* tick
  plus an offset.  Detection depends on ``dt_ms``, so cascades resolve
  in the fault compiler, where the horizon and the config are known
  (:func:`resolve`).

Every registered spec writes monotonically into the shared schedule
(membership only clears, service scales multiply, partitions only set,
storm intensity maxes), so a program's compiled schedule is the
element-wise composition of its single events' schedules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.faults.base import (
    FaultEvent,
    Schedule,
    detect_available,
    detect_ticks,
    get,
)


@dataclasses.dataclass(frozen=True)
class CascadeEvent:
    """Event ``effect`` fires at ``trigger``'s detection tick + offset.

    Hashable (rides ``SimConfig.faults`` beside plain events).  The
    ``effect``'s own ``t0`` is a placeholder that :func:`resolve`
    replaces.  The trigger itself is applied too.
    """

    trigger: FaultEvent
    effect: FaultEvent
    offset: int = 0


def _nominal_window(ev: FaultEvent) -> Tuple[int, float]:
    """[t0, t1) before horizon clipping; open-ended when duration<=0."""
    t0 = max(int(ev.t0), 0)
    t1 = float("inf") if ev.duration <= 0 else t0 + int(ev.duration)
    return t0, t1


def overlap(*events: FaultEvent) -> Tuple[FaultEvent, ...]:
    """Events that must be active together at some tick: every pair of
    windows must intersect, else this raises (use :func:`sequence`)."""
    evs = tuple(events)
    for i, a in enumerate(evs):
        for b in evs[i + 1:]:
            a0, a1 = _nominal_window(a)
            b0, b1 = _nominal_window(b)
            if max(a0, b0) >= min(a1, b1):
                raise ValueError(
                    f"overlap: windows of {a!r} and {b!r} do not "
                    f"intersect; use sequence() for disjoint events"
                )
    return evs


def sequence(
    *events: FaultEvent, t0: Optional[int] = None,
    stagger: Optional[int] = None,
) -> Tuple[FaultEvent, ...]:
    """Events re-timed to roll one after another: with ``t0`` or
    ``stagger`` given, event ``i`` starts at ``t0 + i * stagger`` (its
    duration kept); otherwise their own timings stay.  ``sequence()``
    is ``()``."""
    evs = tuple(events)
    if not evs:
        return ()
    if stagger is not None and stagger < 0:
        raise ValueError(f"sequence: stagger must be >= 0, got {stagger}")
    if t0 is None and stagger is None:
        return evs
    start = evs[0].t0 if t0 is None else int(t0)
    step = stagger if stagger is not None else 0
    return tuple(
        dataclasses.replace(ev, t0=start + i * step)
        for i, ev in enumerate(evs)
    )


def rolling(
    kind: str,
    *,
    targets: Tuple[int, ...],
    t0: int,
    duration: int,
    stagger: int,
    magnitude: float = 0.5,
) -> Tuple[FaultEvent, ...]:
    """The same fault rolling across ``targets``, e.g. per-server
    brownouts marching down the servers one disk at a time."""
    return sequence(
        *(
            FaultEvent(
                kind, t0=0, duration=duration, target=t, magnitude=magnitude
            )
            for t in targets
        ),
        t0=t0,
        stagger=stagger,
    )


def detection_tick(
    ev: FaultEvent, *, dt_ms: float, T: int, m: int, P: int
) -> int:
    """First tick the fault layer notices ``ev``: the first tick where
    detected membership drops (a crash at ``t0`` is noticed at ``t0 +
    detect_ticks(dt_ms)``); faults that never change detected
    membership are noticed at their first active tick; an event that
    never fires inside the horizon gives ``T``."""
    sched = Schedule(T, m, P)
    get(ev.kind).apply(ev, sched)
    detected = detect_available(sched.member, detect_ticks(dt_ms))
    lost = np.flatnonzero((~detected).any(axis=1))
    if lost.size:
        return int(lost[0])
    active = np.flatnonzero(sched.active)
    return int(active[0]) if active.size else T


def resolve(
    events, *, dt_ms: float, T: int, m: int, P: int
) -> Tuple[FaultEvent, ...]:
    """Expand cascade entries into plain events: each
    :class:`CascadeEvent` becomes its trigger plus its effect re-timed
    to ``detection_tick(trigger) + offset``; plain events pass through.
    A trigger never detected inside the horizon pushes the effect past
    ``T``, so it never fires."""
    out = []
    for ev in events:
        if isinstance(ev, CascadeEvent):
            t_fire = (
                detection_tick(ev.trigger, dt_ms=dt_ms, T=T, m=m, P=P)
                + int(ev.offset)
            )
            out.append(ev.trigger)
            out.append(dataclasses.replace(ev.effect, t0=t_fire))
        else:
            out.append(ev)
    return tuple(out)
