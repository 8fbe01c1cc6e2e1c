"""Trace replay: drive the simulator from recorded metadata traces.

A trace is a ``.npz`` with three aligned 1-D arrays -- ``t_ms`` (float
event times), ``key`` (int namespace keys), ``is_write`` (bool).
:class:`TraceReplay` re-buckets events onto the simulator's ``(T, R)``
tick grid: tick ``floor(t_ms / dt_ms)``, slots filled in trace order,
keys folded into ``[0, N)``.  Traces shorter than the horizon loop, and
events past the per-tick slot budget ``R`` are dropped.

Everything here is host-side numpy, the reference's
(``repro/core/workloads/trace.py``) line for line, so a replayed grid is
the reference's bit for bit; only the finished grid moves to the
device.  The default trace is the synthetic recording in the checkout's
``tests/data/synthetic_trace.npz``, read as data; where the file is
absent :func:`synthetic_events` makes the identical events.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.workloads.base import (
    Workload,
    WorkloadParams,
    WorkloadSpec,
    register,
)

TRACE_FIELDS = ("t_ms", "key", "is_write")

#: Default trace: the synthetic recording in the checkout's tests/data/
DEFAULT_TRACE = (
    Path(__file__).resolve().parents[4]
    / "tests"
    / "data"
    / "synthetic_trace.npz"
)


def synthetic_events() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The default synthetic MDS trace, ~20 s: light Poisson background
    reads over a 512-key namespace plus two job-startup bursts
    hammering small hot directory sets, with renames mixed into the
    bursts.  Deterministic (``default_rng(42)``)."""
    rng = np.random.default_rng(42)
    events = []
    n_bg = rng.poisson(15 * 20)  # ~15 reads/s for 20 s
    events.append(
        (
            rng.uniform(0.0, 20_000.0, n_bg),
            rng.integers(0, 512, n_bg),
            np.zeros(n_bg, bool),
        )
    )
    # two bursts: 2 s each at ~120 req/s on 8 hot keys, 30% renames
    for t0, hot0 in ((4_000.0, 64), (13_000.0, 200)):
        n = rng.poisson(120 * 2)
        events.append(
            (
                rng.uniform(t0, t0 + 2_000.0, n),
                hot0 + rng.integers(0, 8, n),
                rng.random(n) < 0.3,
            )
        )
    t_ms = np.concatenate([e[0] for e in events])
    key = np.concatenate([e[1] for e in events]).astype(np.int64)
    is_write = np.concatenate([e[2] for e in events])
    order = np.argsort(t_ms, kind="stable")
    return t_ms[order], key[order], is_write[order]


def load_trace(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load and validate a ``(t_ms, key, is_write)`` trace from ``.npz``."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(
            f"trace file {path} not found; a trace is a .npz with 1-D "
            f"arrays {TRACE_FIELDS} (see repro_torch.core.workloads.trace)"
        )
    with np.load(path) as z:
        missing = [f for f in TRACE_FIELDS if f not in z]
        if missing:
            raise ValueError(
                f"trace {path} missing arrays: {missing}; "
                f"expected {TRACE_FIELDS}"
            )
        t_ms = np.asarray(z["t_ms"], np.float64)
        key = np.asarray(z["key"], np.int64)
        is_write = np.asarray(z["is_write"], bool)
    if not (t_ms.ndim == key.ndim == is_write.ndim == 1):
        raise ValueError(f"trace {path}: arrays must be 1-D")
    if not (t_ms.size == key.size == is_write.size):
        raise ValueError(
            f"trace {path}: array lengths differ "
            f"({t_ms.size}, {key.size}, {is_write.size})"
        )
    order = np.argsort(t_ms, kind="stable")
    return t_ms[order], key[order], is_write[order]


def rebucket(
    t_ms: np.ndarray,
    key: np.ndarray,
    is_write: np.ndarray,
    *,
    T: int,
    R: int,
    N: int,
    dt_ms: float,
    loop: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bucket trace events onto a ``(T, R)`` grid (host-side numpy).

    Returns ``(keys, mask, is_write)`` grids.  Events land at tick
    ``floor(t_ms / dt_ms)`` in trace order; within a tick the first
    ``R`` events get slots and the rest are dropped.  With ``loop=True``
    the trace repeats (offset by its span) until the horizon is covered.
    """
    if t_ms.size == 0:
        z = np.zeros((T, R), np.int32)
        return z, np.zeros((T, R), bool), np.zeros((T, R), bool)
    if loop:
        span = float(max(t_ms.max() + dt_ms, dt_ms))
        reps = int(np.ceil(T * dt_ms / span))
        offs = np.arange(reps, dtype=np.float64) * span
        t_ms = (t_ms[None, :] + offs[:, None]).reshape(-1)
        key = np.tile(key, reps)
        is_write = np.tile(is_write, reps)
    tick = np.floor(t_ms / dt_ms).astype(np.int64)
    keep = (tick >= 0) & (tick < T)
    tick, key, is_write = tick[keep], key[keep], is_write[keep]
    # stable sort by tick keeps trace order within each tick; slot index
    # is the running count since the tick's first event
    order = np.argsort(tick, kind="stable")
    tick, key, is_write = tick[order], key[order], is_write[order]
    _, start, counts = np.unique(tick, return_index=True, return_counts=True)
    slot = np.arange(tick.size) - np.repeat(start, counts)
    fits = slot < R
    tick, slot = tick[fits], slot[fits]
    key, is_write = key[fits], is_write[fits]
    keys = np.zeros((T, R), np.int32)
    mask = np.zeros((T, R), bool)
    writes = np.zeros((T, R), bool)
    keys[tick, slot] = (key % N).astype(np.int32)
    mask[tick, slot] = True
    writes[tick, slot] = is_write
    return keys, mask, writes


@register("trace_replay")
class TraceReplay(WorkloadSpec):
    """Replay a recorded ``(t_ms, key, is_write)`` trace onto the grid."""

    def __init__(self, trace=None, loop: bool = True):
        self.trace = Path(trace) if trace is not None else None
        self.loop = loop

    def build(self, p: WorkloadParams) -> Workload:
        if self.trace is not None:
            t_ms, key, is_write = load_trace(self.trace)
        elif DEFAULT_TRACE.exists():
            t_ms, key, is_write = load_trace(DEFAULT_TRACE)
        else:  # no checkout beside the package
            t_ms, key, is_write = synthetic_events()
        grids = rebucket(
            t_ms, key, is_write,
            T=p.T, R=p.R, N=p.N, dt_ms=p.dt_ms, loop=self.loop,
        )
        keys, mask, writes = (torch.as_tensor(g, device=p.device)
                              for g in grids)
        stem = self.trace.stem if self.trace is not None else "synthetic"
        return Workload(
            keys=keys,
            mask=mask,
            is_write=writes,
            name=f"trace_replay({stem})",
            N=p.N,
        )
