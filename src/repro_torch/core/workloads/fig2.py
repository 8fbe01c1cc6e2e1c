"""The paper's Fig. 2 traffic patterns -- the seven legacy generators.

Each is a registered :class:`~repro_torch.core.workloads.base.WorkloadSpec`.
Rate curves, burst and storm timelines, hot keys and key draws are the
reference's bit for bit: float32 in the reference's order, with the C
library's ``sinf`` where the reference calls ``jnp.sin`` on the CPU
(:func:`repro_torch.core.xla.libm`).  The per-tick arrival counts are
``torch.poisson`` draws, so a realized grid matches the reference only
in distribution (:mod:`.base`).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import prng
from repro_torch.core.workloads.base import (
    Workload,
    WorkloadParams,
    WorkloadSpec,
    assemble,
    hot_subset_keys,
    register,
)
from repro_torch.core.xla import libm

#: The legacy closed tuple; the live list is ``workloads.available()``.
WORKLOADS = (
    "light",
    "uniform_heavy",
    "bursty",
    "periodic",
    "diurnal",
    "skewed",
    "storm",
)


def _floor_div(x: torch.Tensor, y: float):
    """``(x % y, x // y)`` of float32 ``x >= 0`` as jnp computes them:
    the remainder by fmod, the quotient as round((x - rem) / y)."""
    rem = torch.fmod(x, y)
    return rem, torch.round((x - rem) / y)


def _wave(sec: torch.Tensor, period) -> torch.Tensor:
    """``jnp.sin(2 * jnp.pi * sec / period)`` rounded as the reference
    rounds it on the CPU (``period`` a float or a 0-d tensor)."""
    return libm("sinf", 2 * math.pi * sec / period)

@register("light")
class Light(WorkloadSpec):
    """Steady 40% utilization, uniform keys (the §III-B warmup regime)."""

    def build(self, p: WorkloadParams) -> Workload:
        rate = torch.full((p.T,), 0.40 * p.cap)
        return assemble(
            p.rng, rate, p.R, p.N, 0.0, p.write_frac, "light", seed=p.seed
        )


def burst_timeline(p: WorkloadParams, phase_key: torch.Tensor):
    """(in_burst, burst_idx) per tick: every 20 s, a 2 s burst, at a
    random phase.  Float32 arithmetic in the reference's order, so the
    timeline equals the reference's bit for bit."""
    period_s, dur_s = 20.0, 2.0
    phase = prng.uniform(phase_key, ()).cpu() * period_s
    rem, epoch = _floor_div(p.sec + phase, period_s)
    return rem < dur_s, epoch.to(torch.int32)


@register("uniform_heavy")
class UniformHeavy(WorkloadSpec):
    """Steady 85% utilization, uniform keys -- headroom stress, no skew."""

    def build(self, p: WorkloadParams) -> Workload:
        rate = torch.full((p.T,), 0.85 * p.cap)
        return assemble(p.rng, rate, p.R, p.N, 0.0, p.write_frac,
                        "uniform_heavy", seed=p.seed)


@register("bursty")
class Bursty(WorkloadSpec):
    """Background 30% + job-startup bursts: every ~20 s, 2 s at 3x
    capacity, keys concentrated on a small hot directory set.  Each
    burst is a *different* job => different hot directories."""

    def build(self, p: WorkloadParams) -> Workload:
        k1, k2, k3 = prng.split(p.rng, 3).unbind(0)
        in_burst, burst_idx = burst_timeline(p, k3)
        base = torch.full((p.T,), 0.30 * p.cap)
        rate = base + torch.where(in_burst, 3.0 * p.cap, 0.0)
        wl = assemble(
            k1, rate, p.R, p.N, 0.0, p.write_frac, "bursty", seed=p.seed
        )
        hot = hot_subset_keys(
            k2,
            wl.keys.shape,
            burst_idx.to(p.device),
            p.N,
            subset=32,
            alpha=1.1,
            salt=11,
        )
        keys = torch.where(in_burst.to(p.device)[:, None], hot, wl.keys)
        return wl._replace(keys=keys)


@register("periodic")
class Periodic(WorkloadSpec):
    """Sinusoid peaking slightly above capacity (checkpoint cadence)."""

    def build(self, p: WorkloadParams) -> Workload:
        rate = p.cap * torch.clamp(0.55 + 0.55 * _wave(p.sec, 30.0),
                                   min=0.0)
        return assemble(p.rng, rate, p.R, p.N, 0.6, p.write_frac,
                        "periodic", seed=p.seed)


@register("diurnal")
class Diurnal(WorkloadSpec):
    """Slow horizon-long swell with a faster ripple on top."""

    def build(self, p: WorkloadParams) -> Workload:
        sec = p.sec
        horizon = torch.clamp(sec[-1], min=1.0)
        rate = p.cap * torch.clamp(
            0.5 + 0.45 * _wave(sec, horizon) + 0.08 * _wave(sec, 13.0),
            min=0.0,
        )
        return assemble(p.rng, rate, p.R, p.N, 0.5, p.write_frac,
                        "diurnal", seed=p.seed)


@register("skewed")
class Skewed(WorkloadSpec):
    """Steady 70% utilization under zipf(0.9) key popularity."""

    def build(self, p: WorkloadParams) -> Workload:
        rate = torch.full((p.T,), 0.70 * p.cap)
        return assemble(p.rng, rate, p.R, p.N, 0.9, p.write_frac,
                        "skewed", seed=p.seed)


def storm_timeline(p: WorkloadParams):
    """(storm, storm_idx) per tick: the first 5 s of every minute, and
    which minute (each storm a different job)."""
    rem, epoch = _floor_div(p.sec, 60.0)
    return rem < 5.0, epoch.to(torch.int32)


@register("storm")
class Storm(WorkloadSpec):
    """Checkpoint storm: near-idle then all ranks write at once (5 s);
    each storm targets that job's checkpoint directories."""

    def build(self, p: WorkloadParams) -> Workload:
        k1, k2 = prng.split(p.rng).unbind(0)
        storm, storm_idx = storm_timeline(p)
        rate = torch.where(storm, 4.0 * p.cap, 0.05 * p.cap)
        wl = assemble(k1, rate, p.R, p.N, 0.0, 0.5, "storm", seed=p.seed)
        hot = hot_subset_keys(
            k2,
            wl.keys.shape,
            storm_idx.to(p.device),
            p.N,
            subset=16,
            alpha=1.0,
            salt=17,
        )
        keys = torch.where(storm.to(p.device)[:, None], hot, wl.keys)
        return wl._replace(keys=keys)
