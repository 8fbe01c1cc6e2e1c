"""The paper's Fig. 2 traffic patterns the main path uses.

The port carries ``light`` (the §III-B warmup regime) and ``bursty``
(the main path's workload); the other five generators, the scenarios
and the combinators come later (ROADMAP §1 item 12).
"""

from __future__ import annotations

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
    x = p.sec + phase
    rem = torch.fmod(x, period_s)  # x >= 0: Python-style % is fmod
    in_burst = rem < dur_s
    burst_idx = torch.round((x - rem) / period_s).to(torch.int32)
    return in_burst, burst_idx


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
