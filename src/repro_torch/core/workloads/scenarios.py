"""Composed scenarios: bursty metadata patterns beyond the Fig. 2 seven.

Each scenario is a registered spec *built from the combinators* over
other registered workloads (``repro/core/workloads/scenarios.py``).
Component seeds are derived from the scenario seed so scenarios stay
deterministic and components stay decorrelated.  Rates, keys and the
combinators' draws are the reference's bit for bit; the components'
arrival counts are ``torch.poisson`` draws (:mod:`.base`).
"""

from __future__ import annotations

import functools

from repro_torch.core.workloads.base import (
    Workload,
    WorkloadParams,
    WorkloadSpec,
    register,
)
from repro_torch.core.workloads.combinators import (
    concat,
    mix,
    scale_rate,
    shift_hotset,
)

#: Scenarios introduced on top of the legacy seven (see fig2.WORKLOADS).
SCENARIOS = ("job_startup", "rename_storm", "flash_crowd", "multi_tenant")


def _phases(*parts: Workload) -> Workload:
    """Concat the non-empty phases (degenerate horizons drop to fewer
    phases but always yield exactly the requested T ticks)."""
    live = [w for w in parts if w.keys.shape[0] > 0]
    return functools.reduce(concat, live)


@register("job_startup")
class JobStartup(WorkloadSpec):
    """A cluster-wide job launch: every rank stats/opens the job's shared
    directories at once (a short skew-heavy crush at ~2x capacity), then
    the run settles into steady light traffic."""

    def build(self, p: WorkloadParams) -> Workload:
        t_start = min(max(p.T // 8, 1), p.T)
        crush = scale_rate(
            p.make("skewed", T=t_start, seed=p.seed + 101, write_frac=0.3),
            3.0,
            seed=p.seed + 1,
        )
        crush = shift_hotset(crush, p.N // 3)
        steady = p.make("light", T=p.T - t_start, seed=p.seed + 202)
        return _phases(crush, steady)


@register("rename_storm")
class RenameStorm(WorkloadSpec):
    """A directory restructure: a write-heavy (rename/unlink) stream over
    a skewed hot set, blended into light background reads.  Mutations
    defeat caching, so the hotspot lands squarely on the owning
    servers."""

    def build(self, p: WorkloadParams) -> Workload:
        background = p.make("light", seed=p.seed + 303)
        renames = scale_rate(
            p.make("skewed", seed=p.seed + 404, write_frac=0.85),
            1.3,
            seed=p.seed + 2,
        )
        return mix(background, renames, 0.7, seed=p.seed + 3)


@register("flash_crowd")
class FlashCrowd(WorkloadSpec):
    """A suddenly-popular dataset: light traffic, then every client reads
    the same namespace region at ~2x capacity, then the crowd drains."""

    def build(self, p: WorkloadParams) -> Workload:
        t_pre = min(max(p.T // 4, 1), p.T)
        t_peak = min(max(p.T // 3, 1), p.T - t_pre)
        t_post = p.T - t_pre - t_peak
        calm_a = p.make("light", T=t_pre, seed=p.seed + 505)
        crowd = scale_rate(
            p.make("skewed", T=t_peak, seed=p.seed + 606, write_frac=0.0),
            2.8,
            seed=p.seed + 4,
        )
        crowd = shift_hotset(crowd, 2 * p.N // 3)
        calm_b = p.make("light", T=t_post, seed=p.seed + 707)
        return _phases(calm_a, crowd, calm_b)


@register("multi_tenant")
class MultiTenant(WorkloadSpec):
    """Two tenants share the proxy tier: tenant A runs bursty job
    start-ups, tenant B runs periodic checkpoints in a shifted namespace
    region, interleaved per-slot -- neither sees a clean pattern."""

    def build(self, p: WorkloadParams) -> Workload:
        tenant_a = p.make("bursty", seed=p.seed + 808)
        tenant_b = shift_hotset(
            p.make("periodic", seed=p.seed + 909, write_frac=0.4),
            p.N // 2,
        )
        return mix(tenant_a, tenant_b, 0.5, seed=p.seed + 5)
