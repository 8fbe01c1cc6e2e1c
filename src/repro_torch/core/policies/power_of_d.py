"""Power-of-d within the namespace-feasible set (paper's headline policy)."""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.policies.base import (
    Policy,
    RouteStats,
    TickRoute,
    WaveDraws,
    register,
    sample_ranks,
    steering_dv,
)
from repro_torch.kernels.midas_route import ops as route_ops


def route_power_of_d(
    draws: WaveDraws,
    feas: torch.Tensor,
    L_view: torch.Tensor,
    mask: torch.Tensor,
    d,
    impl: str = "ref",
) -> torch.Tensor:
    """Pure JSQ(d) within the feasible set (paper §VI eval policy),
    through the ``route_select`` kernel or its plain version."""
    sampled = draws.rank < d
    scalars = torch.zeros((4,), dtype=torch.float32, device=feas.device)
    assign, _ = route_ops.route_waves(
        feas, L_view, L_view, sampled, draws.tie, scalars,
        mode="power_of_d", impl=impl,
    )
    return torch.where(mask, assign, -1)


@register("power_of_d")
class PowerOfD(Policy):
    """JSQ(d) over the feasible set with fixed d = cfg.fixed_d."""

    def draws(self, keys, shape) -> WaveDraws:
        tie = prng.uniform(prng.fold_in(keys, 1), shape) * 1e-3
        return WaveDraws(
            rank=sample_ranks(prng.uniform(keys, shape)), tie=tie
        )

    def route(self, state, ctx):
        assign = route_power_of_d(
            ctx.draws,
            ctx.feas,
            ctx.L_view,
            ctx.mask,
            ctx.fixed_d,
            impl=ctx.route_impl,
        )
        z = torch.zeros((), dtype=torch.float32, device=assign.device)
        return state, assign, RouteStats(
            steered=z, eligible=z, dV=steering_dv(ctx, assign)
        )

    def route_tick(self, state, ctx):
        """The tick's G waves in one launch of the ``route_tick`` kernel
        (its power_of_d mode): :func:`route_power_of_d` on each wave's
        view and the waves' dV summed as :func:`steering_dv` sums each
        wave; no state.  A (G, m) ``ctx.L_view`` is fleet routing's
        per-wave views; ``ctx.fixed_d`` the run's () int32 d."""
        assign, _, arrivals, steered, eligible, dv, _ = route_ops.route_tick(
            ctx.keys, ctx.mask, ctx.feas, ctx.draws.rank, ctx.draws.tie,
            ctx.L_view, d=ctx.fixed_d, mode="power_of_d",
        )
        return state, TickRoute(
            assign=assign, arrivals=arrivals,
            stats=RouteStats(steered=steered, eligible=eligible, dV=dv))
