"""Consistent hashing with bounded loads.

CHBL (Mirrokni, Thorup & Zadimoghaddam, 2018): every request goes to
its ring primary unless the primary's load exceeds ``c`` times the
mean; then it walks the feasible-set successors clockwise and takes
the first server under the cap (falling back to the least-loaded
successor when all are over).  It steers deterministically and only
under overload, so it draws nothing.
"""

from __future__ import annotations

import torch

from repro_torch.core.policies.base import (
    Policy,
    RouteStats,
    TickRoute,
    register,
    steering_dv,
)
from repro_torch.core.xla import fma, reduce_sum
from repro_torch.kernels.midas_route import ops as route_ops
from repro_torch.kernels.midas_route.ref import C_LOAD


def load_cap(L_view: torch.Tensor, c: float = C_LOAD) -> torch.Tensor:
    """``c * (mean(L_view) + 1)`` rounded as the reference computes it
    on the CPU: XLA's order of the sum, then the mean's multiply by
    ``1/m`` fused with the ``+ 1``.  A last-bit difference here flips
    ``load <= cap`` for a load that sits on the cap."""
    return fma(reduce_sum(L_view), 1.0 / L_view.shape[0], 1.0) * c


def route_bounded_load(
    feas: torch.Tensor,
    L_view: torch.Tensor,
    mask: torch.Tensor,
    c: float = C_LOAD,
    impl: str = "ref",
) -> torch.Tensor:
    """First feasible successor under the load cap; primary when it
    fits; the least loaded when none does.  The ``route_select``
    kernel's chbl mode (``impl="cuda"``, the cap in scalar slot 2) or
    its plain version: both compare against the same cap, so they are
    bitwise equal."""
    z = torch.zeros((), dtype=torch.float32, device=feas.device)
    scalars = torch.stack([z, z, load_cap(L_view, c), z])
    assign, _ = route_ops.route_waves(
        feas, L_view, L_view,
        torch.zeros(feas.shape, dtype=torch.bool, device=feas.device),
        torch.zeros(feas.shape, dtype=torch.float32, device=feas.device),
        scalars, mode="chbl", impl=impl,
    )
    return torch.where(mask, assign, -1)


@register("chbl")
class BoundedLoadHash(Policy):
    """Consistent hashing with bounded loads (cap = 1.25 * (mean + 1))."""

    def route(self, state, ctx):
        assign = route_bounded_load(
            ctx.feas, ctx.L_view, ctx.mask, impl=ctx.route_impl
        )
        moved = ctx.mask & (assign != ctx.primary)
        z = torch.zeros((), dtype=torch.float32, device=assign.device)
        return state, assign, RouteStats(
            steered=moved.sum().to(torch.float32),
            eligible=z,
            dV=steering_dv(ctx, assign),
        )

    def route_tick(self, state, ctx):
        """The tick's G waves in one launch of the ``route_tick`` kernel
        (its chbl mode): :func:`route_bounded_load` with each wave's cap
        from that wave's view (rounded as :func:`load_cap`), the steered
        count and the waves' dV summed as :func:`steering_dv` sums each
        wave; no state.  A (G, m) ``ctx.L_view`` is fleet routing's
        per-wave views."""
        assign, _, arrivals, steered, eligible, dv, _ = route_ops.route_tick(
            ctx.keys, ctx.mask, ctx.feas, None, None, ctx.L_view,
            mode="chbl",
        )
        return state, TickRoute(
            assign=assign, arrivals=arrivals,
            stats=RouteStats(steered=steered, eligible=eligible, dV=dv))
