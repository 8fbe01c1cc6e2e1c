"""Full join-shortest-queue.

JSQ samples ALL m servers -- the d = m limit of power-of-d -- ignoring
namespace feasibility.  It is not a deployable metadata policy
(requests must reach a server that can resolve their object), but it
bounds how much balance any sampling policy can buy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.core.policies.base import (
    Policy,
    RouteStats,
    register,
    steering_dv,
)


class JsqDraws(NamedTuple):
    """A wave's draws: a tie-break score per request and server."""

    tie: torch.Tensor  # (..., Rg, m) float32 in [0, 1e-3)


def route_jsq(
    draws: JsqDraws, L_view: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Each request joins the globally shortest queue (random
    tie-break; exact ties to the lowest server, as ``jnp.argmin``)."""
    assign = torch.argmin(L_view[None, :] + draws.tie, 1).to(torch.int32)
    return torch.where(mask, assign, -1)


@register("jsq")
class JoinShortestQueue(Policy):
    """Global JSQ over the stale telemetry view (d = m upper bound)."""

    def wave_draws(self, keys, cfg, Rg) -> JsqDraws:
        return JsqDraws(tie=prng.uniform(keys, (Rg, cfg.m)) * 1e-3)

    def route(self, state, ctx):
        assign = route_jsq(ctx.draws, ctx.L_view, ctx.mask)
        z = torch.zeros((), dtype=torch.float32, device=assign.device)
        return state, assign, RouteStats(
            steered=z, eligible=z, dV=steering_dv(ctx, assign)
        )
