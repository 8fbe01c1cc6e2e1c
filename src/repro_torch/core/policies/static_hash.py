"""Static consistent-hash placement (the no-steering MIDAS substrate)."""

from __future__ import annotations

import torch

from repro_torch.core import hashring
from repro_torch.core.policies.base import Policy, RouteStats, register


def route_hash(
    ring: hashring.Ring, keys: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Each request's ring primary, -1 where ``mask`` is False."""
    return torch.where(mask, hashring.primary(ring, keys), -1)


@register("hash")
class StaticHash(Policy):
    """Every request goes to its ring primary -- stable placement, no
    load awareness.  This is what the warmup pass (§III-B) runs."""

    def route(self, state, ctx):
        assign = torch.where(ctx.mask, ctx.primary, -1)
        return state, assign, RouteStats.zeros(assign.device)
