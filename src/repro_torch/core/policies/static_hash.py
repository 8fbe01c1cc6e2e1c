"""Static consistent-hash placement (the no-steering MIDAS substrate)."""

from __future__ import annotations

import torch

from repro_torch.core.policies.base import Policy, RouteStats, register


@register("hash")
class StaticHash(Policy):
    """Every request goes to its ring primary -- stable placement, no
    load awareness.  This is what the warmup pass (§III-B) runs."""

    def route(self, state, ctx):
        assign = torch.where(ctx.mask, ctx.primary, -1)
        return state, assign, RouteStats.zeros(assign.device)
