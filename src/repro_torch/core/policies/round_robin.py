"""Round-robin placements: the Lustre baseline and the per-request ablation.

Faithfulness note: real round-robin is run by P independent proxies with
random phases, which is how RR actually behaves at scale (aggregate ≈
random placement).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.policies.base import Policy, RouteStats, register
from repro_torch.kernels.common import resolve_device


def route_round_robin(
    keys: torch.Tensor, mask: torch.Tensor, m: int
) -> torch.Tensor:
    """Lustre (Round-Robin) baseline: namespace objects are assigned to
    metadata targets *sequentially at creation time* (DNE round-robin
    striping), and every request follows its object's placement.  Object
    ids are creation-ordered, so placement is ``key mod m``: the
    placement never reacts to load."""
    return torch.where(mask, (keys % m).to(torch.int32), -1)


class RRState(NamedTuple):
    rr_count: torch.Tensor  # (P,) int32 per-proxy RR counters
    rr_phase: torch.Tensor  # (P,) int32 per-proxy RR phases


class RRDraws(NamedTuple):
    """A wave's draws: the proxy that sends each request."""

    proxy: torch.Tensor  # (..., Rg) int32 in [0, P)


def init_rr(P: int, seed: int = 0, device=None) -> RRState:
    """Zero counters and random phases (the reference's draw from
    ``PRNGKey(seed ^ 0xA5A5)``) on ``device`` (the card when None)."""
    key = prng.PRNGKey(seed ^ 0xA5A5, resolve_device(device))
    return RRState(
        rr_count=torch.zeros((P,), dtype=torch.int32, device=key.device),
        rr_phase=prng.randint(key, (P,), 0, 1_000_000),
    )


def route_rr_per_request(
    rs: RRState, proxy: torch.Tensor, mask: torch.Tensor, m: int
) -> Tuple[RRState, torch.Tensor]:
    """Ablation: P independent per-proxy per-request round-robin streams
    (ignores namespace placement entirely; not a valid metadata policy,
    but a fairness upper bound on *counts*)."""
    P = rs.rr_count.shape[0]
    proxy = proxy.long()
    oh = (proxy[:, None] == torch.arange(P, device=proxy.device)) \
        & mask[:, None]  # (R, P)
    ohi = oh.to(torch.int32)
    prior = torch.cumsum(ohi, 0) - ohi  # same-proxy requests before r
    rank = (prior * ohi).sum(1)  # (R,)
    base = rs.rr_phase[proxy] + rs.rr_count[proxy]
    assign = ((base + rank) % m).to(torch.int32)
    new_count = rs.rr_count + ohi.sum(0).to(torch.int32)
    return rs._replace(rr_count=new_count), torch.where(mask, assign, -1)


@register("round_robin")
class RoundRobin(Policy):
    """Static creation-time round-robin placement (Lustre DNE baseline)."""

    def route(self, state, ctx):
        return (
            state,
            route_round_robin(ctx.keys, ctx.mask, ctx.m),
            RouteStats.zeros(ctx.keys.device),
        )


@register("rr_request")
class RRPerRequest(Policy):
    """Per-request round-robin across P independent proxies (ablation)."""

    def init(self, cfg, ring, device=None) -> RRState:
        return init_rr(cfg.P, cfg.seed, device)

    def wave_draws(self, keys, cfg, Rg) -> RRDraws:
        return RRDraws(proxy=prng.randint(prng.fold_in(keys, 11), (Rg,),
                                          0, cfg.P))

    def route(self, state: RRState, ctx):
        state, assign = route_rr_per_request(
            state, ctx.draws.proxy, ctx.mask, ctx.m
        )
        return state, assign, RouteStats.zeros(assign.device)
