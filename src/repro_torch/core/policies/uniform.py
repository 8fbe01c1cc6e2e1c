"""Uniform-random placement baseline (balls-into-bins, d = 1)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.core.policies.base import Policy, RouteStats, register


class UniformDraws(NamedTuple):
    """A wave's draws: each request's server."""

    server: torch.Tensor  # (..., Rg) int32 in [0, m)


def route_uniform(
    draws: UniformDraws, mask: torch.Tensor
) -> torch.Tensor:
    return torch.where(mask, draws.server, -1)


@register("uniform")
class Uniform(Policy):
    """Each request picks a server uniformly at random (§V d=1 bound)."""

    def wave_draws(self, keys, cfg, Rg) -> UniformDraws:
        return UniformDraws(server=prng.randint(keys, (Rg,), 0, cfg.m))

    def route(self, state, ctx):
        return (
            state,
            route_uniform(ctx.draws, ctx.mask),
            RouteStats.zeros(ctx.mask.device),
        )
