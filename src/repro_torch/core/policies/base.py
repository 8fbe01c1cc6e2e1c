"""Policy protocol, route context, and the policy registry.

A *policy* is the routing stage of the MIDAS middleware pipeline: given
a wave of requests and the proxies' (stale) view of server state, it
assigns each request to a metadata server.  Policies register by name;
the simulator resolves ``cfg.policy`` through the registry.

Protocol
--------
``Policy.init(cfg, ring, device) -> state`` builds the policy's carried
state (``()`` for stateless policies).  ``Policy.wave_draws(keys, cfg,
Rg)`` makes the policy's random draws for many waves of ``Rg``
requests at once: ``keys`` are per-wave PRNG keys ``(..., 2)`` and the
result is a NamedTuple of ``(..., ...)`` tensors led by the keys' axes
(or ``None`` for a policy that draws nothing); each policy sizes its
own draws from ``cfg``.  The default is ``draws(keys, (Rg, d_max))``,
a :class:`WaveDraws` over each request's feasible slots (midas,
power_of_d).  The engine calls it ONCE for the whole horizon before
the tick loop, with exactly the keys the reference engine hands each
wave, so the draws are bit-for-bit the reference's and no random bits
are made inside a tick.
``Policy.route(state, ctx) -> (state, assign, RouteStats)`` routes one
wave; ``ctx.draws`` holds that wave's slice of the draws (each field
indexed by the leading axes, :func:`slice_draws`).  ``assign``
is ``(R,)`` int32 server ids (-1 for masked-out slots).
``Policy.route_tick(state, ctx) -> (state, TickRoute) | None`` routes a
whole tick's waves in one kernel launch where the policy has such a
kernel; the engine calls it only for the CUDA route impl, and routes
wave by wave through ``route`` when it returns None (the default).
"""

from __future__ import annotations

import functools
import operator
from typing import Any, NamedTuple, Optional, Tuple, Type

import torch

from repro_torch.core import prng
from repro_torch.core import registry as registry_lib
from repro_torch.core.controllers.base import Knobs
from repro_torch.core.xla import loop_sum


class RouteContext(NamedTuple):
    """One routing wave, as seen by a policy."""

    keys: torch.Tensor  # (R,) int64 namespace keys
    mask: torch.Tensor  # (R,) bool validity
    feas: torch.Tensor  # (R, d_max) int32 feasible set; slot 0 = primary
    L_view: torch.Tensor  # (m,) float32 stale EWMA queue + own sends
    p50_view: torch.Tensor  # (m,) float32 stale EWMA p50 (ms)
    knobs: Knobs  # controller-emitted knob bundle
    now_ms: torch.Tensor  # () float32 tick clock
    draws: Optional[tuple]  # this wave's slice of the policy's draws
    m: int  # number of servers
    # d for non-adaptive power-of-d: cfg.fixed_d, or in a tick's context
    # (Policy.route_tick) the run's () int32 tensor of it
    fixed_d: Any
    # resolved routing implementation: "ref" (plain PyTorch) or "cuda"
    # (the route_select kernel; bit-identical by contract)
    route_impl: str = "ref"

    @property
    def primary(self) -> torch.Tensor:
        """Ring-primary server per request (feasible-set slot 0)."""
        return self.feas[:, 0]


class WaveDraws(NamedTuple):
    """A wave's random draws: the candidate ranking and tie scores."""

    rank: torch.Tensor  # (..., d_max) int8 candidate rank, primary = 0
    tie: torch.Tensor  # (..., d_max) float32 tie-break scores


class RouteStats(NamedTuple):
    """Per-wave steering telemetry; summed across waves into TickOut."""

    steered: torch.Tensor  # () float32 requests steered off primary
    eligible: torch.Tensor  # () float32 steer-eligible requests
    dV: torch.Tensor  # () float32 Lyapunov ΔV of admitted steers

    @classmethod
    def zeros(cls, device=None) -> "RouteStats":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return cls(steered=z, eligible=z, dV=z)

    def __add__(self, other: "RouteStats") -> "RouteStats":
        return RouteStats(
            steered=self.steered + other.steered,
            eligible=self.eligible + other.eligible,
            dV=self.dV + other.dV,
        )


def steering_dv(ctx: RouteContext, assign: torch.Tensor) -> torch.Tensor:
    """ΔV contribution of steering away from primary (paper eq. 2),
    summed over the wave in XLA's order (``xla.loop_sum``)."""
    prim = ctx.primary.long()
    moved = ctx.mask & (assign != ctx.primary) & (assign >= 0)
    dv = 2.0 * (ctx.L_view[assign.clamp(min=0).long()]
                - ctx.L_view[prim]) + 2.0
    return loop_sum(torch.where(moved, dv, 0.0))


class TickRoute(NamedTuple):
    """A tick's routing: its G waves of Rg requests."""

    assign: torch.Tensor  # (G, Rg) int32 server per request, -1 masked
    arrivals: torch.Tensor  # (m,) float32 requests sent to each server
    stats: RouteStats  # summed over the waves in wave order


def steering_dv_waves(
    ctx: RouteContext, views: torch.Tensor, assign: torch.Tensor
) -> torch.Tensor:
    """:func:`steering_dv` of each of a tick's waves, summed in wave order.

    ``ctx`` holds the tick's (G, Rg) waves, ``views`` (G, m) the view each
    wave was routed on and ``assign`` (G, Rg) its assignments.  The terms
    are elementwise, so computing them for all waves at once changes no
    bit; each wave's terms are then summed on their own, row by row in
    one batched ``xla.loop_sum``, as :func:`steering_dv` sums them (an
    order that depends on the row's length alone).  So the result equals
    the waves one at a time bit for bit.  (The sums are added from the
    first wave's, not from 0.0: a sum that starts at +0.0 is never -0.0,
    so 0.0 + s == s.)  G >= 1.  The ``route_tick`` kernel computes the
    same sums on the card; this is their plain expression."""
    prim = ctx.feas[..., 0]
    moved = ctx.mask & (assign != prim) & (assign >= 0)
    dv = 2.0 * (views.gather(1, assign.clamp(min=0).long())
                - views.gather(1, prim.long())) + 2.0
    sums = loop_sum(torch.where(moved, dv, 0.0))  # (G,)
    return functools.reduce(operator.add, sums.unbind(0))


class Policy:
    """Base class for registered routing policies.

    ``adaptive = True`` marks a policy that consumes the warmup-derived
    control targets (§III-B), so ``simulate`` runs the warmup pass.
    """

    name: str = "?"
    adaptive: bool = False

    def init(self, cfg, ring, device=None) -> Any:
        """Build the policy's carried state (default: stateless)."""
        return ()

    def draws(
        self, keys: torch.Tensor, shape: Tuple[int, ...]
    ) -> Optional[WaveDraws]:
        """Per-slot random draws ``(..., *shape)`` for a batch of waves
        (default: none)."""
        return None

    def wave_draws(
        self, keys: torch.Tensor, cfg, Rg: int
    ) -> Optional[tuple]:
        """The draws of waves of ``Rg`` requests, sized from ``cfg``
        (default: :meth:`draws` over the ``d_max`` feasible slots)."""
        return self.draws(keys, (Rg, cfg.d_max))

    def route(
        self, state: Any, ctx: RouteContext
    ) -> Tuple[Any, torch.Tensor, RouteStats]:
        raise NotImplementedError

    def route_tick(
        self, state: Any, ctx: RouteContext
    ) -> Optional[Tuple[Any, TickRoute]]:
        """Route a tick's G waves in one kernel launch, bit for bit as
        :meth:`route` wave by wave would.  ``ctx`` holds (G, Rg) waves,
        their (G, Rg, d_max) draws, and in ``L_view`` the (m,) stale view
        without this tick's sends, or under fleet routing the (G, m)
        per-wave views (wave g routes on row g alone).  Default: None,
        no such kernel."""
        return None


def slice_draws(draws: Optional[tuple], i) -> Optional[tuple]:
    """``draws`` (any NamedTuple of tensors, or None) indexed by ``i``
    on the leading axes of every field."""
    return None if draws is None else type(draws)(*(x[i] for x in draws))


REGISTRY = registry_lib.Registry("policy")


def register(name: str):
    """Class decorator: ``@register("my_policy")`` adds a Policy
    subclass under ``name`` (usable as ``SimConfig(policy=name)``)."""
    return REGISTRY.register(name)


def unregister(name: str) -> None:
    REGISTRY.unregister(name)


def available() -> Tuple[str, ...]:
    return REGISTRY.available()


def get_class(name: str) -> Type[Policy]:
    return REGISTRY.get_class(name)


def get(name: str) -> Policy:
    return REGISTRY.get(name)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def sample_ranks(scores: torch.Tensor) -> torch.Tensor:
    """Rank of each of the d_max slots in the candidate ordering, with
    slot 0 (the primary) first: the stable argsort-of-argsort of
    ``jax.random.uniform`` scores with slot 0 set to -1, computed by
    counting (no sort kernel).  Returns int8 ``(..., d_max)``."""
    s = scores.clone()
    s[..., 0] = -1.0
    d_max = s.shape[-1]
    lower = torch.ones(d_max, d_max, dtype=torch.bool,
                       device=s.device).tril(-1)
    a, b = s[..., :, None], s[..., None, :]
    # slot k ranks before slot j when its score is smaller, or equal
    # with k < j (a stable sort keeps ties in slot order)
    before = (b < a) | ((b == a) & lower)
    return before.sum(-1).to(torch.int8)


def sample_candidates(rng, feas: torch.Tensor, d) -> torch.Tensor:
    """Mark which of the d_max feasible slots are sampled (size-d subset).

    Slot 0 (the primary) is always in S; the remaining d-1 picks are a
    uniform subset of slots 1..d_max-1 via random ranking -- the same
    draw as the reference's ``sample_candidates(rng, feas, d)``."""
    scores = prng.uniform(rng, tuple(feas.shape))
    return sample_ranks(scores) < d
