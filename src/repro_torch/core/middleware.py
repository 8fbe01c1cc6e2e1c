"""Middleware pipeline: composable batch stages in front of routing.

The paper frames MIDAS as *middleware* -- stages between incoming
metadata requests and the routing decision.  Each stage sees the tick's
request batch, may absorb requests (serve them at the proxy) by clearing
their mask bits, and carries its own state across ticks.  Stages also
get a slow-loop hook on the paper's T_slow cadence.

``SimConfig.middleware`` is a tuple of registered stage names applied
in order.  The port carries the cooperative cache (``"cache"``) and its
gossip-delayed proxy fleet (``"fleet_cache"``).  Under a fault schedule
each tick's :class:`BatchView` carries the tick's fault context, and on
an epoch flip ``on_fault`` runs before any stage serves.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Type

import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core import fleet as fleet_lib
from repro_torch.core import registry as registry_lib
from repro_torch.core.controllers.base import T_SLOW_MS, Knobs


class BatchView(NamedTuple):
    """One tick's request batch, as seen by a middleware stage."""

    keys: torch.Tensor      # (R,) int64 namespace keys
    mask: torch.Tensor      # (R,) bool validity (may be narrowed upstream)
    is_write: torch.Tensor  # (R,) bool metadata-mutating ops
    now_ms: torch.Tensor    # () float32 tick clock
    # fault context (faults.FaultTickInfo), or None when the run carries
    # no fault schedule: stages read availability and partitions here
    faults: Any = None


def _fault_rows(batch: BatchView) -> Tuple[Optional[torch.Tensor], ...]:
    """(avail, partition) of the batch's fault context, or Nones."""
    fi = batch.faults
    return (None, None) if fi is None else (fi.avail, fi.partition)


class Middleware:
    """Base class for registered pipeline stages.

    ``init(cfg, device) -> state`` builds the stage's carried state.
    ``on_batch(state, batch, cfg) -> (state, mask, absorbed)`` processes
    one tick: the returned mask replaces ``batch.mask`` downstream, and
    ``absorbed`` is the () float32 count served at the proxy.
    ``on_slow(state, cfg, knobs) -> state`` runs on the T_slow cadence.
    ``on_fault(state, info, cfg) -> state`` runs on an epoch-flip tick,
    before ``on_batch``, with the tick's ``faults.FaultTickInfo``.
    """

    name: str = "?"

    def init(self, cfg, device=None) -> Any:
        return ()

    def on_batch(
        self, state: Any, batch: BatchView, cfg
    ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        absorbed = torch.zeros((), dtype=torch.float32,
                               device=batch.mask.device)
        return state, batch.mask, absorbed

    def on_slow(self, state: Any, cfg, knobs: Knobs) -> Any:
        return state

    def on_fault(self, state: Any, info, cfg) -> Any:
        """React to a membership epoch flip (``info.inval`` marks the
        keys whose owner changed) before any request of the new epoch
        is served; the default does nothing."""
        return state


REGISTRY = registry_lib.Registry("middleware")


def register(name: str):
    """Class decorator registering a Middleware stage under ``name``."""
    return REGISTRY.register(name)


def unregister(name: str) -> None:
    REGISTRY.unregister(name)


def available() -> Tuple[str, ...]:
    return REGISTRY.available()


def get_class(name: str) -> Type[Middleware]:
    return REGISTRY.get_class(name)


def get(name: str) -> Middleware:
    return REGISTRY.get(name)


@register("cache")
class CooperativeCache(Middleware):
    """The paper's cooperative metadata cache as a pipeline stage.

    Read hits within the validity horizon are absorbed at the proxy;
    writes always pass through (bumping versions / invalidating leases).
    The slow hook retunes the aggregate TTL from the hazard estimator.
    """

    def init(self, cfg, device=None) -> cache_lib.CacheState:
        return cache_lib.init_cache(cfg.N, device=device)

    def on_batch(self, state: cache_lib.CacheState, batch: BatchView, cfg):
        avail, _ = _fault_rows(batch)
        state, hit = cache_lib.lookup_batch(
            state,
            batch.keys,
            batch.mask,
            batch.is_write,
            batch.now_ms,
            mode=cfg.cache_mode,
            lease_ms=cfg.lease_ms,
            rtt_ms=cfg.rtt_ms,
            p_star=cfg.p_star,
            avail=avail,
        )
        # hits never reach the servers
        return state, batch.mask & ~hit, hit.sum().to(torch.float32)

    def on_fault(self, state: cache_lib.CacheState, info, cfg):
        if info.inval is None:
            return state
        return cache_lib.remap_invalidate(state, info.inval)

    def on_slow(self, state: cache_lib.CacheState, cfg, knobs: Knobs):
        lease = cfg.lease_ms if cfg.cache_mode == "lease" else float("inf")
        return cache_lib.slow_update(
            state,
            T_SLOW_MS,
            cfg.rtt_ms,
            lease,
            cfg.p_star,
            ttl_scale=knobs.ttl_scale,
        )


@register("fleet_cache")
class FleetCache(Middleware):
    """The cooperative cache as ``cfg.P`` real proxies with gossip.

    Requests are sharded across the fleet per tick (slot r → proxy
    (r + tick) % P); each proxy decides hits against its own
    gossip-delayed view (``cfg.gossip_ms`` propagation, see
    :mod:`repro_torch.core.fleet`), while effects land on the converged
    table.  At ``gossip_ms=0`` this stage reproduces ``"cache"`` bit for
    bit -- the Δ=0 equivalence contract.
    """

    def init(self, cfg, device=None) -> fleet_lib.FleetState:
        D = fleet_lib.delay_ticks(cfg.gossip_ms, cfg.dt_ms)
        return fleet_lib.init_fleet(cfg.N, cfg.P, D, device=device)

    def on_batch(self, state: fleet_lib.FleetState, batch: BatchView, cfg):
        R = batch.keys.shape[0]
        proxy = fleet_lib.proxy_assign(R, cfg.P, state.tick)
        avail, partition = _fault_rows(batch)
        state, hit = fleet_lib.lookup_fleet(
            state,
            batch.keys,
            batch.mask,
            batch.is_write,
            proxy,
            batch.now_ms,
            mode=cfg.cache_mode,
            lease_ms=cfg.lease_ms,
            rtt_ms=cfg.rtt_ms,
            p_star=cfg.p_star,
            gossip_ms=cfg.gossip_ms,
            partitioned=partition,
            avail=avail,
        )
        # hits are served by their proxy and never reach the servers
        return state, batch.mask & ~hit, hit.sum().to(torch.float32)

    def on_fault(self, state: fleet_lib.FleetState, info, cfg):
        if info.inval is None:
            return state
        return fleet_lib.remap_invalidate(state, info.inval)

    def on_slow(self, state: fleet_lib.FleetState, cfg, knobs: Knobs):
        lease = cfg.lease_ms if cfg.cache_mode == "lease" else float("inf")
        return fleet_lib.slow_fleet(
            state,
            T_SLOW_MS,
            cfg.rtt_ms,
            lease,
            cfg.p_star,
            ttl_scale=knobs.ttl_scale,
        )
