"""Proxy fleet: P real proxies with gossip-delayed cache coherence.

The shared table of :mod:`repro_torch.core.cache` is the Δ=0 gossip
limit of the paper's cooperative cache.  Here requests are sharded
across ``P`` proxies per tick, and each proxy serves from *its own view*
of the table, where remote events (installs and invalidations gossiped
by other proxies, §IV-C) become visible only ``gossip_ms`` after they
happen (``repro/core/fleet.py``).

Representation, as in the reference:

* ``shared`` -- the converged table, updated every tick by exactly the
  shared model's :func:`repro_torch.core.cache.apply_batch`;
* ``last_event_ms`` / ``last_origin`` -- per-key gossip log: when the
  most recent install or invalidation happened and which proxy
  originated it;
* ``lag_expiry`` / ``lag_version`` -- a (D, N) ring of converged-table
  snapshots, D = ceil(gossip_ms / dt_ms) ticks deep.

Proxy p's view of key k is the fresh converged entry iff p originated
the last event on k or that event is at least ``gossip_ms`` old;
otherwise p sees the lagged snapshot from D ticks ago.  At
``gossip_ms=0`` every view is the converged table and the fleet is the
shared model bit for bit (the Δ=0 contract).  Staleness is counted
against the authoritative ``global_version``, which gossip never lags.

The (N,) tables and the (D, N) ring are updated IN PLACE, as the shared
table's are (at N = 10**6 the ring alone is D × 8 MB).  The gossip log's
scatters take :func:`xla.set_last`'s last-write-wins, invalidations
first and installs after, so an install wins a collision, as the
reference's two scatters give.

Under faults a gossip partition cuts a proxy off from remote events
(``lookup_fleet(partitioned=)``), the availability install guard holds
while membership is degraded (``avail=``), and :func:`remap_invalidate`
drops moved keys from the converged table and every lagged snapshot.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core.xla import set_last
from repro_torch.kernels.common import resolve_device


class FleetState(NamedTuple):
    """Carried state of the proxy fleet."""

    shared: cache_lib.CacheState  # converged table + aggregate counters
    tick: torch.Tensor            # () int32 fleet-local tick counter
    last_event_ms: torch.Tensor   # (N,) float32 time of last gossip event
    last_origin: torch.Tensor     # (N,) int32 proxy that originated it
    lag_expiry: torch.Tensor      # (D, N) float32 snapshot ring buffer
    lag_version: torch.Tensor     # (D, N) int32 snapshot ring buffer
    hits_p: torch.Tensor          # (P,) int32 per-proxy hits
    misses_p: torch.Tensor        # (P,) int32 per-proxy misses
    stale_p: torch.Tensor         # (P,) int32 per-proxy stale serves
    bypasses_p: torch.Tensor      # (P,) int32 per-proxy guard bypasses

    # Aggregate counters mirror the shared-table model bit for bit; the
    # per-proxy vectors expose the divergence the shared model hides.
    @property
    def hits(self) -> torch.Tensor:
        return self.shared.hits

    @property
    def misses(self) -> torch.Tensor:
        return self.shared.misses

    @property
    def stale_serves(self) -> torch.Tensor:
        return self.shared.stale_serves

    @property
    def bypasses(self) -> torch.Tensor:
        return self.shared.bypasses


def delay_ticks(gossip_ms: float, dt_ms: float) -> int:
    """Gossip delay in whole ticks; the ring buffer depth (>= 1)."""
    if gossip_ms < 0:
        raise ValueError(f"gossip_ms must be >= 0, got {gossip_ms}")
    return max(int(math.ceil(gossip_ms / dt_ms)), 1)


def proxy_assign(R: int, P: int, tick: torch.Tensor) -> torch.Tensor:
    """Shard request slots across proxies: slot r → proxy (r + tick) % P,
    ``tick`` the fleet's () int32 counter (the result on its device).

    Workload grids fill slots as a masked prefix, so the modulo spreads
    each tick's live requests across the fleet, and the tick rotation
    decorrelates slot rank from proxy over time."""
    r = torch.arange(R, dtype=torch.int32, device=tick.device)
    return (r + tick) % P


def wave_views(L_hat_p: torch.Tensor, tick: int) -> torch.Tensor:
    """(P, m) telemetry views reordered so row g is the view of the
    proxy serving routing wave g at engine tick ``tick`` (a host int):
    proxy (g + tick) % P, the rotation of :func:`proxy_assign`."""
    P = L_hat_p.shape[0]
    shift = int(tick) % P
    return torch.roll(L_hat_p, -shift, dims=0) if shift else L_hat_p


def init_fleet(
    N: int, P: int, D: int, ttl_init_ms: float = 100.0, device=None
) -> FleetState:
    """An empty fleet on ``device`` (the card when None)."""
    if P <= 0:
        raise ValueError(f"fleet needs P >= 1 proxies, got {P}")
    if D <= 0:
        raise ValueError(f"fleet needs D >= 1 ring-buffer slots, got {D}")
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return FleetState(
        shared=cache_lib.init_cache(N, ttl_init_ms, device=device),
        tick=torch.zeros((), **i32),
        # -inf-like sentinel: "no event yet" is always propagation-old
        last_event_ms=torch.full((N,), -1e30, dtype=torch.float32,
                                 device=device),
        last_origin=torch.full((N,), -1, **i32),
        # empty-cache snapshots: expiry 0 / version -1 == never live
        lag_expiry=torch.zeros((D, N), dtype=torch.float32, device=device),
        lag_version=torch.full((D, N), -1, **i32),
        hits_p=torch.zeros((P,), **i32),
        misses_p=torch.zeros((P,), **i32),
        stale_p=torch.zeros((P,), **i32),
        bypasses_p=torch.zeros((P,), **i32),
    )


def lookup_fleet(
    state: FleetState,
    keys: torch.Tensor,
    mask: torch.Tensor,
    is_write: torch.Tensor,
    proxy: torch.Tensor,
    now_ms: torch.Tensor,
    *,
    mode: str = "lease",
    lease_ms: float = 5000.0,
    rtt_ms: float = 2.0,
    p_star: float = cache_lib.P_STAR,
    gossip_ms: float = 0.0,
    partitioned: Optional[torch.Tensor] = None,
    avail: Optional[torch.Tensor] = None,
) -> Tuple[FleetState, torch.Tensor]:
    """Process one tick of requests, each served by its assigned proxy.

    ``proxy`` maps every request slot to the proxy serving it (see
    :func:`proxy_assign`).  Hits are decided against the serving
    proxy's gossip view; effects land on the converged table via the
    shared model's ``apply_batch``, then this tick's install and
    invalidation events enter the gossip log and the snapshot ring.

    ``partitioned`` ((P,) bool from the fault layer) cuts a proxy off
    from gossip: remote events never become visible to it while it is
    partitioned, so it serves from the lagged snapshot plus its own
    events.  ``avail`` feeds the availability install guard
    (:func:`repro_torch.core.cache.apply_batch`).  Returns
    ``(new_state, served_locally: (R,) bool)``.
    """
    sh = state.shared
    P = state.hits_p.shape[0]
    D, N = state.lag_expiry.shape
    keys = keys.long()
    proxy = proxy.to(torch.int32)

    # --- per-request view: fresh for own/propagated events, else lagged --
    # the ring slot holding the snapshot from D ticks ago, read before
    # this tick overwrites it
    lag_row = (state.tick % D).long() * N + keys
    lag_exp = state.lag_expiry.view(-1)[lag_row]
    lag_ver = state.lag_version.view(-1)[lag_row]
    own = state.last_origin[keys] == proxy
    age = now_ms - state.last_event_ms[keys]
    propagated = age >= float(np.float32(gossip_ms))
    if partitioned is not None:
        propagated = propagated & ~partitioned[proxy.long()]
    fresh = own | propagated
    exp_view = torch.where(fresh, sh.expiry_ms[keys], lag_exp)
    ver_view = torch.where(fresh, sh.cached_version[keys], lag_ver)

    _, hit, stale = cache_lib.classify(
        exp_view, ver_view, sh.global_version[keys], mask, is_write, now_ms
    )

    # --- converged-table effects: identical to the shared model ----------
    new_sh, eff = cache_lib.apply_batch(
        sh, keys, mask, is_write, hit, stale, now_ms,
        mode=mode, lease_ms=lease_ms, rtt_ms=rtt_ms, p_star=p_star,
        avail=avail,
    )

    # --- gossip log: invalidations first, installs win on collision ------
    # (every event writes the same time, so one scatter takes both)
    set_last(state.last_event_ms, keys, now_ms,
             eff.invalidated | eff.installed)
    for flags in (eff.invalidated, eff.installed):
        set_last(state.last_origin, keys, proxy, flags)

    # --- the post-tick snapshot; this slot is re-read at tick + D --------
    slot = (state.tick % D).long().view(1)
    state.lag_expiry.index_copy_(0, slot, new_sh.expiry_ms[None])
    state.lag_version.index_copy_(0, slot, new_sh.cached_version[None])

    # --- per-proxy counters: the effect flags summed onto the proxy axis -
    # (so the per-proxy counters sum to the aggregate ones by construction)
    sink = proxy.long()

    def seg(flags: torch.Tensor) -> torch.Tensor:
        counts = torch.zeros((P,), dtype=torch.int32, device=keys.device)
        return counts.index_put_((sink,), flags.to(torch.int32),
                                 accumulate=True)

    new = state._replace(
        shared=new_sh,
        tick=state.tick + 1,
        hits_p=state.hits_p + seg(hit),
        misses_p=state.misses_p + seg(eff.miss),
        stale_p=state.stale_p + seg(stale),
        bypasses_p=state.bypasses_p + seg(eff.bypassed),
    )
    return new, hit


def remap_invalidate(state: FleetState, moved: torch.Tensor) -> FleetState:
    """Fleet-wide remap invalidation after a membership epoch flip, IN
    PLACE: moved keys are dropped from the converged table
    (:func:`repro_torch.core.cache.remap_invalidate`) and from every
    row of the lag ring, so whichever view a proxy's gossip test
    selects, the entry is never live and no proxy serves an entry whose
    owner changed without revalidating it."""
    cache_lib.remap_invalidate(state.shared, moved)
    state.lag_expiry.masked_fill_(moved[None, :], 0.0)
    return state


def slow_fleet(
    state: FleetState,
    window_ms: float,
    rtt_ms: float,
    lease_remaining_ms: float = float("inf"),
    p_star: float = cache_lib.P_STAR,
    ttl_scale=1.0,
) -> FleetState:
    """T_slow retune: the hazard estimator lives on the converged table
    (server-side aggregates, which gossip does not lag)."""
    shared = cache_lib.slow_update(
        state.shared,
        window_ms,
        rtt_ms,
        lease_remaining_ms,
        p_star,
        ttl_scale=ttl_scale,
    )
    return state._replace(shared=shared)
