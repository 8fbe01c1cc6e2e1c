"""Cooperative metadata cache with leases / invalidations / adaptive TTLs.

Semantics (paper §IV-C):
  * only read-mostly ops (lookup/getattr/readdir) are cacheable;
  * an entry is served only within its validity horizon -- lease expiry,
    explicit invalidation, or adaptive TTL; never past it;
  * coherence modes:
      - "lease"         -- writes invalidate proxy entries immediately;
                           entries otherwise live until lease expiry.
      - "ttl_aggregate" -- one hazard estimator for the whole class,
                           slow-loop tuned: ĥ ← (1−β)·ĥ + β·rate,
                           TTL = −ln(1−p*)/ĥ, shrunk ×γ when the write
                           fraction exceeds W_high, floored at one RTT.
      - "ttl_per_key"   -- the same hazard formula applied per key,
                           ĥ_k ← (1−β)ĥ_k + β/Δt_k at each write of k,
                           TTL_k set at install time.

Write-pressure guard: when the write-mix signal (:func:`write_pressure`)
exceeds ``W_HIGH``, misses are served through without installing, and
counted in ``CacheState.bypasses``.  Under a membership fault the guard
also holds while the detected live fraction (``avail``) is below
``AVAIL_FULL``, and :func:`remap_invalidate` drops the entries whose
ring owner changed at an epoch flip.

This is the converged shared table (the Δ=0 gossip limit); the proxy
fleet of :mod:`repro_torch.core.fleet` keeps one and derives each
proxy's view from it.  The five (N,) per-key tables are updated IN
PLACE: at N = 10**6 a functional copy per tick would move more bytes
than the tick's whole work.  Every scatter masks its dropped rows
instead of aiming them at the reference's out-of-bounds sentinel N
(:mod:`repro_torch.core.xla`).  Repeated keys in
one batch write equal values in every ``set`` scatter here (each value
depends only on the key and the table before the scatter), except the
version bump, which counts every repeat.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.faults.base import AVAIL_FULL
from repro_torch.core.xla import div, fma, set_last

BETA = 0.1
GAMMA = 0.5
W_HIGH = 0.3
P_STAR = 1e-4
TTL_CAP_MS = 60_000.0
GUARD_MIN_EVENTS = 64.0
MODES = ("lease", "ttl_aggregate", "ttl_per_key")


class CacheState(NamedTuple):
    expiry_ms: torch.Tensor       # (N,) float32 absolute expiry time
    cached_version: torch.Tensor  # (N,) int32 version stored at insert
    global_version: torch.Tensor  # (N,) int32 authoritative version
    last_write_ms: torch.Tensor   # (N,) float32 last write time per key
    key_hazard: torch.Tensor      # (N,) float32 per-key ĥ (1/ms)
    ttl_ms: torch.Tensor          # () float32 aggregate adaptive TTL
    hazard: torch.Tensor          # () float32 aggregate ĥ
    write_frac: torch.Tensor      # () float32 EWMA of write mix W_c
    win_writes: torch.Tensor      # () float32 slow-window writes
    win_reads: torch.Tensor       # () float32 slow-window reads
    hits: torch.Tensor            # () int32
    misses: torch.Tensor          # () int32
    stale_serves: torch.Tensor    # () int32
    bypasses: torch.Tensor        # () int32 installs skipped by the guard


class BatchEffects(NamedTuple):
    """Per-request effect flags of one :func:`apply_batch` tick -- the
    single source the shared table's counters and the fleet's gossip
    events and per-proxy counters are derived from."""

    invalidated: torch.Tensor  # (R,) bool rows that invalidate their key
    installed: torch.Tensor    # (R,) bool rows that install their key
    miss: torch.Tensor         # (R,) bool valid read misses
    bypassed: torch.Tensor     # (R,) bool misses the guard served through


def init_cache(
    N: int, ttl_init_ms: float = 100.0, device=None
) -> CacheState:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return CacheState(
        expiry_ms=torch.zeros((N,), **f32),
        cached_version=torch.full((N,), -1, **i32),
        global_version=torch.zeros((N,), **i32),
        last_write_ms=torch.full((N,), -1.0, **f32),
        key_hazard=torch.zeros((N,), **f32),
        ttl_ms=torch.tensor(ttl_init_ms, **f32),
        hazard=torch.tensor(1e-6, **f32),
        write_frac=torch.zeros((), **f32),
        win_writes=torch.zeros((), **f32),
        win_reads=torch.zeros((), **f32),
        hits=torch.zeros((), **i32),
        misses=torch.zeros((), **i32),
        stale_serves=torch.zeros((), **i32),
        bypasses=torch.zeros((), **i32),
    )


def _neg_log1p(p_star: float) -> float:
    """−log1p(−p*) rounded to float32, as the reference computes it."""
    return float(-np.log1p(np.float32(-p_star)))


def write_pressure(cache: CacheState) -> torch.Tensor:
    """Write-mix signal the install guard compares against ``W_HIGH``:
    the slow-loop EWMA, or the live window's mix once it holds
    ``GUARD_MIN_EVENTS`` events, whichever is higher."""
    n = cache.win_writes + cache.win_reads
    wf_window = cache.win_writes / torch.clamp(n, min=1.0)
    live = torch.where(n >= GUARD_MIN_EVENTS, wf_window, 0.0)
    return torch.maximum(cache.write_frac, live)


def classify(
    expiry_view: torch.Tensor,
    version_view: torch.Tensor,
    gv_view: torch.Tensor,
    mask: torch.Tensor,
    is_write: torch.Tensor,
    now_ms: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Classify one tick's requests against a view of the table.
    Returns ``(valid, hit, stale)`` bool vectors."""
    valid = mask & ~is_write
    live = (expiry_view > now_ms) & (version_view >= 0)
    hit = valid & live
    stale = hit & (version_view < gv_view)
    return valid, hit, stale


def apply_batch(
    cache: CacheState,
    keys: torch.Tensor,
    mask: torch.Tensor,
    is_write: torch.Tensor,
    hit: torch.Tensor,
    stale: torch.Tensor,
    now_ms: torch.Tensor,
    *,
    mode: str = "lease",
    lease_ms: float = 5000.0,
    rtt_ms: float = 2.0,
    p_star: float = P_STAR,
    avail: Optional[torch.Tensor] = None,
) -> Tuple[CacheState, BatchEffects]:
    """Apply one tick's effects to the table, given hit flags.

    Writes always reach the server: they bump the authoritative version,
    feed the hazard estimators and, in lease mode, invalidate the entry.
    Misses install an entry with the mode's validity horizon unless the
    write-pressure guard is active, or ``avail`` (() float32, the fault
    layer's detected live fraction) is below ``AVAIL_FULL``: entries
    installed against a shrunken ring would be invalidated at the next
    epoch flip.  ``keys`` is int64 in [0, N).
    Returns ``(new_cache, effects)``: the rows that invalidated or
    installed their key (the fleet's gossip events) and the miss and
    bypass flags the counters count.
    """
    if mode not in MODES:
        raise ValueError(
            f"unknown cache_mode {mode!r}; available: {', '.join(MODES)}"
        )
    valid = mask & ~is_write

    # --- writes: version bump + hazard update (+ lease invalidation) -----
    w = is_write & mask
    # a key written twice in one tick is bumped twice
    cache.global_version.index_put_(
        (keys,), w.to(torch.int32), accumulate=True
    )
    if mode == "ttl_per_key":
        last = cache.last_write_ms[keys]
        dt = torch.clamp(now_ms - last, min=1.0)
        seen = last >= 0.0
        decayed = fma(1.0 - BETA, cache.key_hazard[keys], div(BETA, dt))
        upd = torch.where(seen, decayed, 1.0 / torch.clamp(dt, min=1.0))
        set_last(cache.key_hazard, keys, upd, w)
        set_last(cache.last_write_ms, keys, now_ms, w)
    if mode == "lease":
        # immediate invalidation at the (converged) proxy table
        set_last(cache.expiry_ms, keys, 0.0, w)

    # --- misses install the entry with the mode's validity horizon -------
    # ... unless the write-pressure guard trips: serve-through, no install
    miss = valid & ~hit
    bypass = write_pressure(cache) > W_HIGH
    if avail is not None:
        bypass = bypass | (avail < AVAIL_FULL)
    install = miss & ~bypass
    if mode == "lease":
        expiry = now_ms + lease_ms
    elif mode == "ttl_aggregate":
        expiry = now_ms + cache.ttl_ms
    else:  # ttl_per_key
        # per-key hazard when observed, the class hazard as the
        # conservative prior for keys with no write history yet
        h = torch.maximum(
            cache.key_hazard[keys], torch.clamp(cache.hazard, min=1e-9)
        )
        ttl_k = torch.clamp(div(_neg_log1p(p_star), h), rtt_ms, TTL_CAP_MS)
        expiry = now_ms + ttl_k
    set_last(cache.expiry_ms, keys, expiry, install)
    set_last(
        cache.cached_version, keys, cache.global_version[keys], install
    )

    def count(flags):
        return flags.sum().to(torch.int32)

    bypassed = miss & bypass
    new = cache._replace(
        win_writes=cache.win_writes + w.sum(),
        win_reads=cache.win_reads + valid.sum(),
        hits=cache.hits + count(hit),
        misses=cache.misses + count(miss),
        stale_serves=cache.stale_serves + count(stale),
        bypasses=cache.bypasses + count(bypassed),
    )
    # TTL modes invalidate nothing: their entries expire
    invalidated = w if mode == "lease" else torch.zeros_like(w)
    return new, BatchEffects(invalidated=invalidated, installed=install,
                             miss=miss, bypassed=bypassed)


def lookup_batch(
    cache: CacheState,
    keys: torch.Tensor,
    mask: torch.Tensor,
    is_write: torch.Tensor,
    now_ms: torch.Tensor,
    *,
    mode: str = "lease",
    lease_ms: float = 5000.0,
    rtt_ms: float = 2.0,
    p_star: float = P_STAR,
    avail: Optional[torch.Tensor] = None,
) -> Tuple[CacheState, torch.Tensor]:
    """Process one tick of requests against the shared table.

    Reads hitting a valid entry are served at the proxy (no server
    load).  ``avail`` feeds the availability install guard (see
    :func:`apply_batch`).  Returns ``(new_cache, served_locally: (R,)
    bool)``.
    """
    _, hit, stale = classify(
        cache.expiry_ms[keys],
        cache.cached_version[keys],
        cache.global_version[keys],
        mask,
        is_write,
        now_ms,
    )
    new, _ = apply_batch(
        cache, keys, mask, is_write, hit, stale, now_ms,
        mode=mode, lease_ms=lease_ms, rtt_ms=rtt_ms, p_star=p_star,
        avail=avail,
    )
    return new, hit


def remap_invalidate(cache: CacheState, moved: torch.Tensor) -> CacheState:
    """Drop every entry whose ring owner just changed (``moved``: (N,)
    bool from the fault layer's per-epoch owner diff), IN PLACE: its
    expiry is zeroed (never live), so the next read revalidates at the
    new owner.  Entries whose owner did not move are untouched."""
    cache.expiry_ms.masked_fill_(moved, 0.0)
    return cache


def slow_update(
    cache: CacheState,
    window_ms: float,
    rtt_ms: float,
    lease_remaining_ms: float = float("inf"),
    p_star: float = P_STAR,
    ttl_scale=1.0,
) -> CacheState:
    """T_slow retune of the aggregate TTL from the hazard estimator,
    scaled by the controller's ``ttl_scale`` and floored at one RTT."""
    n_cached = torch.clamp((cache.cached_version >= 0).sum(), min=1)
    per_entry = cache.win_writes / n_cached.to(torch.float32)
    # ĥ ← (1−β)·ĥ + β·(per_entry / window): the reference compiler folds
    # the two constants into one factor, and so does this line
    beta_rate = per_entry * float(np.float32(BETA) / np.float32(window_ms))
    hazard = fma(1.0 - BETA, cache.hazard, beta_rate)
    hazard = torch.clamp(hazard, min=1e-9)
    ttl = div(_neg_log1p(p_star), hazard)
    ttl = torch.clamp(ttl, max=lease_remaining_ms)
    n_events = torch.clamp(cache.win_writes + cache.win_reads, min=1.0)
    wf = cache.win_writes / n_events
    write_frac = fma(1.0 - BETA, cache.write_frac, BETA * wf)
    ttl = torch.where(write_frac > W_HIGH, ttl * GAMMA, ttl)
    ttl = ttl * ttl_scale  # controller slow-loop retune (Knobs.ttl_scale)
    ttl = torch.clamp(ttl, rtt_ms, TTL_CAP_MS)  # transport floor
    zf = torch.zeros_like(cache.win_writes)
    return cache._replace(
        ttl_ms=ttl,
        hazard=hazard,
        write_frac=write_frac,
        win_writes=zf,
        win_reads=zf,
    )
