"""Workload combinators: compose realized grids into new scenarios.

Combinators are pure functions on :class:`Workload` grids, so anything
-- built-ins, trace replays, third-party registrations -- composes with
anything else.  All binary combinators require matching slot width
``R`` and namespace size ``N`` (``WorkloadParams.make`` hands every
component the same ``R``).

``mix`` and ``scale_rate`` draw ``uniform(PRNGKey(seed), shape)`` with
the port's threefry, so on the same input grids they are the
reference's (``repro/core/workloads/combinators.py``) bit for bit.

Conservation contracts:

* ``concat`` -- request counts add; time axes stack.
* ``mix`` -- the Bernoulli selection partitions slots, so
  ``mix(a, b, p, seed=s)`` and ``mix(b, a, p, seed=s)`` together carry
  exactly the requests of ``a`` plus ``b``.
* ``scale_rate`` -- ``factor=1`` is the identity on counts; thinning
  (``factor<1``) only removes; boosting (``factor>1``) replicates the
  tick's own keys, capped at ``R``.
* ``shift_hotset`` -- mask and write flags are untouched; only keys
  move.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.workloads.base import Workload


def _check_compatible(w1: Workload, w2: Workload, op: str) -> None:
    if w1.keys.shape[1] != w2.keys.shape[1]:
        raise ValueError(
            f"{op}: slot widths differ "
            f"({w1.keys.shape[1]} vs {w2.keys.shape[1]})"
        )
    if w1.N != w2.N:
        raise ValueError(
            f"{op}: namespace sizes differ ({w1.N} vs {w2.N})"
        )


def _draw(seed: int, like: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(seed), like.shape)`` on like's
    device."""
    return prng.uniform(prng.PRNGKey(seed, like.device), tuple(like.shape))


def mix(w1: Workload, w2: Workload, p: float, *, seed: int = 0) -> Workload:
    """Per-slot Bernoulli blend: each (tick, slot) cell comes from ``w2``
    with probability ``p``, else from ``w1`` (keys, mask, and write flag
    move together).  Models independent tenants sharing one proxy tier.
    """
    _check_compatible(w1, w2, "mix")
    if w1.keys.shape != w2.keys.shape:
        raise ValueError(
            f"mix: grid shapes differ ({tuple(w1.keys.shape)} vs "
            f"{tuple(w2.keys.shape)})"
        )
    sel = _draw(seed, w1.mask) < float(np.float32(p))
    return Workload(
        keys=torch.where(sel, w2.keys, w1.keys),
        mask=torch.where(sel, w2.mask, w1.mask),
        is_write=torch.where(sel, w2.is_write, w1.is_write),
        name=f"mix({w1.name},{w2.name},{p:g})",
        N=w1.N,
    )


def concat(w1: Workload, w2: Workload) -> Workload:
    """Play ``w1`` then ``w2``: time axes stack, counts add."""
    _check_compatible(w1, w2, "concat")
    return Workload(
        keys=torch.cat([w1.keys, w2.keys], dim=0),
        mask=torch.cat([w1.mask, w2.mask], dim=0),
        is_write=torch.cat([w1.is_write, w2.is_write], dim=0),
        name=f"concat({w1.name},{w2.name})",
        N=w1.N,
    )


def scale_rate(w: Workload, factor: float, *, seed: int = 0) -> Workload:
    """Thin (``factor<1``) or boost (``factor>1``) the request rate.

    Thinning keeps each request independently with probability
    ``factor``.  Boosting replicates the tick's own requests
    (cyclically, preserving the tick's key distribution) into free
    slots, capped at the grid width -- per-tick counts become
    ``min(round(count * factor), R)``, the product and the rounding
    (half to even) in float32 as the reference takes them.
    """
    if factor < 0:
        raise ValueError(f"scale_rate: factor must be >= 0, got {factor}")
    if factor == 1.0:
        return w._replace(name=f"scale_rate({w.name},1)")
    T, R = w.mask.shape
    f32 = float(np.float32(factor))
    if factor < 1.0:
        mask = w.mask & (_draw(seed, w.mask) < f32)
        return Workload(
            keys=w.keys,
            mask=mask,
            is_write=w.is_write & mask,
            name=f"scale_rate({w.name},{factor:g})",
            N=w.N,
        )
    # boost: compact valid slots to a prefix, then replicate cyclically
    order = torch.argsort((~w.mask).to(torch.uint8), dim=1, stable=True)
    keys = w.keys.gather(1, order)
    is_write = w.is_write.gather(1, order)
    counts = w.mask.sum(dim=1)
    target = torch.clamp(torch.round(counts.to(torch.float32) * f32),
                         max=R).to(torch.int64)
    slot = torch.arange(R, device=w.mask.device)[None, :]
    src = slot % torch.clamp(counts, min=1)[:, None]
    mask = slot < target[:, None]
    return Workload(
        keys=keys.gather(1, src),
        mask=mask,
        is_write=is_write.gather(1, src) & mask,
        name=f"scale_rate({w.name},{factor:g})",
        N=w.N,
    )


def shift_hotset(w: Workload, offset: int) -> Workload:
    """Translate every key by ``offset`` (mod N): the same traffic shape
    aimed at a different namespace region, so two tenants' hotspots
    land on different servers."""
    keys = torch.remainder(w.keys.to(torch.int64) + int(offset), w.N)
    return w._replace(
        keys=keys.to(torch.int32),
        name=f"shift_hotset({w.name},{offset})",
    )
