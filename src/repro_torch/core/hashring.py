"""Consistent hashing with virtual nodes, vectorized in PyTorch.

The ring gives (i) a stable primary placement per key and (ii) the
namespace-feasible set F(r): the next ``d_max`` *distinct* servers
clockwise of the key's position.  Hashes are murmur3-style uint32
mixes; PyTorch has no uint32 multiply, so values live in int64 and
every step masks back to 32 bits (:func:`repro_torch.core.prng.mul32`).

Only the member-free path is ported; membership masks and the per-shard
subrings come with the fault layer.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.prng import MASK, mul32
from repro_torch.kernels.common import resolve_device

_GOLDEN = 0x9E3779B9


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x & MASK
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hash2(a: torch.Tensor, b: int) -> torch.Tensor:
    """Hash a uint32 tensor with a uint32 constant."""
    a = a.to(torch.int64) & MASK
    mb = _np_mix32(np.uint32(b & MASK)).item()
    inner = (mb + _GOLDEN + ((a << 6) & MASK) + (a >> 2)) & MASK
    return mix32(a ^ inner)


class Ring(NamedTuple):
    positions: torch.Tensor  # (m*V,) int64 sorted uint32 ring positions
    owners: torch.Tensor  # (m*V,) int32 owning server per position
    m: int  # number of servers
    V: int  # virtual nodes per server


def _np_mix32(x: np.ndarray) -> np.ndarray:
    """numpy :func:`mix32` (uint32 arithmetic wraps mod 2**32)."""
    x = np.asarray(x, np.uint32).copy()
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def np_hash2(a: np.ndarray, b) -> np.ndarray:
    """numpy :func:`hash2` of uint32 values (bitwise the reference's
    ``hash2``), for host-side callers such as the serving router."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    return _np_mix32(
        a
        ^ (
            _np_mix32(b)
            + np.uint32(_GOLDEN)
            + (a << np.uint32(6))
            + (a >> np.uint32(2))
        )
    )


def _ring_arrays(m: int, V: int, salt: int):
    """The ring in pure numpy; memoization happens in the caller."""
    servers = np.repeat(np.arange(m, dtype=np.uint32), V)
    replicas = np.tile(np.arange(V, dtype=np.uint32), m)
    pos = np_hash2(
        servers * np.uint32(0x10001) + replicas, np.uint32(salt + 1)
    )
    order = np.argsort(pos, kind="stable")
    return pos[order], servers[order].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ring_cached(m: int, V: int, salt: int):
    return _ring_arrays(m, V, salt)


def make_ring(m: int, V: int = 64, salt: int = 0, device=None) -> Ring:
    """The ring on ``device`` (the card when None); the host arrays are
    built once per (m, V, salt)."""
    device = resolve_device(device)
    pos, owners = _ring_cached(int(m), int(V), int(salt))
    return Ring(
        positions=torch.as_tensor(pos.astype(np.int64), device=device),
        owners=torch.as_tensor(owners, device=device),
        m=int(m),
        V=int(V),
    )


def key_position(keys: torch.Tensor, salt: int = 0) -> torch.Tensor:
    return hash2(keys, salt + 7919)


def primary(ring: Ring, keys: torch.Tensor) -> torch.Tensor:
    """Primary server for each key (first owner clockwise)."""
    pos = key_position(keys)
    n = ring.positions.shape[0]
    idx = torch.searchsorted(ring.positions, pos) % n
    return ring.owners[idx]


def feasible_set(
    ring: Ring, keys: torch.Tensor, d_max: int, scan_width: int = 16
) -> torch.Tensor:
    """F(r): the first ``d_max`` distinct servers clockwise of each key.

    Returns (..., d_max) int32; entry 0 is the primary.  Scans
    ``scan_width`` consecutive ring slots, keeps first occurrences, and
    (when the window holds fewer than ``d_max`` distinct owners) pads
    with (primary + i) mod m.  Every op is elementwise in ``keys``, so
    any leading batch axes work: the engine gathers a whole horizon of
    waves in one call.
    """
    n = ring.positions.shape[0]
    pos = key_position(keys)
    base = torch.searchsorted(ring.positions, pos) % n
    offs = torch.arange(scan_width, device=keys.device)
    cand = ring.owners[(base[..., None] + offs) % n]  # (..., W)
    # first-occurrence mask: cand[j] not among cand[:j]
    seen = torch.zeros(cand.shape, dtype=torch.bool, device=keys.device)
    for j in range(1, scan_width):
        seen[..., j] = (cand[..., :j] == cand[..., j : j + 1]).any(-1)
    fresh = ~seen
    rank = torch.cumsum(fresh.to(torch.int32), dim=-1) - 1
    # fresh candidates land in their rank slot; the rest go to a spare
    # column d_max that is cut off (its writes may race; none is kept)
    slot = torch.where(fresh & (rank < d_max), rank, d_max).long()
    out = torch.full(
        cand.shape[:-1] + (d_max + 1,), -1, dtype=torch.int32,
        device=keys.device,
    )
    out.scatter_(-1, slot, cand)
    out = out[..., :d_max]
    pad = (out[..., :1] + torch.arange(d_max, device=keys.device)) % ring.m
    return torch.where(out < 0, pad.to(torch.int32), out)
