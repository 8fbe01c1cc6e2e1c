"""Consistent hashing with virtual nodes, vectorized in PyTorch.

The ring gives (i) a stable primary placement per key and (ii) the
namespace-feasible set F(r): the next ``d_max`` *distinct* servers
clockwise of the key's position.  Hashes are murmur3-style uint32
mixes; PyTorch has no uint32 multiply, so values live in int64 and
every step masks back to 32 bits (:func:`repro_torch.core.prng.mul32`).

Under a membership fault :func:`feasible_set` takes a live mask
(``member=``), and the numpy helpers give the subring primary
(:func:`np_member_primary`) and the per-shard subrings that resolve a
key from one arc of the position space (:func:`np_subring`).
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


def np_key_position(keys: np.ndarray, salt: int = 0) -> np.ndarray:
    """numpy :func:`key_position` (same hash, same salt)."""
    return np_hash2(np.asarray(keys, np.uint32), np.uint32(salt + 7919))


def np_member_primary(
    m: int, V: int, member: np.ndarray, keys: np.ndarray, salt: int = 0
) -> np.ndarray:
    """Primary owner per key under live membership, in numpy.

    The ring without the virtual nodes of dead servers (the subring):
    keys whose live owner is unchanged never move, and with every
    member live this is :func:`primary`.  The fault layer's per-epoch
    owner tables are built from it."""
    member = np.asarray(member, bool)
    if member.shape != (m,):
        raise ValueError(
            f"member mask must have shape ({m},), got {member.shape}"
        )
    if not member.any():
        raise ValueError("membership has no live servers")
    pos, owners = _ring_cached(int(m), int(V), int(salt))
    keep = member[owners]
    pos, owners = pos[keep], owners[keep]
    kp = np_key_position(np.asarray(keys), salt)
    idx = np.searchsorted(pos, kp) % pos.size
    return owners[idx]


# ---------------------------------------------------------------------------
# Per-shard subrings
# ---------------------------------------------------------------------------
#
# The position space [0, 2**32) is cut into ``n_shards`` equal arcs; a
# shard resolves only the keys hashing into its arc, from the ring slots
# inside the arc plus a ``tail`` of wrap-around successors (enough for
# the feasible-set window).  Ownership equals the global ring's.


class Subring(NamedTuple):
    """The slice of a ring owning one arc of the position space."""

    positions: np.ndarray  # (n_arc + tail,) uint32: sorted arc, then
    owners: np.ndarray  # wrap-around successor slots (may re-wrap)
    n_arc: int  # slots whose position lies inside [lo, hi)
    lo: int  # arc start position (inclusive)
    hi: int  # arc end position (exclusive)
    shard: int
    n_shards: int
    m: int
    V: int


def np_key_shard(
    keys: np.ndarray, n_shards: int, salt: int = 0
) -> np.ndarray:
    """Which shard's arc each key's ring position falls in."""
    q = np_key_position(np.asarray(keys), salt).astype(np.uint64)
    return (q * np.uint64(n_shards) >> np.uint64(32)).astype(np.int32)


def np_subring(
    m: int,
    V: int,
    shard: int,
    n_shards: int,
    salt: int = 0,
    tail: int = 16,
) -> Subring:
    """Shard ``shard`` of an ``n_shards``-way ring partition; ``tail``
    successor slots past the arc (at least the intended scan width)."""
    if not 0 <= shard < n_shards:
        raise ValueError(
            f"shard must be in [0, {n_shards}), got {shard}"
        )
    pos, owners = _ring_cached(int(m), int(V), int(salt))
    n = pos.size
    lo = (shard * (1 << 32)) // n_shards
    hi = ((shard + 1) * (1 << 32)) // n_shards
    start = int(np.searchsorted(pos, np.uint32(lo), side="left"))
    end = (
        n
        if hi == (1 << 32)
        else int(np.searchsorted(pos, np.uint32(hi), side="left"))
    )
    idx = np.arange(start, end + tail) % n
    return Subring(
        positions=pos[idx],
        owners=owners[idx],
        n_arc=end - start,
        lo=lo,
        hi=hi,
        shard=shard,
        n_shards=n_shards,
        m=m,
        V=V,
    )


def np_subring_primary(
    sub: Subring, keys: np.ndarray, salt: int = 0
) -> np.ndarray:
    """Primary owner per key from the subring alone; every key must hash
    into the subring's arc (route with :func:`np_key_shard` first)."""
    kp = np_key_position(np.asarray(keys), salt)
    if kp.size and (
        (kp.astype(np.uint64) < sub.lo).any()
        or (kp.astype(np.uint64) >= sub.hi).any()
    ):
        raise ValueError(
            f"keys outside shard {sub.shard}/{sub.n_shards}'s arc; "
            f"route with np_key_shard first"
        )
    # past the arc's last slot a key falls through to the first
    # wrap-around successor (local index n_arc)
    li = np.searchsorted(sub.positions[: sub.n_arc], kp)
    return sub.owners[li]


def np_subring_feasible(
    sub: Subring, keys: np.ndarray, d_max: int, scan_width: int = 16,
    salt: int = 0,
) -> np.ndarray:
    """F(r) from the subring alone: the numpy :func:`feasible_set`
    (member-free) for keys in the shard's arc.  Needs a tail of at
    least ``scan_width`` slots."""
    if sub.positions.size - sub.n_arc < scan_width:
        raise ValueError(
            f"subring tail {sub.positions.size - sub.n_arc} < "
            f"scan_width {scan_width}; rebuild with a larger tail"
        )
    kp = np_key_position(np.asarray(keys), salt)
    li = np.searchsorted(sub.positions[: sub.n_arc], kp)
    cand = sub.owners[li[..., None] + np.arange(scan_width)]  # (..., W)
    eq = cand[..., None, :] == cand[..., :, None]
    lower = np.tril(np.ones((scan_width, scan_width), bool), k=-1)
    fresh = ~np.any(eq & lower, axis=-1)
    rank = np.where(fresh, np.cumsum(fresh, axis=-1) - 1, scan_width)
    take = rank[..., None] == np.arange(d_max)
    out = np.max(
        np.where(take, cand[..., :, None], np.int32(-1)), axis=-2
    )
    pad = (out[..., :1] + np.arange(d_max, dtype=np.int32)) % sub.m
    return np.where(out < 0, pad, out).astype(np.int32)


def _live_fallback(member: torch.Tensor, d_max: int) -> torch.Tensor:
    """(m, d_max) int32: row p holds the first ``d_max`` live servers
    along (p + i) mod m, the first one repeated when fewer are live."""
    m = member.shape[0]
    dev = member.device
    ar = torch.arange(m, device=dev)
    rot = (ar[:, None] + ar[None, :]) % m  # (m, m)
    liv = member[rot]
    lrank = torch.cumsum(liv.to(torch.int32), dim=-1) - 1
    slot = torch.where(liv & (lrank < d_max), lrank, d_max).long()
    fb = torch.full((m, d_max + 1), -1, dtype=torch.int32, device=dev)
    fb.scatter_(-1, slot, rot.to(torch.int32))
    fb = fb[:, :d_max]
    return torch.where(fb < 0, fb[:, :1], fb)


def feasible_set(
    ring: Ring,
    keys: torch.Tensor,
    d_max: int,
    scan_width: int = 16,
    member=None,
) -> torch.Tensor:
    """F(r): the first ``d_max`` distinct servers clockwise of each key.

    Returns (..., d_max) int32; entry 0 is the primary.  Scans
    ``scan_width`` consecutive ring slots, keeps first occurrences, and
    (when the window holds fewer than ``d_max`` distinct owners) pads
    with (primary + i) mod m.  Every op is elementwise in ``keys``, so
    any leading batch axes work: the engine gathers a whole horizon of
    waves in one call.

    ``member`` ((m,) bool tensor, at least one True) restricts F(r) to
    live servers: dead owners are skipped by the first-occurrence scan
    as if their virtual nodes had left the ring, so entry 0 is the
    subring primary (:func:`np_member_primary`) whenever a live owner
    lies in the window (the fault layer widens ``scan_width`` for it).
    The pad then walks (raw primary + i) mod m and keeps the first live
    servers; with fewer live servers than ``d_max`` it repeats the
    first.  With every member live this is the member-free result.
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
    if member is not None:
        # dead owners neither claim a rank nor appear in the output
        fresh = fresh & member[cand.long()]
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
    if member is None:
        pad = (out[..., :1] + torch.arange(d_max, device=keys.device)) \
            % ring.m
        return torch.where(out < 0, pad.to(torch.int32), out)
    # the live pad depends on the raw primary alone: one (m, d_max) table
    fb = _live_fallback(member, d_max)[cand[..., 0].long()]
    return torch.where(out < 0, fb, out)
