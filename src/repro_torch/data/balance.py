"""MIDAS shard-to-host balancing for data shards of skewed sizes: the
counterpart of ``repro/data/balance.py``, on the host.

Hosts are the servers, shards the requests keyed by shard id, the load
the bytes assigned: a hashed primary host, steered to the least loaded
of d - 1 hashed alternates when that saves at least ``delta_frac`` of
the mean host load."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.hashring import np_hash2


def _hash(a: int, b: int) -> int:
    """``hash2`` of one uint32 pair, as the reference's host code calls
    it (a one-element array: uint32 arithmetic wraps without warning)."""
    return int(np_hash2(np.array([a], np.uint32), b)[0])


def assign_shards(shard_bytes: Sequence[int], num_hosts: int, *,
                  policy: str = "midas", d: int = 2,
                  delta_frac: float = 0.05) -> List[int]:
    """Host index of each shard, in order, under ``policy``
    ("round_robin", "hash" or "midas")."""
    loads = np.zeros(num_hosts, np.float64)
    out = []
    mean_total = max(sum(shard_bytes) / num_hosts, 1.0)
    for i, nbytes in enumerate(shard_bytes):
        if policy == "round_robin":
            h = i % num_hosts
        else:
            primary = _hash(i, 3) % num_hosts
            h = primary
            if policy == "midas":
                cands = [_hash(i * 31 + j + 1, 7) % num_hosts
                         for j in range(d - 1)]
                best = min(cands, key=lambda c: loads[c])
                if loads[primary] - loads[best] >= delta_frac * mean_total:
                    h = best
        loads[h] += nbytes
        out.append(h)
    return out


def host_load_cv(shard_bytes: Sequence[int], assignment: Sequence[int],
                 num_hosts: int) -> float:
    """Coefficient of variation of the bytes per host."""
    loads = np.zeros(num_hosts, np.float64)
    for b, h in zip(shard_bytes, assignment):
        loads[h] += b
    return float(loads.std() / max(loads.mean(), 1e-9))
