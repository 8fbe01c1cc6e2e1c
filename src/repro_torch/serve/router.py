"""MIDAS serving-request router: the paper's policy at the replica
level.

The counterpart of ``repro/serve/router.py``, in plain Python and
numpy.  Sessions are consistent-hashed to replica groups (KV-cache
affinity is namespace locality); a new request may steer within the
feasible replica set by power-of-d on the stale queue view under the
Δ_L margin, pinned for ``pin_ms`` (a migrated session implies a prefix
re-prefill, so flapping is expensive); a leaky bucket caps aggregate
steering at ``f_max`` over the last second; a cooperative prefix cache
with lease invalidation serves repeated prefixes at the router tier.
Feasible sets come from :func:`repro_torch.core.hashring.np_hash2`,
bitwise the reference's ``hash2``, so both routers decide alike.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core.hashring import np_hash2


@dataclasses.dataclass
class Replica:
    queue_len: float = 0.0
    ewma_queue: float = 0.0
    p50_ms: float = 0.0
    busy_until: float = 0.0


class RouterStats(NamedTuple):
    routed: int
    steered: int
    cache_hits: int


class MidasRouter:
    def __init__(self, replicas: int, *, d: int = 2, delta_l: float = 2.0,
                 f_max: float = 0.25, pin_ms: float = 300.0,
                 alpha: float = 0.2, policy: str = "midas",
                 prefix_cache: bool = True):
        self.n = replicas
        self.replicas = [Replica() for _ in range(replicas)]
        self.d = d
        self.delta_l = delta_l
        self.f_max = f_max
        self.pin_ms = pin_ms
        self.alpha = alpha
        self.policy = policy
        self.prefix_cache_enabled = prefix_cache
        self._pins: Dict[int, Tuple[int, float]] = {}
        self._prefix_cache: Dict[int, int] = {}  # prefix hash -> version
        self._rr = 0
        self._steered = 0
        self._routed = 0
        self._hits = 0
        self._window: List[Tuple[float, bool]] = []  # (t, steered)

    # -------------------------------------------------------------- helpers
    def _feasible(self, session: int) -> List[int]:
        prim = int(np_hash2(np.uint32(session), np.uint32(5))) % self.n
        feas = [prim]
        i = 1
        while len(feas) < min(4, self.n):
            c = int(np_hash2(np.uint32(session * 131 + i), np.uint32(11))
                    ) % self.n
            if c not in feas:
                feas.append(c)
            i += 1
        return feas

    def ingest_telemetry(self) -> None:
        """Fast-loop EWMA over replica queue lengths (stale view)."""
        for r in self.replicas:
            r.ewma_queue = ((1 - self.alpha) * r.ewma_queue
                            + self.alpha * r.queue_len)

    # ---------------------------------------------------------------- route
    def route(self, session: int, now_ms: float,
              prefix_hash: Optional[int] = None) -> Tuple[int, bool, bool]:
        """Returns (replica, steered, cache_hit)."""
        self._routed += 1
        hit = False
        if self.prefix_cache_enabled and prefix_hash is not None:
            hit = prefix_hash in self._prefix_cache
            if not hit:
                self._prefix_cache[prefix_hash] = 1
            else:
                self._hits += 1

        if self.policy == "round_robin":
            self._rr += 1
            target = self._rr % self.n
            self.replicas[target].queue_len += 0 if hit else 1
            return target, False, hit

        feas = self._feasible(session)
        prim = feas[0]
        pin = self._pins.get(session)
        if pin is not None and pin[1] > now_ms:
            target = pin[0]
            self.replicas[target].queue_len += 0 if hit else 1
            return target, False, hit

        target, steered = prim, False
        if self.policy == "midas" and len(feas) > 1:
            cands = feas[1:self.d] if self.d > 1 else []

            def q(i):
                return self.replicas[i].ewma_queue

            ok = [c for c in cands if q(c) <= q(prim) - self.delta_l]
            # leaky bucket over the last 1 s window
            self._window = [(t, s) for (t, s) in self._window
                            if t > now_ms - 1000.0]
            steers = sum(1 for _, s in self._window if s)
            allowed = steers + 1 <= self.f_max * (len(self._window) + 1)
            if ok and allowed:
                target = min(ok, key=q)
                steered = True
                self._steered += 1
                self._pins[session] = (target, now_ms + self.pin_ms)
            self._window.append((now_ms, steered))
        self.replicas[target].queue_len += 0 if hit else 1
        return target, steered, hit

    def complete(self, replica: int, n: int = 1) -> None:
        self.replicas[replica].queue_len = max(
            0.0, self.replicas[replica].queue_len - n)

    def invalidate_prefix(self, prefix_hash: int) -> None:
        self._prefix_cache.pop(prefix_hash, None)  # lease-style coherence

    # ---------------------------------------------------------------- stats
    def stats(self) -> RouterStats:
        return RouterStats(self._routed, self._steered, self._hits)

    def queue_dispersion(self) -> float:
        q = np.asarray([r.queue_len for r in self.replicas])
        return float(q.std() / max(q.mean(), 1e-9))
