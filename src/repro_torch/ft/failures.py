"""Failure detection, straggler scoring and elastic topology plans: the
counterpart of ``repro/ft/failures.py``, host code.

A host is FAILED when silent for longer than ``timeout_s``, a STRAGGLER
when its EWMA step time exceeds ``straggler_factor`` times the median
of the hosts'.  After a failure, data-parallel ranks shrink to the
largest power of two of the survivors.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set

import numpy as np


@dataclasses.dataclass
class HostState:
    last_heartbeat: float
    step_times: List[float] = dataclasses.field(default_factory=list)
    ewma_step: float = 0.0


class FailureDetector:
    """Heartbeat-based failure detection and straggler scoring."""

    def __init__(self, hosts: int, *, timeout_s: float = 10.0,
                 straggler_factor: float = 1.5, alpha: float = 0.2,
                 now: Optional[float] = None):
        # every host starts presumed alive as of ``now`` (injected by
        # tests and simulated time)
        now = now if now is not None else time.monotonic()
        self.hosts: Dict[int, HostState] = {
            h: HostState(last_heartbeat=now) for h in range(hosts)}
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.alpha = alpha

    def heartbeat(self, host: int, step_time_s: Optional[float] = None,
                  now: Optional[float] = None) -> None:
        st = self.hosts[host]
        st.last_heartbeat = now if now is not None else time.monotonic()
        if step_time_s is not None:
            st.ewma_step = ((1 - self.alpha) * st.ewma_step
                            + self.alpha * step_time_s
                            if st.ewma_step else step_time_s)
            st.step_times.append(step_time_s)

    def failed(self, now: Optional[float] = None) -> Set[int]:
        now = now if now is not None else time.monotonic()
        return {h for h, st in self.hosts.items()
                if now - st.last_heartbeat > self.timeout_s}

    def stragglers(self) -> Set[int]:
        ew = [st.ewma_step for st in self.hosts.values() if st.ewma_step]
        if len(ew) < 2:
            return set()
        med = float(np.median(ew))
        return {h for h, st in self.hosts.items()
                if st.ewma_step > self.straggler_factor * med}


def elastic_plan(old_hosts: int, alive: Set[int], *,
                 min_hosts: int = 1) -> Dict[str, object]:
    """The topology after a failure: "abort" below ``min_hosts``
    survivors, else "resume" or "reshard" onto the largest power of two
    of them (``new_dp``), with the dropped hosts."""
    n_alive = len(alive)
    if n_alive < min_hosts:
        return {"action": "abort", "alive": sorted(alive)}
    usable = 1 << (n_alive.bit_length() - 1)
    return {
        "action": "resume" if usable == old_hosts else "reshard",
        "alive": sorted(alive),
        "new_dp": usable,
        "dropped": sorted(set(range(old_hosts)) - alive),
    }
