"""MIDAS-scheduled checkpoint writer lanes: the counterpart of
``repro/ckpt/midas_writer.py``, host code.

Every leaf write is a request, the writer lanes are the servers: a
consistent-hash primary lane (the crc32 of the leaf's name, so a leaf
keeps its lane from checkpoint to checkpoint) refined by power-of-d over
the lanes' live backlog, steering only when an alternate is at least
``DELTA_L_BYTES`` lighter.  Each lane writes in a thread of its own
(``np.save`` releases the GIL in its IO) and fsyncs each file.
"""

from __future__ import annotations

import os
import queue
import threading
import zlib
from pathlib import Path
from typing import List

import numpy as np

from repro_torch.core.hashring import np_hash2


def _hash(a: int, b: int) -> int:
    """``hash2`` of one uint32 pair, as the reference's host code calls
    it (a one-element array: uint32 arithmetic wraps without warning)."""
    return int(np_hash2(np.array([a], np.uint32), b)[0])

DELTA_L_BYTES = 1 << 20  # steer only when >= 1 MiB lighter


class WriterPool:
    def __init__(self, lanes: int, policy: str = "midas", d: int = 3):
        if policy not in ("midas", "round_robin", "hash"):
            raise ValueError(f"unknown policy {policy!r}; available: "
                             f"midas, round_robin, hash")
        self.n = lanes
        self.policy = policy
        self.d = max(1, min(d, 4))  # the paper's d range
        self._backlog = [0] * lanes  # queued bytes per lane
        self._written = [0] * lanes
        self._rr = 0
        self._queues: List[queue.Queue] = [queue.Queue()
                                           for _ in range(lanes)]
        self._threads = [threading.Thread(target=self._worker, args=(i,),
                                          daemon=True)
                         for i in range(lanes)]
        self._lock = threading.Lock()
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ scheduling
    def assign(self, name: str, nbytes: int) -> int:
        """The lane of a leaf named ``name`` of ``nbytes`` bytes, its
        bytes added to that lane's backlog."""
        if self.policy == "round_robin":
            lane = self._rr % self.n
            self._rr += 1
        else:
            key = zlib.crc32(name.encode())  # deterministic across runs
            primary = _hash(key, 13) % self.n
            lane = primary
            if self.policy == "midas" and self.n > 1:
                with self._lock:
                    alts = [_hash((key + i + 1) & 0xFFFFFFFF, 29)
                            % self.n for i in range(self.d - 1)]
                    best = min(alts, key=lambda a: self._backlog[a])
                    if (self._backlog[primary] - self._backlog[best]
                            >= DELTA_L_BYTES):
                        lane = best
        with self._lock:
            self._backlog[lane] += nbytes
        return lane

    # --------------------------------------------------------------- writing
    def submit(self, lane: int, path: Path, arr: np.ndarray) -> None:
        self._queues[lane].put((path, arr))

    def _worker(self, lane: int) -> None:
        q = self._queues[lane]
        while True:
            item = q.get()
            if item is None:
                q.task_done()
                return
            path, arr = item
            try:
                with open(path, "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())
            finally:
                with self._lock:
                    self._backlog[lane] -= arr.nbytes
                    self._written[lane] += arr.nbytes
                q.task_done()

    def join(self) -> None:
        """Wait until every submitted write is on disk."""
        for q in self._queues:
            q.join()

    def close(self) -> None:
        """Finish the writes and stop the lanes' threads."""
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join()

    def lane_bytes(self) -> List[int]:
        return list(self._written)

    def backlogs(self) -> List[int]:
        """Snapshot of queued-but-unwritten bytes per lane (the live
        load the scheduler steers on)."""
        with self._lock:
            return list(self._backlog)

    def dispersion(self) -> float:
        """Coefficient of variation of the bytes each lane wrote."""
        w = np.asarray(self._written, np.float64)
        if w.mean() <= 0:
            return 0.0
        return float(w.std() / w.mean())
