"""Deterministic, seekable data pipeline: the counterpart of
``repro/data/pipeline.py``.

``batch_at(step)`` is a pure function of (seed, step, host) and draws
the reference's numbers from the same numpy generator, so a batch is
bit for bit the reference's and a resumed run replays the identical
stream.  Batches are numpy arrays on the host; the trainer moves them
to its device.  A background thread prefetches them.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.config import ArchConfig


class SyntheticLM:
    """Deterministic synthetic token stream (hash-based, O(1) seek)."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, *,
                 seed: int = 0, host: int = 0, num_hosts: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.host = host
        self.num_hosts = num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Audio: ``frames`` (B, S, d_model) float32 N(0, 0.02) and
        ``labels`` (B, S) int32; vision: ``tokens`` (B, S - P) and
        ``patches`` (B, P, d_model); else ``tokens`` (B, S), a mildly
        Zipfian stream (exponent 1.3) modulo the vocabulary."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host)
        cfg = self.cfg
        if cfg.frontend == "audio_frames":
            return {
                "frames": rng.normal(0, 0.02, (self.batch, self.seq,
                                               cfg.d_model)
                                     ).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (self.batch, self.seq)
                                       ).astype(np.int32),
            }
        if cfg.frontend == "vlm_patches":
            P = cfg.frontend_tokens
            return {
                "tokens": rng.integers(0, cfg.vocab_size,
                                       (self.batch, self.seq - P)
                                       ).astype(np.int32),
                "patches": rng.normal(0, 0.02, (self.batch, P, cfg.d_model)
                                      ).astype(np.float32),
            }
        z = rng.zipf(1.3, (self.batch, self.seq))
        return {"tokens": (z % cfg.vocab_size).astype(np.int32)}


class Prefetcher:
    """Background prefetch with a bounded queue; restart-exact through
    ``start_step``.  Iterating yields (step, batch); ``close`` stops the
    thread."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        self._t.join()
