"""End-to-end training loop: data pipeline, train step, asynchronous
MIDAS-laned checkpoints, restart and resume, with the failure
detector's heartbeat: the counterpart of ``repro/train/trainer.py``.

It runs on the card unless ``device="cpu"``.  A run resumed from its
latest checkpoint replays the same data stream from the checkpoint's
step, so its states are the uninterrupted run's bit for bit (every
kernel of the step is deterministic).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.config import ArchConfig, RunConfig
from repro_torch.convert import tree_from_numpy
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.ft import FailureDetector
from repro_torch.kernels.common import resolve_device
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_lanes: int = 4
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, run: RunConfig, tc: TrainerConfig,
                 log_fn: Callable[[str], None] = print, *, device=None,
                 impl: str = "auto"):
        self.cfg = cfg
        self.run = run
        self.tc = tc
        self.log = log_fn
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, run, impl=impl)
        self.ckpt = (CheckpointManager(tc.ckpt_dir, lanes=tc.ckpt_lanes)
                     if tc.ckpt_dir else None)
        self.detector = FailureDetector(hosts=1)
        self.source = SyntheticLM(cfg, tc.batch, tc.seq, seed=tc.seed)
        # each step's metrics, device tensors (read them after the run)
        self.history: List[Dict[str, torch.Tensor]] = []

    def init_or_resume(self) -> TrainState:
        """A fresh state from ``tc.seed``, or the latest checkpoint's."""
        state = init_train_state(self.cfg, self.run, self.tc.seed,
                                 device=self.device)
        if self.ckpt is not None:
            step, restored = self.ckpt.restore_latest(state)
            if restored is not None:
                self.log(f"[trainer] resumed from checkpoint step {step}")
                return tree_from_numpy(restored, self.device)
        return state

    def train(self, state: Optional[TrainState] = None) -> TrainState:
        """Steps from the state's step up to ``tc.steps``, a log line
        every ``log_every`` steps and a checkpoint every ``ckpt_every``
        (one save in flight at a time; the last waited for)."""
        state = state if state is not None else self.init_or_resume()
        start = int(state.step)
        stream = Prefetcher(self.source, start_step=start)
        pending = None
        try:
            for step, batch in stream:
                if step >= self.tc.steps:
                    break
                batch = {k: torch.as_tensor(v).to(self.device)
                         for k, v in batch.items()}
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, batch)
                dt = time.monotonic() - t0
                self.history.append(metrics)
                self.detector.heartbeat(0, step_time_s=dt)
                if (step + 1) % self.tc.log_every == 0:
                    loss = float(metrics["loss"])
                    self.log(f"[trainer] step {step + 1:5d} "
                             f"loss {loss:.4f} ({dt * 1e3:.0f} ms)"
                             + (f" drop {float(metrics['moe_drop_rate']):.3f}"
                                if "moe_drop_rate" in metrics else ""))
                if (self.ckpt is not None
                        and (step + 1) % self.tc.ckpt_every == 0):
                    if pending is not None:
                        pending.result()  # one in flight at a time
                    pending = self.ckpt.save(step + 1, state,
                                             blocking=False)
            if pending is not None:
                pending.result()
        finally:
            stream.close()
        return state

    def close(self) -> None:
        """Stop the checkpoint thread (saves in flight finish first)."""
        if self.ckpt is not None:
            self.ckpt.close()
