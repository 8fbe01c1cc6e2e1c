"""Training launcher: the counterpart of ``repro/launch/train.py``, with
its flags, on one card (or the CPU with ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 100 --batch 8 --seq 128 [--full-config] [--ckpt-dir DIR] \\
      [--device cpu]

The default is the reduced (smoke) config; ``--full-config`` trains the
published one where its training state fits the card (SmolLM-360M).  An
arch whose state does not fit one card raises before it allocates:
sharding it over several is ROADMAP §1 item 19.  ``--remat`` defaults
to ``RunConfig``'s policy ("dots_saveable").
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import models
from repro_torch.config import ArchConfig, RunConfig, get_arch, get_smoke_arch
from repro_torch.kernels.common import IMPLS, resolve_device
from repro_torch.train.trainer import Trainer, TrainerConfig

# bytes a parameter's training state takes: the float32 master, its
# gradient and AdamW's two float32 moments (8-bit: one byte each and a
# scale per 256), and its bfloat16 compute copy
STATE_BYTES = {"adamw": 4 + 4 + 8 + 2, "adamw8bit": 4 + 4 + 2 + 2}


def state_bytes(cfg: ArchConfig, optimizer: str) -> int:
    """Bytes of ``cfg``'s training state (weights, gradients, optimizer
    state, compute copy), activations aside."""
    n = sum(p.numel() for p in models.Model(cfg, device="meta").parameters())
    return n * STATE_BYTES[optimizer]


def check_fits(cfg: ArchConfig, optimizer: str, device) -> None:
    """Raise when ``cfg``'s training state would not fit the card
    (activations aside) instead of running out of memory mid-step."""
    if device.type != "cuda":
        return
    need = state_bytes(cfg, optimizer)
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        raise NotImplementedError(
            f"{cfg.name}: its training state takes {need / 1e9:.1f} GB, "
            f"more than one card's {have / 1e9:.1f} GB; sharding it over "
            f"several cards is ROADMAP §1 item 19"
        )


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` (the command line when None), train, print the
    final step; returns (the trainer, whose ``history`` holds each
    step's metrics, and the final ``TrainState``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full-config", action="store_true",
                    help="the published arch (on one card where its "
                         "training state fits); default the reduced "
                         "smoke config")
    ap.add_argument("--remat", default=RunConfig.remat_policy)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adamw8bit"])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when omitted")
    ap.add_argument("--impl", default="auto", choices=IMPLS,
                    help="the model's kernels (ref: the plain versions)")
    args = ap.parse_args(argv)

    cfg = (get_arch(args.arch) if args.full_config
           else get_smoke_arch(args.arch))
    device = resolve_device(args.device)
    check_fits(cfg, args.optimizer, device)
    run = RunConfig(arch=args.arch, learning_rate=args.lr,
                    remat_policy=args.remat, optimizer=args.optimizer)
    tc = TrainerConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    trainer = Trainer(cfg, run, tc, device=device, impl=args.impl)
    try:
        state = trainer.train()
    finally:
        trainer.close()
    print(f"done at step {int(state.step)}")
    return trainer, state


if __name__ == "__main__":
    main()
