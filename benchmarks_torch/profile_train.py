#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one CUDA card.

Run from the repository root:

    python3 benchmarks_torch/profile_train.py [--remat dots_saveable]
        [--steps 2] [--layers N] [--optimizer adamw]

It trains SmolLM-360M (``chip_smoke.py``'s phase 16) at full width, at
full depth or cut to ``--layers`` layers, with random weights from seed
0, on batch 8 x seq 512 of the synthetic stream at ``RunConfig``'s
defaults (bfloat16 activations, float32 masters) under ``--remat``:
a warm-up step, then ``--steps`` steps under ``torch.profiler``.  It
prints the wall time a step, the device's busy and idle share, kernel
launches, the top device kernels and host ops, and the wall split
into the forward and backward (``value_and_grad``), the clipping and
the AdamW update, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.profile_serve import report  # noqa: E402
from chip_smoke import TRAIN, card_line  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--remat", default="dots_saveable")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--optimizer", default="adamw")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.config import RunConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as tstep

    cfg = get_arch("smollm-360m")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    run = RunConfig(remat_policy=args.remat, optimizer=args.optimizer)
    B, S = TRAIN["batch"], TRAIN["seq"]
    print(card_line())
    print(f"[p] {cfg.name}: {cfg.num_layers} layers, batch {B} x seq {S}, "
          f"remat {args.remat}, {args.optimizer}")
    src = SyntheticLM(cfg, B, S, seed=0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in
                src.batch_at(i).items()} for i in range(args.steps + 1)]
    state = tstep.init_train_state(cfg, run, 0, device="cuda")
    step_fn = tstep.make_train_step(cfg, run)
    state, _ = step_fn(state, batches[0])  # warm-up
    torch.cuda.synchronize()

    # the wall split of one step into its parts
    t0 = time.perf_counter()
    (_, _), grads = tstep.value_and_grad(cfg, run, state.params,
                                         state.moe_state, batches[1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads, _ = opt.clip_by_global_norm(grads, run.grad_clip)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    opt.adamw_update(state.params, grads, state.opt, state.step,
                     lr=run.learning_rate, eight_bit=args.optimizer
                     == "adamw8bit")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"[p] one step's parts: forward + backward {1e3 * (t1 - t0):.1f} "
          f"ms, clipping {1e3 * (t2 - t1):.1f} ms, AdamW "
          f"{1e3 * (t3 - t2):.1f} ms")
    del grads

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            state, _ = step_fn(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"[p] {1e3 * wall / args.steps:.1f} ms a step profiled")
    report(torch, prof, wall, "train step", args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
