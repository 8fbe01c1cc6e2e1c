#!/usr/bin/env python3
"""How far the order of the SSM scan's sums moves falcon-mamba's logits,
on one CUDA card.

Run from the repository root:

    python3 benchmarks_torch/scan_order.py [--arch falcon-mamba-7b]
        [--prompt-len 512]

It builds ``--arch`` at full width and depth with random weights from
seed 0 (``chip_smoke.py``'s phase 8) and runs ``models.forward`` on one
random prompt three ways, which differ only in the selective scan:
the CUDA ``chunk_scan`` (sequential in each chunk, ``__expf``), the
plain chunked scan (a log-step scan over each 128-step chunk) and the
plain sequential oracle (one chunk as long as the prompt).  It prints
the largest logit difference of each pair, absolute and relative to
1 + |logit|, and the logits' largest magnitude, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import SERVE  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--prompt-len", type=int, default=SERVE["prompt_len"])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("scan_order: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import models
    from repro_torch.config import get_arch
    from repro_torch.kernels.ssm_scan import ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"[s] card: {card}; torch {torch.__version__}")
    cfg = get_arch(args.arch)
    model = models.init_params(cfg, SERVE["seed"], device="cuda")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (1, args.prompt_len), generator=g,
                                     dtype=torch.int32).cuda()}
    chunked = ops.selective_scan
    logits = {}
    for name, impl, chunk in (("kernel", "cuda", 128),
                              ("plain chunked", "ref", 128),
                              ("plain sequential", "ref",
                               args.prompt_len)):
        # the Mamba layer calls ops.selective_scan with its default
        # chunk; the sequential oracle runs when the prompt fits one
        ops.selective_scan = (
            lambda *a, _c=chunk, **kw: chunked(*a, **dict(kw, chunk=_c)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[name] = models.forward(model, batch, impl=impl).float()
        torch.cuda.synchronize()
        print(f"[s] {name}: forward of {args.prompt_len} tokens in "
              f"{time.perf_counter() - t0:.2f} s")
    ops.selective_scan = chunked
    names = list(logits)
    top = max(lg.abs().max().item() for lg in logits.values())
    print(f"[s] {cfg.name}, {cfg.num_layers} layers: largest |logit| "
          f"{top:.4g}")
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            diff = (logits[a] - logits[b]).abs()
            rel = (diff / (1 + logits[b].abs())).max().item()
            print(f"[s] {a} vs {b}: max |diff| {diff.max().item():.4g}, "
                  f"max |diff| / (1 + |logit|) {rel:.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
