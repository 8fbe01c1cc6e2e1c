"""End-to-end training on the PyTorch port: data pipeline, train step,
asynchronous MIDAS-scheduled checkpoints, kill and resume (the
counterpart of ``examples/train_lm.py``).

The default is SmolLM-360M's reduced (smoke) config for a few hundred
steps; ``--hundred-m`` scales it to about 100M parameters, and
``--full-config`` trains the published arch on the card where its
training state fits.  On the card, or on the CPU with ``--device cpu``;
re-run with the same ``--ckpt-dir`` to resume:

  PYTHONPATH=src python examples_torch/train_lm.py --steps 300 --ckpt-dir DIR
  PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 20
"""

import argparse
import dataclasses
import tempfile

from repro_torch.config import RunConfig, get_arch, get_smoke_arch
from repro_torch.launch.train import check_fits
from repro_torch.kernels.common import resolve_device
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--hundred-m", action="store_true",
                    help="scale the smoke config up to ~100M params")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when omitted")
    args = ap.parse_args(argv)

    if args.full_config:
        cfg = get_arch(args.arch)
    else:
        cfg = get_smoke_arch(args.arch)
        if args.hundred_m:
            # ~100M llama-family: 12 x 768 with the arch's own flavor
            cfg = dataclasses.replace(
                cfg, num_layers=12, d_model=768, num_heads=12,
                num_kv_heads=4, d_ff=2048, head_dim=64, vocab_size=32000)
    device = resolve_device(args.device)
    run = RunConfig(arch=args.arch)
    check_fits(cfg, run.optimizer, device)
    print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
          f"steps={args.steps} device={device}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        tc = TrainerConfig(steps=args.steps, batch=args.batch,
                           seq=args.seq, ckpt_dir=ckpt_dir, ckpt_every=100,
                           log_every=10)
        trainer = Trainer(cfg, run, tc, device=device)
        try:
            state = trainer.train()
        finally:
            trainer.close()
        print(f"finished at step {int(state.step)}; checkpoints in "
              f"{ckpt_dir}" + (" (re-run to resume)" if args.ckpt_dir
                               else " (temporary, removed)"))


if __name__ == "__main__":
    main()
