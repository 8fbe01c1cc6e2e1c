"""Checkpoint-storm demo on the PyTorch port (the counterpart of
``examples/checkpoint_storm.py``): a model's training state is dumped
through 4 writer lanes; MIDAS lane scheduling against a static hash
shows the paper's hotspot mitigation end to end, including the restart
from the checkpoint written (crc32 verified).

  PYTHONPATH=src python examples_torch/checkpoint_storm.py
  PYTHONPATH=src python examples_torch/checkpoint_storm.py --device cpu
"""

import argparse
import json
import tempfile
import time

import numpy as np

from repro_torch.ckpt import CheckpointManager
from repro_torch.config import RunConfig, get_smoke_arch
from repro_torch.train.step import init_train_state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dbrx-132b",
                    help="default: an MoE, whose leaf sizes are skewed")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when omitted")
    args = ap.parse_args(argv)
    cfg = get_smoke_arch(args.arch)
    state = init_train_state(cfg, RunConfig(arch=args.arch), 0,
                             device=args.device)

    for policy in ("hash", "midas"):
        with tempfile.TemporaryDirectory() as d:
            cm = CheckpointManager(d, lanes=4, policy=policy)
            t0 = time.monotonic()
            cm.save(1, state)
            dt = time.monotonic() - t0
            manifest = json.loads(
                (cm.root / "step_00000001" / "manifest.json").read_text())
            lanes = np.asarray(manifest["lane_bytes"], np.float64)
            print(f"{policy:6s}: save {dt * 1e3:6.0f} ms  "
                  f"lane_bytes={np.round(lanes / 1e6, 2)}MB  "
                  f"cv={lanes.std() / lanes.mean():.3f}")
            step, _ = cm.restore_latest(state)
            assert step == 1
            print(f"        restored step {step} OK (crc32 verified)")
            cm.close()


if __name__ == "__main__":
    main()
