"""Serving example: a real decode loop behind the MIDAS request router,
on the PyTorch port (the counterpart of ``examples/serve_midas.py``).

Eight replica 'servers' (one real model, eight queues) serve
zipf-distributed sessions.  Sessions are consistent-hashed for KV
affinity; hot sessions are steered by power-of-d; the cooperative prefix
cache absorbs repeated prompts.  Runs on the card, or on the CPU with
``--device cpu``, at the smoke config of ``--arch``:

  PYTHONPATH=src python examples_torch/serve_midas.py --requests 64
  PYTHONPATH=src python examples_torch/serve_midas.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch import models
from repro_torch.config import RunConfig, get_smoke_arch
from repro_torch.kernels.common import resolve_device
from repro_torch.serve import MidasRouter
from repro_torch.serve.step import make_serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--decode-len", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_arch(args.arch)
    run = RunConfig(arch=args.arch)
    model = models.init_params(cfg, 0, device=dev)
    serve_step = make_serve_step(cfg, run)
    router = MidasRouter(replicas=args.replicas, d=3, f_max=0.25)

    rng = np.random.default_rng(0)
    max_seq = 64
    caches = {}
    now = 0.0
    for req in range(args.requests):
        session = int(rng.zipf(1.4)) % 16  # hot sessions
        prompt_hash = session % 4  # few distinct prompts
        replica, steered, hit = router.route(session, now,
                                             prefix_hash=prompt_hash)
        if replica not in caches:
            caches[replica] = models.init_decode_cache(
                cfg, 1, max_seq, dtype=torch.float32, device=dev)
        cache = caches[replica]
        token = torch.tensor([[session % cfg.vocab_size]],
                             dtype=torch.int32, device=dev)
        out = []
        for t in range(args.decode_len):
            pos = torch.tensor([t], dtype=torch.int32, device=dev)
            token, cache = serve_step(model, cache, token, pos)
            token = token[:, None]
            out.append(int(token[0, 0]))
        caches[replica] = cache
        router.complete(replica)
        now += 50.0
        router.ingest_telemetry()
        flag = "steer" if steered else ("hit " if hit else "    ")
        if req < 10 or req % 16 == 0:
            print(f"req {req:3d} session {session:2d} -> replica "
                  f"{replica} [{flag}] tokens={out[:4]}...")
    s = router.stats()
    print(f"\nrouted={s.routed} steered={s.steered} "
          f"prefix_hits={s.cache_hits} "
          f"queue_cv={router.queue_dispersion():.3f}")
    return s


if __name__ == "__main__":
    main()
