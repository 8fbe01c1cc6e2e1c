#!/usr/bin/env python3
"""Where the time of the port's serving path goes, on one CUDA card.

Run from the repository root:

    python3 benchmarks_torch/profile_serve.py [--arch smollm-360m]
        [--decode-steps 32] [--layers N]

It builds ``--arch`` (SmolLM-360M, ``chip_smoke.py``'s phase 6,
falcon-mamba-7b, its phase 8, or qwen3-moe-235b-a22b with ``--layers
4``, its phase 9) at full width, at full depth or cut to ``--layers``
layers, with random weights from seed 0, prefills one 512-token prompt
into a decode cache (a 544-row KV cache, or the SSM state and conv
tail) and runs ``--decode-steps`` greedy decode steps, once unprofiled
(after a warm-up) and once under ``torch.profiler``.
For prefill and for decode it prints the wall time, the device's busy
and idle share, kernel launches, the top device kernels and the top
host ops, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from collections import Counter
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import SERVE  # noqa: E402


def report(torch, prof, wall_s, label, steps):
    """Busy share, kernels by name and host ops of one profiled span."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[p] {label}: the profiler saw no device events")
        return False
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    wall_us = wall_s * 1e6
    print(f"[p] {label} profiled: wall {wall_s * 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), idle "
          f"{100 * (1 - busy_us / wall_us):.1f}%; {len(kernels)} kernels, "
          f"{len(kernels) / steps:.1f} per step")
    by_name, counts = Counter(), Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        counts[e.name] += 1
    print(f"[p] {label} top device kernels (us total, launches, share of "
          f"busy):")
    for name, us in by_name.most_common(12):
        print(f"[p]   {us:9.1f} {counts[name]:6d} {100 * us / busy_us:5.1f}% "
              f"{name[:100]}")
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    ops.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    host_us = sum(e.self_cpu_time_total for e in ops)
    print(f"[p] {label} top host ops (self CPU us, calls, share of aten "
          f"host time {host_us / 1e3:.1f} ms):")
    for e in ops[:10]:
        print(f"[p]   {e.self_cpu_time_total:9.1f} {e.count:6d} "
              f"{100 * e.self_cpu_time_total / host_us:5.1f}% {e.key}")
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--decode-steps", type=int,
                    default=32)  # the serving cell's steps before its cut
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: as "
                         "published)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import models
    from repro_torch.config import get_arch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"[p] card: {card}; torch {torch.__version__}")
    cfg = get_arch(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    t0 = time.perf_counter()
    model = models.init_params(cfg, SERVE["seed"], device="cuda")
    torch.cuda.synchronize()
    print(f"[p] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}; weights made in {time.perf_counter() - t0:.1f} s")
    P, T = SERVE["prompt_len"], args.decode_steps
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, P), generator=g,
                           dtype=torch.int32).cuda()
    positions = torch.arange(P, P + T, dtype=torch.int32, device="cuda")

    def do_prefill():
        lg, cache = models.prefill(model, {"tokens": prompt},
                                   cache_len=P + T)
        cache = {p: {n: a.float() for n, a in c.items()}
                 for p, c in cache.items()}
        tok = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
        return tok.to(torch.int32), cache

    def do_decode(tok, cache):
        for t in range(T):
            lg, cache = models.decode_step(model, cache, tok,
                                           positions[t:t + 1])
            tok = torch.argmax(lg[:, -1].float(), dim=-1)[:, None].to(
                torch.int32)
        return tok

    def span(fn, profiled):
        """(fn(), wall seconds, profiler or None) of one synchronised
        span."""
        ctx = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if profiled \
            else nullcontext()
        with ctx as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return out, wall, prof

    ok = True
    for rep in range(3):  # warm-up, timed, profiled
        (tok, cache), t_pre, prof_p = span(do_prefill, rep == 2)
        _, t_dec, prof_d = span(lambda: do_decode(tok, cache), rep == 2)
        if rep == 1:
            print(f"[p] unprofiled: prefill ({P} tokens) {t_pre * 1e3:.2f} "
                  f"ms; decode {T} steps {t_dec * 1e3:.2f} ms, "
                  f"{t_dec / T * 1e3:.3f} ms per token")
        if rep == 2:
            ok &= report(torch, prof_p, t_pre, "prefill", 1)
            ok &= report(torch, prof_d, t_dec, "decode", T)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
