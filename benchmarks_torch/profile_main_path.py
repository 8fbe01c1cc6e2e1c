#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA card.

Run from the repository root:

    python3 benchmarks_torch/profile_main_path.py [--ticks 50] \
        [--policy {midas,power_of_d,chbl}]

It builds ``chip_smoke.py``'s full-width main path (m=64, N=10**6,
V=64, R=512, ``bursty``, seed 0, the lease-mode cache) under
``--policy`` (midas with its warmup's targets, the baselines with phase
3's fixed ones), runs the first 400 ticks unprofiled, then times the
next ``--ticks`` ticks from copies of the same state: ``REPEATS``
times with a host clock around a synchronised run, once under
``torch.profiler``.  It prints the set-up time of the hoisted horizon
(feasible sets and every threefry draw), host time per tick and ticks/s
of each repeat, the device's busy and idle share over the profiled
window, kernel launches per tick, the top device kernels and the top
host ops, with the card's name and power limit, and last a JSON line
of the same numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import FULL, R_FULL, SEED, T_FULL  # noqa: E402

T_LEAD = 400
REPEATS = 3  # host-clocked runs of the window (host time varies ~2x)


def clone(tree):
    import torch

    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, tuple):
        items = [clone(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--policy", choices=("midas", "power_of_d", "chbl"),
                    default="midas")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import core
    from repro_torch.core import sim

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"[p] card: {card}; torch {torch.__version__}; policy "
          f"{args.policy}")

    cfg = core.SimConfig(policy=args.policy, middleware=("cache",),
                         cache_mode="lease", **FULL)
    wl = core.make_workload("bursty", T=T_FULL, m=cfg.m, seed=SEED,
                            N=cfg.N, R=R_FULL, device="cuda")
    policy = core.policies.get(cfg.policy)
    targets = (sim.warmup(cfg, device="cuda") if policy.adaptive
               else (0.15, 5.0 * cfg.service_ms))

    # the hoisted horizon: feasible sets + all draws of 1200 ticks
    st = sim.init_state(cfg, *targets, device="cuda")
    ring = core.hashring.make_ring(cfg.m, cfg.V, device="cuda")
    for rep in range(2):  # the first pass pays one-time allocations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim._scan_inputs(cfg, ring, policy, st.rng, wl.keys, wl.mask,
                         wl.is_write)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    print(f"[p] hoisted horizon (T={T_FULL}, feasible sets + threefry "
          f"draws): {setup_s * 1e3:.2f} ms")

    st, _ = sim.run_ticks(cfg, st, wl.keys[:T_LEAD], wl.mask[:T_LEAD],
                          wl.is_write[:T_LEAD])
    lo, hi = T_LEAD, T_LEAD + args.ticks
    window = (wl.keys[lo:hi], wl.mask[lo:hi], wl.is_write[lo:hi])

    def run(state):
        return sim.run_ticks(cfg, state, *window, t0=lo)

    run(clone(st))  # warm the allocator at these shapes
    ms_tick = []
    for rep in range(REPEATS):
        state = clone(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        ms_tick.append(plain_s / args.ticks * 1e3)
        print(f"[p] {args.ticks} ticks (incl. their horizon set-up), "
              f"repeat {rep}: {plain_s * 1e3:.2f} ms, {ms_tick[-1]:.3f} "
              f"ms/tick, {args.ticks / plain_s:.1f} ticks/s")

    state = clone(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if not kernels:
        print("[p] the profiler saw no device events")
        return 1
    wall_us = wall_s * 1e6
    print(f"[p] profiled window: wall {wall_s * 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), idle "
          f"{100 * (1 - busy_us / wall_us):.1f}%; {len(kernels)} kernels, "
          f"{len(kernels) / args.ticks:.1f} per tick")
    by_name = Counter()
    counts = Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        counts[e.name] += 1
    print("[p] top device kernels (us total, launches, share of busy):")
    for name, us in by_name.most_common(15):
        print(f"[p]   {us:9.1f} {counts[name]:6d} {100 * us / busy_us:5.1f}% "
              f"{name[:100]}")
    ops = [e for e in prof.key_averages()
           if e.key.startswith("aten::")]
    ops.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    host_us = sum(e.self_cpu_time_total for e in ops)
    print(f"[p] top host ops (self CPU us, calls, share of aten host "
          f"time {host_us / 1e3:.1f} ms):")
    for e in ops[:15]:
        print(f"[p]   {e.self_cpu_time_total:9.1f} {e.count:6d} "
              f"{100 * e.self_cpu_time_total / host_us:5.1f}% {e.key}")
    launches = {}
    for kname in ("route_tick", "route_select"):
        n = sum(c for name, c in counts.items() if kname in name)
        us = sum(u for name, u in by_name.items() if kname in name)
        launches[kname] = n
        print(f"[p] {kname}: {n} launches, {us:.1f} us "
              f"({100 * us / busy_us:.1f}% of device busy time)")
    print(json.dumps({
        "policy": args.policy, "card": card, "ticks": args.ticks,
        "kernels_per_tick": len(kernels) / args.ticks,
        "ms_per_tick": ms_tick,
        "ticks_per_s": [1e3 / t for t in ms_tick],
        "profiled_ms_per_tick": wall_s / args.ticks * 1e3,
        "idle": 1 - busy_us / wall_us, "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
