#!/usr/bin/env python3
"""E1 + E2 on the port: the paper's §VI queue-length claims.

Run from the repository root:

    python3 benchmarks_torch/paper_claims.py [--T 3000] [--device cpu]

It runs ``round_robin`` (the Lustre baseline) against ``power_of_d``
(MIDAS's headline policy) on the paper's five workloads at m = 8
servers (``SimConfig(m=8)`` defaults, seed 0, no warmup): one
``simulate`` per policy and workload, as ``benchmarks/paper_claims.py``
runs the reference.  It prints one line per run (mean and worst-case
queue, dispersion, ticks/s), then the four claims as the reference
prints them: the mean queue ~23% lower, the worst case 50-80% lower,
the dispersion ranges of RR (20-88%) and MIDAS (0-43%).  The queue
timelines (every 10th tick) go to ``build/paper_claims/`` (ignored by
git).  It runs on the CUDA card unless passed ``--device cpu``.

The workloads' arrival counts are ``torch.poisson`` draws, not the
reference's ``jax.random.poisson``, so the grids and the claims match
the reference's only in distribution.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

T = 3000  # 150 s at dt = 50 ms
M = 8
PAPER_POLICIES = ("round_robin", "power_of_d")
PAPER_WORKLOADS = ("light", "bursty", "periodic", "diurnal", "skewed")
OUT = ROOT / "build" / "paper_claims"


def run(T: int = T, device: str = "cuda", out: Path = OUT, say=print):
    """Run every (workload, policy) pair; return the claims as a dict:
    ``mean_reduction`` (average over the workloads), ``wc_reductions``,
    ``disp_rr`` and ``disp_midas`` (one value a workload, fractions),
    and ``ticks_per_s`` per policy (summed ticks over summed seconds)."""
    import torch

    from repro_torch.core import SimConfig, make_workload, simulate

    mean_red, wc_red, disp_rr, disp_midas = [], [], [], []
    ticks = dict.fromkeys(PAPER_POLICIES, 0.0)
    secs = dict.fromkeys(PAPER_POLICIES, 0.0)
    timelines = {}
    for wl_name in PAPER_WORKLOADS:
        wl = make_workload(wl_name, T=T, m=M, seed=0, device=device)
        res = {}
        for policy in PAPER_POLICIES:
            cfg = SimConfig(m=M, policy=policy)
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = res[policy] = simulate(cfg, wl, do_warmup=False,
                                       device=device)
            dt = time.perf_counter() - t0
            ticks[policy] += T
            secs[policy] += dt
            say(f"sim/{wl_name}/{policy},{dt * 1e6:.1f},"
                f"mean_q={r.mean_queue():.2f};"
                f"wc_q={r.worst_case_queue():.1f};"
                f"dispersion={r.dispersion():.3f};"
                f"ticks_per_s={T / dt:.1f}")
        rr, pod = res["round_robin"], res["power_of_d"]
        mean_red.append(1 - pod.mean_queue() / max(rr.mean_queue(), 1e-9))
        wc_red.append(
            1 - pod.worst_case_queue() / max(rr.worst_case_queue(), 1e-9))
        disp_rr.append(rr.dispersion())
        disp_midas.append(pod.dispersion())
        timelines[wl_name] = {
            "round_robin": rr.queue_timeline[::10].tolist(),
            "midas_power_of_d": pod.queue_timeline[::10].tolist(),
        }
    out.mkdir(parents=True, exist_ok=True)
    (out / "queue_timelines.json").write_text(json.dumps(timelines))
    claims = dict(
        mean_reduction=float(np.mean(mean_red)),
        wc_reductions=[float(x) for x in wc_red],
        disp_rr=[float(x) for x in disp_rr],
        disp_midas=[float(x) for x in disp_midas],
        ticks_per_s={p: ticks[p] / secs[p] for p in PAPER_POLICIES},
    )
    for line in claim_lines(claims):
        say(line)
    return claims


def claim_lines(c):
    """The four claims, printed as ``benchmarks/paper_claims.py``
    prints them."""
    wc, dr, dm = c["wc_reductions"], c["disp_rr"], c["disp_midas"]
    return [
        f"paper/mean_queue_reduction_avg,0.0,"
        f"{c['mean_reduction'] * 100:.1f}% (paper: ~23%)",
        f"paper/worst_case_reduction_range,0.0,"
        f"{min(wc) * 100:.0f}%..{max(wc) * 100:.0f}% (paper: 50-80%)",
        f"paper/dispersion_rr_range,0.0,"
        f"{min(dr) * 100:.0f}%..{max(dr) * 100:.0f}% (paper: 20-88%)",
        f"paper/dispersion_midas_range,0.0,"
        f"{min(dm) * 100:.0f}%..{max(dm) * 100:.0f}% (paper: 0-43%)",
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=T)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("paper_claims: no CUDA device", file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
        print(f"card: {card}; torch {torch.__version__}", flush=True)
    claims = run(args.T, args.device, args.out,
                 say=lambda s: print(s, flush=True))
    print(json.dumps(claims), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
