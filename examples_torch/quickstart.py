"""Quickstart on the PyTorch port: the MIDAS middleware on a bursty
metadata workload (the counterpart of ``examples/quickstart.py``).

The paper's headline comparison (Lustre round-robin against MIDAS
power-of-d), then the full self-stabilizing stack (margins, pinning,
leaky bucket and the cooperative cache), and the policy and workload
registries through one declarative sweep each.  Only simulator modules
of the port run here.  On the card, or on the CPU with ``--device
cpu``:

  PYTHONPATH=src python examples_torch/quickstart.py
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu --T 400
"""

import argparse

import numpy as np

from repro_torch.core import (SimConfig, SweepSpec, make_workload, policies,
                              run_sweep, simulate, workloads)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=2400,
                    help="ticks (2400: 120 s of simulated time)")
    ap.add_argument("--m", type=int, default=8, help="metadata servers")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when omitted")
    args = ap.parse_args(argv)
    T, M, dev = args.T, args.m, args.device
    wl = make_workload("bursty", T=T, m=M, seed=0, device=dev)

    print("=== Lustre baseline: namespace round-robin ===")
    rr = simulate(SimConfig(m=M, policy="round_robin"), wl,
                  do_warmup=False, device=dev)
    print(f"  mean queue      {rr.mean_queue():8.2f}")
    print(f"  worst-case q    {rr.worst_case_queue():8.1f}")
    print(f"  dispersion (CV) {rr.dispersion():8.3f}")

    print("=== MIDAS (power-of-d within feasible sets) ===")
    pod = simulate(SimConfig(m=M, policy="power_of_d"), wl,
                   do_warmup=False, device=dev)
    print(f"  mean queue      {pod.mean_queue():8.2f}  "
          f"({(1 - pod.mean_queue() / rr.mean_queue()) * 100:+.0f}% "
          f"vs RR; paper: ~23% avg)")
    wc_gain = (1 - pod.worst_case_queue() / rr.worst_case_queue()) * 100
    print(f"  worst-case q    {pod.worst_case_queue():8.1f}  "
          f"({wc_gain:+.0f}% vs RR; paper: 50-80%)")
    print(f"  dispersion (CV) {pod.dispersion():8.3f}  (paper: <=0.43)")

    print("=== full MIDAS: + control loop + cooperative cache ===")
    full = simulate(SimConfig(m=M, policy="midas", middleware=("cache",),
                              cache_mode="lease"), wl, device=dev)
    fc = full.final_cache
    print(f"  mean queue      {full.mean_queue():8.2f}")
    hit_rate = int(fc.hits) / max(int(fc.hits) + int(fc.misses), 1)
    print(f"  cache hit rate  {hit_rate:8.3f}")
    print(f"  stale serves    {int(fc.stale_serves):8d}  (lease coherence)")
    print(f"  steering d knob min/max: {full.d_timeline.min()}/"
          f"{full.d_timeline.max()}  (bounded 1..4)")
    steer_frac = full.steered.sum() / max(full.eligible.sum(), 1)
    print(f"  steered/eligible {steer_frac:.3f}"
          f"  (leaky-bucket cap 0.10)")

    print("=== policy registry: swap policies without touching the engine ===")
    print(f"  registered: {', '.join(policies.available())}")
    res = run_sweep(SweepSpec(config=SimConfig(m=M), workloads=wl,
                              policies=("jsq", "chbl"), seeds=(0, 1),
                              do_warmup=False), device=dev)
    for name in ("jsq", "chbl"):
        rows = res.rows(policy=name)
        mq = np.mean([r.mean_queue() for r in rows])
        print(f"  {name:6s} mean queue {mq:8.2f}  (2-seed avg)")

    print("=== workload registry: scenarios compose from combinators ===")
    print(f"  registered: {', '.join(workloads.available())}")
    scen = [make_workload(n, T=T // 2, m=M, seed=0, device=dev)
            for n in ("job_startup", "multi_tenant")]
    res = run_sweep(SweepSpec(config=SimConfig(m=M), workloads=scen,
                              policies=("round_robin", "power_of_d"),
                              do_warmup=False), device=dev)
    for wl_name in ("job_startup", "multi_tenant"):
        rr_q = res.row(policy="round_robin", workload=wl_name).mean_queue()
        pod_q = res.row(policy="power_of_d", workload=wl_name).mean_queue()
        print(f"  {wl_name:12s} RR {rr_q:7.2f} -> MIDAS {pod_q:7.2f} "
              f"({(1 - pod_q / max(rr_q, 1e-9)) * 100:+.0f}%)")


if __name__ == "__main__":
    main()
