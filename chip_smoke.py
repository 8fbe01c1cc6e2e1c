#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout,
holds it against its plain PyTorch version, drives the port's main path
(``repro_torch.core.simulate``: MIDAS routing, the cooperative cache,
the hysteresis controller, the ``bursty`` workload) at full width, and
checks what comes out.  Phases:

1. card and build: the card's name and power limit, the kernel build;
2. every kernel against its plain version on the card, with its device
   time (CUDA-graph replay), the time a Python caller pays per call,
   and its bound;
3. the main path at full width (m = 64 servers, N = 10**6 keys, V = 64
   vnodes, 512 request slots per tick, T = 1200 ticks), counting the
   kernel's launches;
4. the same run with the plain version in place of the kernel, which
   must give the same timelines bit for bit;
5. a small run on the card against the same run on the CPU.

The line before the last is ``{"kernels": [...]}`` and the last line is
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
before the last line is printed.  The script imports neither JAX nor
the JAX package; it exits non-zero without a CUDA device or without the
port's sources beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FULL = dict(m=64, N=1_000_000, V=64, d_max=4, n_groups=8)
T_FULL, R_FULL, SEED = 1200, 512, 0
PARITY_TICKS = 1200  # phase 4 compares the whole horizon
REPLACES = "src/repro/kernels/midas_route/kernel.py:319"
N_TIMED = 1000  # back-to-back calls per host-side timing
N_GRAPH = 200  # calls per CUDA graph for device timing


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def phase_build(torch, kernel):
    say(card_line())
    say(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    secs, log = kernel.build()
    say(f"[1] route_select built in {secs:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say("[1] ptxas:", line.strip())


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

SHAPES = [  # (R, m, d_max): the CPU tests' cases, the main path, a horizon
    (256, 8, 4), (100, 8, 4), (64, 32, 8), (7, 4, 2),
    (64, 64, 4), (T_FULL * R_FULL, 64, 4),
]
MAIN_SHAPE = (64, 64, 4)


def route_inputs(torch, R, m, d_max, seed):
    """Inputs with exact ties (few distinct loads, zero tie scores on
    half the rows) and inf loads, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    feas = torch.randint(0, m, (R, d_max), generator=g, device=dev,
                         dtype=torch.int32)
    load = torch.randint(0, 6, (m,), generator=g, device=dev).float()
    load[::5] = torch.inf
    p50 = torch.randint(0, 8, (m,), generator=g, device=dev).float() * 25
    sampled = torch.rand((R, d_max), generator=g, device=dev) < 0.6
    tie = torch.rand((R, d_max), generator=g, device=dev) * 1e-3
    tie[::2] = 0.0
    scal = torch.tensor([1.0, 20.0, 2.0, 0.0], device=dev)
    return feas, load, p50, sampled, tie, scal


def route_bytes(R, m, d_max, mode) -> int:
    """Bytes route_select must move in ``mode``, each read or written
    once: feas (int32) per slot and load (f32) per server always;
    sampled (1 B) and tie (f32) per slot unless chbl; p50 (f32) per
    server in midas; the 4 f32 scalars; assign (int32) and ok_any (1 B)
    per row."""
    per_slot = 4 if mode == "chbl" else 4 + 1 + 4
    per_server = 8 if mode == "midas" else 4
    return R * d_max * per_slot + m * per_server + 16 + R * (4 + 1)


def host_ms(torch, fn, n=N_TIMED) -> float:
    """Per-call time of n back-to-back calls from Python, between CUDA
    events: what a caller that makes one call at a time pays."""
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(torch, fns, n) -> float:
    """Per-call device time: n calls captured in one CUDA graph and
    replayed between CUDA events, so no host-side cost is counted.
    Call j runs ``fns[j % len(fns)]``: several input sets whose total
    exceeds the 50 MB L2 make every call read its inputs cold."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for j in range(n):
            fns[j % len(fns)]()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    reps = 10
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def phase_kernel(torch, kernel, ref):
    max_err = 0.0
    rows = []
    for R, m, d_max in SHAPES:
        # the main path's shapes find their inputs hot in L2 (written by
        # the ops just before); the horizon-sized shape is timed cold
        n_sets = 1 if R < 10**5 else 6
        sets = [route_inputs(torch, R, m, d_max, seed=R + m + d_max + i)
                for i in range(n_sets)]
        for mode in ref.ROUTE_MODES:
            for args in sets:
                want = ref.route_select(*args, mode=mode)
                got = kernel.route_select(*args, mode=mode)
                torch.cuda.synchronize()
                for w, k in zip(want, got):
                    check(torch.equal(w, k),
                          f"route_select {mode} {(R, m, d_max)} differs")
                err = (want[0].float() - got[0].float()).abs().max().item()
                max_err = max(max_err, err)

            def calls(fn):
                return [lambda a=a: fn(*a, mode=mode) for a in sets]

            k_fns, p_fns = calls(kernel.route_select), calls(ref.route_select)
            n = N_GRAPH if R < 10**5 else 24
            row = dict(
                R=R, m=m, d_max=d_max, mode=mode,
                ms=device_ms(torch, k_fns, n),
                plain_ms=device_ms(torch, p_fns, n),
                host_ms=host_ms(torch, k_fns[0]),
                plain_host_ms=host_ms(torch, p_fns[0]),
                bound_ms=route_bytes(R, m, d_max, mode)
                / HBM_BYTES_PER_S * 1e3,
            )
            rows.append(row)
            say(f"[2] route_select {mode:10s} R={R:6d} m={m:3d} "
                f"d_max={d_max}: equal; device kernel "
                f"{row['ms'] * 1e3:.3f} us, plain {row['plain_ms'] * 1e3:.3f}"
                f" us, bound {row['bound_ms'] * 1e3:.4f} us; called one at "
                f"a time from Python: kernel {row['host_ms'] * 1e3:.2f} us,"
                f" plain {row['plain_host_ms'] * 1e3:.2f} us")
    return rows, max_err


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------


def tensor_bytes(tree) -> int:
    import torch

    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, tuple):
        return sum(tensor_bytes(x) for x in tree)
    return 0


def check_result(np, res, wl, T, m):
    """The engine's own invariants on a finished run."""
    arr = res.arrivals
    for f in ("queue_timeline", "arrivals", "lat_pred"):
        x = getattr(res, f)
        check(x.shape == (T, m), f"{f} has shape {x.shape}")
        check(np.isfinite(x).all(), f"{f} is not finite")
    check((res.queue_timeline >= 0).all(), "negative queue")
    offered = int(wl.mask.sum().item())
    routed = int(arr.sum()) + int(res.cache_hits.sum())
    check(routed == offered,
          f"requests lost: {offered} offered, {routed} routed or absorbed")
    check((res.steered <= res.eligible).all(), "steered > eligible")
    check(((res.d_timeline >= 1) & (res.d_timeline <= 4)).all(),
          "d out of bounds")
    check(np.isfinite(res.pressure).all(), "pressure is not finite")


FIELDS = ("queue_timeline", "arrivals", "lat_pred", "d_timeline",
          "delta_l_timeline", "f_max_timeline", "pressure", "steered",
          "eligible", "cache_hits")


def phase_main(torch, np, core, sim, kernel):
    cfg = core.SimConfig(policy="midas", middleware=("cache",),
                         cache_mode="lease", **FULL)
    wl = core.make_workload("bursty", T=T_FULL, m=cfg.m, seed=SEED,
                            N=cfg.N, R=R_FULL, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.warmup(cfg, device="cuda")
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    kernel.route_select.launches = 0
    t0 = time.perf_counter()
    res = core.simulate(cfg, wl, device="cuda")
    run_s = time.perf_counter() - t0
    launches = kernel.route_select.launches
    want = T_FULL * cfg.n_groups
    say(f"[3] route_select launches in the main path: {launches} "
        f"(expected T x n_groups = {want})")
    check(launches == want, f"{launches} launches, expected {want}")
    check_result(np, res, wl, T_FULL, cfg.m)
    state_bytes = tensor_bytes(sim.init_state(cfg, device="cuda"))
    main_s = max(run_s - warm_s, 1e-9)
    p50, p99 = res.latency_quantiles()
    say(f"[3] m={cfg.m} N={cfg.N} V={cfg.V} R={R_FULL} T={T_FULL}: "
        f"mean_queue={res.mean_queue():.6f} "
        f"worst_case_queue={res.worst_case_queue():.6f} "
        f"dispersion={res.dispersion():.6f} "
        f"latency p50/p99={p50:.1f}/{p99:.1f} ms")
    say(f"[3] steered={res.steered.sum():.0f} "
        f"eligible={res.eligible.sum():.0f} "
        f"cache_hits={res.cache_hits.sum():.0f} "
        f"offered={int(wl.mask.sum().item())}")
    say(f"[3] simulate {run_s:.3f} s incl. warmup ({warm_s:.3f} s alone); "
        f"main run {T_FULL / main_s:.1f} ticks/s; state on the card "
        f"{state_bytes / 1e6:.2f} MB, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    return cfg, wl, res, launches


def phase_parity(torch, np, core, cfg, wl, res_cuda):
    import dataclasses

    T = PARITY_TICKS
    cfg_ref = dataclasses.replace(cfg, route_impl="ref")
    if T < T_FULL:
        wl = wl._replace(keys=wl.keys[:T], mask=wl.mask[:T],
                         is_write=wl.is_write[:T])
    t0 = time.perf_counter()
    res_ref = core.simulate(cfg_ref, wl, device="cuda")
    secs = time.perf_counter() - t0
    for f in FIELDS:
        a, b = getattr(res_cuda, f)[:T], getattr(res_ref, f)
        check(np.array_equal(a, b), f"kernel vs plain: {f} differs")
    say(f"[4] {T} ticks with the plain route_select on the card: every "
        f"timeline bit-for-bit equal to the kernel's run ({secs:.3f} s)")


def phase_small(np, core):
    """A small run on the card against the same run on the CPU: exact
    except pressure (float32 sums over m may be taken in another
    order on the card)."""
    cfg = core.SimConfig(m=8, N=512, policy="midas", middleware=("cache",))
    wl = core.make_workload("bursty", T=400, m=8, seed=3, N=512,
                            device="cpu")
    cpu = core.simulate(cfg, wl, do_warmup=False, device="cpu")
    gpu = core.simulate(cfg, wl, do_warmup=False, device="cuda")
    for f in FIELDS:
        a, b = getattr(cpu, f), getattr(gpu, f)
        if f == "pressure":
            check(np.allclose(a, b, rtol=1e-6, atol=0), "pressure differs")
        else:
            check(np.array_equal(a, b), f"card vs CPU: {f} differs")
    check(cpu.steered.sum() > 0, "the small run never steered")
    say(f"[5] small run (m=8, N=512, T=400) on the card equals the CPU "
        f"run; steered={cpu.steered.sum():.0f}")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port sources under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import core
    from repro_torch.core import sim
    from repro_torch.kernels.midas_route import kernel, ref

    t_start = time.perf_counter()
    try:
        phase_build(torch, kernel)
        rows, max_err = phase_kernel(torch, kernel, ref)
        cfg, wl, res, launches = phase_main(torch, np, core, sim, kernel)
        phase_parity(torch, np, core, cfg, wl, res)
        phase_small(np, core)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    main_row = next(
        r for r in rows
        if (r["R"], r["m"], r["d_max"]) == MAIN_SHAPE and r["mode"] == "midas"
    )
    say(f"[*] total {time.perf_counter() - t_start:.1f} s")
    say(card_line())
    say(json.dumps({"kernels": [{
        "name": "route_select",
        "route": "cuda",
        "source": "src/repro_torch/kernels/midas_route/csrc/route_select.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
