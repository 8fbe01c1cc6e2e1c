#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version, drives the port's paths
at full width and checks what comes out: the simulator
(``repro_torch.core.simulate``: MIDAS routing, the cooperative cache,
the hysteresis controller, the ``bursty`` workload; under both engines),
serving (``repro_torch.launch.serve.serve``: the MIDAS router in
front of prefill and greedy decode) of SmolLM-360M, falcon-mamba-7b,
Qwen3-MoE-235B-A22B, MusicGen-Large and LLaVA-NeXT-Mistral-7B, and
training (``repro_torch.launch.train``) of SmolLM-360M.
Phases:

1. card and build: the card's name and power limit, the six sources
   built at once (one nvcc each);
2. every kernel against its plain version on the card, with its device
   time (CUDA-graph replay), the time a Python caller pays per call,
   its bound and, where one PyTorch call computes the same function,
   that call's time (a yardstick only; the port never calls it:
   ``scaled_dot_product_attention`` for attention, ``torch.topk`` for
   the dispatch candidates; no PyTorch call computes ``route_select``,
   ``route_tick``, ``chunk_scan``, the fused dispatch or the steering);
   ``route_tick`` (a tick's 8 waves of the midas, power_of_d or chbl
   policy in one launch, the tick's steering dV included) bitwise
   against the engine's waves one at a time (its views against the
   views they routed on, its dV also against ``steering_dv_waves``),
   at the engine's shape,
   with repeated keys, live and expired pins, binding and free budgets,
   ragged masks, a wrapping history ring and loads on chbl's cap, with
   one shared view and with per-wave base views (fleet routing), timed
   in both and in each mode; ``route_tick`` (each mode) and
   ``route_select`` (power_of_d, chbl, midas) on the member-aware
   feasible sets of a membership fault (m = 64 with server 0 dead; m = 4
   with three dead, every row repeating its live server), bitwise;
   ``flash_attention`` also at Qwen3-MoE's prefill shape, with its bound
   on the tensor cores and the CUDA cores' beside it, and bitwise equal
   on a repeated call; both attention kernels also at phase 15's
   shapes (MusicGen's 32 heads over 32 KV heads at D = 64, LLaVA's 32
   over 8 at D = 128 with 1088 prompt positions); ``dispatch_steer`` against
   ``ref.steer_from_candidates`` on the same candidates (f_max below 1,
   0 and 1, one token, the edges of its register kernel and of its
   select's paths, k + d = 16 at E = 1024, 5000 tokens; infinite loads,
   and loads under which its select runs), the whole dispatch at both
   f_max called from Python, and the launch floor (a one-element op in
   the same graph replay);
3. the simulator at full width (m = 64 servers, N = 10**6 keys, V = 64
   vnodes, 512 request slots per tick, T = 1200 ticks) under the midas
   policy, counting one ``route_tick`` launch a tick and no other,
   with its ticks/s and its kernels a tick (torch.profiler over 50
   ticks); then 400 ticks of ``power_of_d`` at the same constants,
   counting one ``route_tick`` launch a tick and equal bit for bit to
   its plain run;
4. the midas run's first 300 ticks with the plain wave loop in place of
   the kernel, which must give the same timelines, dV and final state
   bit for bit;
5. a small simulator run on the card against the same run on the CPU;
10. (run right after phase 5) the evaluation plane at phase 3's
   constants and grid, 60 ticks each: ``chbl`` (one ``route_tick``
   launch a tick, 60), and midas + cache under the ``no_margin``,
   ``no_pin`` and ``no_bucket`` ablations, the ``aimd``,
   ``deadband_pid`` and ``static`` controllers and the oscillation
   guard (one ``route_tick`` launch a tick, 60 each), every one bit for
   bit its plain run; ``round_robin``, ``rr_request``, ``uniform`` and
   ``jsq``, which launch no kernel; phase 5's card-vs-CPU run for every
   new policy and control law, and a 1200-tick guard run whose trips
   the card and the CPU count alike; E1/E2 (``round_robin`` against
   ``power_of_d`` on the paper's five workloads at m = 8, cut to 200
   ticks from the paper's 3000) with the four claims and both ticks/s;
11. (run right after phase 10) the fleet path, E9's: the
   ``rename_storm`` scenario realized on the card at phase 3's
   constants, served by P = 8 proxies (``fleet_cache``, 100 ms gossip,
   a lag ring of 2 ticks over the 10**6 keys, lease mode) with fleet
   routing (each proxy routes its own wave on its own staggered view),
   200 ticks with warmup: exactly 200 ``route_tick`` launches (the
   kernel's per-wave base views), its ticks/s and kernels a tick; the
   plain wave loop bit for bit on every output, dV and the final state
   (the per-proxy counters summing to the aggregates); the Δ = 0
   contract (a gossip_ms = 0 fleet without fleet routing equals the
   shared cache bit for bit); 100 ticks of ``power_of_d`` under fleet
   routing (exactly 100 ``route_tick`` launches, bitwise its plain
   run); the card against the CPU at m = 8, T = 200 on CPU-realized
   grids of the E9 scenarios, ``multi_tenant``, ``adversarial`` and
   ``trace_replay``, over the nine (gossip, cache mode) cells of E9;
12. (run right after phase 11) the fault layer: E12's scenario (the
   first 300 ticks of phase 3's ``bursty`` grid) at phase 11's
   constants under E13's three compound programs applied together
   (a checkpoint storm with a server crash, rolling brownouts, a crash
   whose detection cascades into a fleet-wide gossip partition),
   retimed to 400 ticks and run over 300, with warmup: exactly 300
   ``route_tick``
   launches, bitwise its plain run on every output and the whole final
   ``FleetState``; the schedule's two epoch flips, remap invalidation on
   exactly those ticks; no arrivals to the dead server once detected
   (past any pin made before detection) and its queue frozen until it
   rejoins; ``avail`` below ``AVAIL_FULL`` on exactly the degraded
   ticks; the per-proxy counters summing to the aggregates; ticks/s and
   kernels a tick (torch.profiler, ticks 150-200 inside the fault
   window and 250-300 after it); 100 ticks of ``power_of_d`` under the
   same program (exactly 100 ``route_tick`` launches, bitwise); zero
   cost when off (``faults=()`` and a benign event equal ``None`` bit
   for bit over 100 ticks) and ``proxy_join`` bitwise its plain run;
   the card against the CPU over E12's six fault blocks, each under one
   of three (policy, controller) cells in turn, at m = 8 (T = 150, t0
   and durations / 6);
   E12's crash headline at its own T = 900, seed 0 (E12 averages
   seeds 0 and 1), printed as a JSON line;
13. (run right after phase 12) sweeps at phase 3's constants through
   ``repro_torch.core.run_sweep``: midas, ``power_of_d`` and
   ``round_robin`` × the ``hysteresis`` and ``static`` controllers ×
   the first 50 ticks of phase 3's ``bursty`` grid and a ``storm``
   grid realized on the card × seeds 0 and 1, with phase 3's targets,
   under ``metrics="full"`` and then ``"summary"``: exactly 800
   ``route_tick`` launches a mode (midas and power_of_d) and no other
   kernel, ticks/s by policy (from the sweep's ``sweep/execute`` spans),
   kernels a tick and peak device memory of each mode; every summary row
   bit for bit ``summarize`` of its full row; midas × hysteresis ×
   bursty × seed 1 bit for bit its ``simulate`` and power_of_d × static
   × storm × seed 0 its single run; E13's ``crash_during_storm``
   retimed to 100 ticks as a ``faults=`` override on ``fleet_cache``
   (P = 8, 100 ms gossip) under ``hysteresis`` and ``aimd`` × seeds 0
   and 1 with the sweep's one warmup: 400 ``route_tick`` launches, each
   row and its ``FleetState`` bit for bit its single run (``simulate``'s
   steps after one warmup of the config);
14. (run right after phase 13) the unrolled-waves engine
   (``SimConfig(unroll_waves=True)``, E10's "before"): its warmup on
   300 ticks of the light grid equal to the hoisted engine's; with phase
   3's targets, midas + cache + hysteresis on the first 150 ticks of
   phase 3's grid, exactly 1200 ``route_select`` launches (one a wave)
   and no ``route_tick``, every per-tick output and the final state bit
   for bit the hoisted engine's run (150 ``route_tick``), ticks/s and
   kernels a tick of both engines; phase 12's faulted fleet with every
   time of E13's programs / 4, 100 ticks: 800 ``route_select`` against
   100 ``route_tick``, bitwise, ``FleetState`` included;
   ``theory.balls_into_bins`` at n = m = 64, d = 1, 2, 30 trials on the
   card bitwise the CPU's, and the gaps as the reference claims; a
   trace and an artifact under ``build/unrolled/``, read back by
   ``python -m repro_torch.obs.report`` (``--check`` exits 0);
6. serving at SmolLM-360M's full width and depth (32 layers, d_model
   960, 15 query heads over 5 KV heads; random weights from seed 0):
   8 requests of a 512-token prompt and 16 greedy decode steps behind a
   4-replica router, counting both attention kernels' launches; the
   same run with the plain attention gives the same tokens, and
   teacher-forced logits of the two agree;
7. a small serving run at the smoke configs on the card against the
   same run on the CPU (MusicGen's and LLaVA's frontends among them;
   falcon-mamba's, the MoE models' and jamba's
   tokens under the margin rule of phase 8, and their teacher-forced
   logits, on a float32 cache, within the CPU tests' 1e-4);
8. serving at falcon-mamba-7b's full width (d_model 4096, d_inner
   8192, d_state 16) cut to 8 of its 64 Mamba-1 layers (random weights
   from seed 0, in float32) with phase 6's traffic, counting
   ``chunk_scan``'s launches (one per layer and 128-token chunk of
   each prompt; decode is plain PyTorch, as in the reference); the
   same run with the plain scan gives the same tokens wherever the
   plain run's teacher-forced top-2 margin is decisive, and
   teacher-forced logits of the two agree (and are reported on a
   float32 cache too);
9. serving at Qwen3-MoE-235B-A22B's full width (d_model 4096, 64 query
   heads over 4 KV heads, head_dim 128, 128 experts top-8 of width
   1536, midas_d 2, f_max 0.25, vocab 151936) cut to 1 of its 94
   layers (in float32, random from seed
   0) with phase 6's traffic, counting ``dispatch_candidates`` and
   ``dispatch_steer`` (one launch each per layer per prefill and per
   decode step), both attention kernels and no other; tokens under the
   margin rule against the plain path; the serving path's telemetry is
   balanced, so nothing
   steers, as in the reference; then 2 requests through the f_max = 1
   variant on the same weights, which launches ``dispatch_fused``
   instead; decode ms a token of both;
15. (run right after phase 9) the audio and vision frontends at full
   width, random weights from seed 0, 4 requests and 16 greedy decode
   steps behind a 4-replica router: MusicGen-Large cut to 24 of its 48
   layers (d_model 2048; 512 frame embeddings a request; exactly 96
   ``flash_attention`` and 1536 ``decode_attention`` launches) and
   LLaVA-NeXT-Mistral-7B at full width cut to 8 of 32 layers (576 patch
   embeddings + 512 tokens a request; 32 and 512 launches); tokens equal
   between the kernel and the plain attention, teacher-forced logits
   within 2e-2;
16. (run right after phase 15) training: the flash-attention backward
   kernels (``flash_attention_bwd.cu``) against ``ref.mha_backward`` at
   SmolLM-360M's training shape (8, 512, 15, 5, 64) in bfloat16 and
   float32, Qwen3-MoE's heads, MusicGen's G = 1, gemma2's window and
   softcap and a ragged S, bitwise on a repeat; their library's SASS
   (tensor-core instructions, and no RED/ATOM); timed (CUDA-graph
   replay) beside SDPA's backward alone and the plain version (its
   forward and backward), the port's forward and backward pair beside
   SDPA's, and the forward alone at the training shape (with its row
   logsumexp) beside SDPA's forward; then SmolLM-360M at
   full width and depth trained 20 steps at batch 8 x seq 512 through
   ``repro_torch.launch.train --full-config`` at ``RunConfig``'s
   defaults (bfloat16 activations, float32 masters, AdamW,
   ``remat="dots_saveable"``): exactly 64 ``flash_attention`` (32 and
   32 recomputed) and 32 backward launches a step and no other kernel,
   the loss falling; 3 steps under each remat policy and "none" (ms a
   step, tokens/s, peak memory, launches; losses equal bit for bit)
   and 5 of ``adamw8bit``; 3 float32 steps of the kernel path against
   the plain path (losses within 1e-4, grad norms within 1e-3); a run
   at 4 of the 32 layers killed after step 5 and resumed from its
   asynchronous MIDAS-laned checkpoint of step 4, bitwise the
   uninterrupted run at step 6; each training smoke config's loss and
   gradients card against CPU (falcon-mamba and jamba: ``impl="auto"``
   refuses with the queued ``chunk_scan`` backward, ``impl="ref"``
   runs).

Every path is driven with every kernel's launch count set to 0 just
before it and read just after.

The line before the last is ``{"kernels": [...]}`` and the last line is
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
before the last line is printed.  The script imports neither JAX nor
the JAX package; it exits non-zero without a CUDA device or without the
port's sources beside it.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FULL = dict(m=64, N=1_000_000, V=64, d_max=4, n_groups=8)
T_FULL, R_FULL, SEED = 1200, 512, 0
PARITY_TICKS = 300  # phase 4 compares the first quarter, for time
POD_TICKS = 400  # the power_of_d run of phase 3
PROFILE_LEAD, PROFILE_TICKS = 400, 50  # phase 3's kernels-a-tick window
REPLACES = "src/repro/kernels/midas_route/kernel.py:319"
# route_tick: the kernel and the reference's wave scan around it
# (midas.py:53 route_midas, power_of_d.py, bounded_load.py)
TICK_REPLACES = f"{REPLACES} + src/repro/core/sim.py:537"
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 on the CUDA cores
# H100 SXM dense tensor-core peaks: TF32, whose 3xTF32 split makes three
# products of every float32 one, and bfloat16
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# serving (phase 6): the launcher's shapes at SmolLM-360M's width
# 16 decode steps (cut from 32 for time; PERF.md §4 lists the cuts)
SERVE = dict(requests=8, prompt_len=512, decode_len=16, replicas=4, seed=0)
SERVE_LOGIT_TOL = 2e-2  # kernel vs plain teacher-forced logits, rel + abs
SMALL_LOGIT_TOL = 1e-4  # card vs CPU at the smoke configs, as the CPU tests
# the exponentials of chunk_scan run on the special-function units: 16
# per SM per clock, 132 SMs, at the H100 SXM's 1.98 GHz boost clock
EXP_PER_S = 16 * 132 * 1.98e9
SCAN_TOL = 1e-4  # chunk_scan vs its plain version, rel + abs
N_TIMED = 1000  # back-to-back calls per host-side timing
N_GRAPH = 200  # calls per CUDA graph for device timing
# MoE serving (phase 9): Qwen3-MoE-235B-A22B at full width, depth cut to
# 2 of 94 layers for time (the weights are made on the host)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 1  # cut from 2 for time
# SSM serving (phase 8): falcon-mamba-7b at full width, depth cut to 16
# of 64 layers for time
SSM_ARCH, SSM_LAYERS = "falcon-mamba-7b", 8  # cut from 16 for time
MOE_FUSED_REQUESTS = 2  # the f_max = 1 variant's run
W_TOL = 1e-6  # dispatch weights, kernel vs plain (absolute)


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


def phase_build(torch, build, sources, loaders):
    """Build ``sources`` ((path, nvcc flags) each) at once, then load
    each library through ``loaders``."""
    say(card_line())
    say(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = build.build_all(sources)
    say(f"[1] {len(sources)} sources built at once in "
        f"{time.perf_counter() - t0:.2f} s")
    for load in loaders:
        load()
    for source, _ in sources:
        secs, log = built[str(source)]
        say(f"[1] {source.name} built in {secs:.2f} s")
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


def device_ms(torch, fns, n, stream=None) -> float:
    """Per-call device time: n calls captured in one CUDA graph and
    replayed between CUDA events, so no host-side cost is counted.
    Call j runs ``fns[j % len(fns)]``: several input sets whose total
    exceeds the 50 MB L2 make every call read its inputs cold.  The
    calls run once in the stream that captures them (``stream``, else a
    new one), so what a wrapper keeps per stream is made before the
    capture; autograd runs a backward on its forward's stream, so a
    forward made outside the graph for a backward inside it is made on
    ``stream``."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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
# phase 2 (continued): route_tick against the waves one at a time
# ---------------------------------------------------------------------------

# (G, Rg, m, d_max, N): the engine's tick at the main path's constants
TICK_SHAPE = (8, R_FULL // FULL["n_groups"], FULL["m"], FULL["d_max"],
              FULL["N"])
TICK_W = 5  # history ring of 5 waves: a tick of 8 wraps it
# (seed, f_max, key pool): a budget that binds (0.3) and one that does
# not (1.0); keys from pools of 8 and 40, repeated within and across
# waves
TICK_CASES = [(1, 0.3, 40), (2, 0.3, 8), (3, 1.0, 40), (4, 1.0, 8),
              (5, 0.3, 40), (6, 1.0, 40)]


TICK_POLICIES = ("midas", "power_of_d", "chbl")


def on_the_cap(np, torch, L, idx=(0, 3)):
    """``L`` with the servers ``idx`` moved onto chbl's cap: a fixed point
    of L[i] <- load_cap(L), so a load equals the cap exactly."""
    from repro_torch.core.policies.bounded_load import load_cap

    L = np.array(L, np.float32)
    idx = [i % L.size for i in idx]
    for _ in range(200):
        c = np.float32(load_cap(torch.as_tensor(L)).item())
        if (L[idx] == c).all():
            return L
        L[idx] = c
    raise PhaseError("no load vector on chbl's cap found")


def tick_case(torch, np, sim, seed, f_max, pool, m=None, member=None,
              policy="midas", on_cap=False):
    """One tick's engine inputs on the card, made with numpy: a ragged
    mask, live and expired pins on the key pool, integer histories and a
    few hot servers (so rows are eligible and steer).  With ``member``
    ((m,) bool) the feasible sets are a membership fault's
    (:func:`member_feasible`).  ``policy``: midas (its state and knobs),
    power_of_d or chbl (no state); ``on_cap`` puts two servers' loads on
    chbl's cap."""
    from repro_torch.core import policies, prng
    from repro_torch.core.controllers.base import Knobs
    from repro_torch.core.policies.midas import MidasState

    G, Rg, m_full, d_max, N = TICK_SHAPE
    m = m_full if m is None else m
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x).cuda()

    keypool = rng.choice(N, pool, replace=False)
    keys = t(keypool[rng.integers(0, pool, (G, Rg))]).long()
    mask = t(rng.random((G, Rg)) < 0.85)
    name = policy
    policy = policies.get(name)
    draws = policy.draws(prng.fold_in(prng.PRNGKey(seed, "cuda")[None],
                                      torch.arange(G, device="cuda")),
                         (Rg, d_max))
    now = 1000.0
    pin_server = np.full(N, -1, np.int32)
    pin_expiry = np.zeros(N, np.float32)
    pin_server[keypool] = rng.integers(-1, m, pool)
    pin_expiry[keypool] = now + rng.integers(-2, 3, pool) * 100.0
    steer = rng.integers(0, 4, TICK_W).astype(np.float32)
    L_hat = np.round(rng.random(m) * 6, 1).astype(np.float32)
    L_hat[rng.integers(0, m, 4)] += 30.0
    if on_cap:
        L_hat = on_the_cap(np, torch, L_hat)
    cfg = sim.SimConfig(policy=name, **dict(FULL, m=m))
    st = sim.init_state(cfg, device="cuda")._replace(
        L_hat=t(L_hat), p50_hat=t((rng.random(m) * 300).astype(np.float32)),
        policy=() if name != "midas" else MidasState(
            pin_server=t(pin_server), pin_expiry=t(pin_expiry),
            steer_hist=t(steer),
            elig_hist=t(steer + rng.integers(0, 3, TICK_W).astype(
                np.float32)),
            hist_idx=t(np.int32(rng.integers(0, 3 * TICK_W)))))
    knobs = Knobs(d=t(np.int32(3)), delta_l=t(np.float32(1.0)),
                  delta_t=t(np.float32(-1e9)), f_max=t(np.float32(f_max)),
                  pin_ms=t(np.float32(300.0)), ttl_scale=t(np.float32(1.0)))
    consts = sim._Consts(torch.zeros((), device="cuda"),
                         torch.ones((), device="cuda"),
                         torch.ones(m, device="cuda"),
                         fixed_d=t(np.int32(cfg.fixed_d)))
    return (cfg, policy, st, knobs, t(np.float32(now)), keys, mask,
            member_feasible(torch, np, keys, m, d_max, member), draws,
            consts)


def member_feasible(torch, np, keys, m, d_max, member=None):
    """Feasible sets of ``keys`` on the card: member-free, or (``member``:
    (m,) bool) those the fault layer gathers in a membership epoch, at
    its scan width; with fewer live servers than d_max every row repeats
    its one live server."""
    from repro_torch.core import hashring
    from repro_torch.core.faults import base as faults_base

    ring = hashring.make_ring(m, FULL["V"], device="cuda")
    if member is None:
        return hashring.feasible_set(ring, keys, d_max)
    member = np.asarray(member, bool)
    return hashring.feasible_set(
        ring, keys, d_max,
        scan_width=faults_base._scan_width(m, FULL["V"], member[None]),
        member=torch.as_tensor(member).cuda())


def fleet_views(torch, np, seed):
    """(G, m) per-wave views on the card, each proxy's own: a grid of
    tenths with a few hot servers a wave, so rows are eligible."""
    G, _, m, _, _ = TICK_SHAPE
    rng = np.random.default_rng(seed + 100)
    views = np.round(rng.random((G, m)) * 6, 1).astype(np.float32)
    for g in range(G):
        views[g, rng.integers(0, m, 4)] += 30.0
    return torch.as_tensor(views).cuda()


def clone(tree):
    import torch

    if torch.is_tensor(tree):
        return tree.clone()
    items = [clone(x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def tick_bytes(np, keys, W, changed, mode="midas") -> int:
    """Bytes one tick must move in ``mode``, each read or written once:
    per row its mask (1 B) and per slot feas (4), and L_hat; then assign
    (4 B a row), the views (4 B a server a wave), arrivals and three
    counts (steered, eligible, dV).  power_of_d and midas also read rank
    (1) and tie (4) per slot and d; midas also each row's key (8 B), the
    pin entries (8 B) of the tick's distinct keys, p50, five more knobs,
    the histories and hist_idx, and writes hist_idx, the history slots
    written and the pin entries the tick changed."""
    G, Rg, m, d_max, _ = TICK_SHAPE
    rows = G * Rg
    reads = rows * (1 + 4 * d_max) + 4 * m
    writes = rows * 4 + G * m * 4 + 4 * m + 12
    if mode != "chbl":
        reads += rows * 5 * d_max + 4
    if mode == "midas":
        distinct = int(np.unique(keys.cpu().numpy()).size)
        reads += rows * 8 + 8 * distinct + 4 * m + 20 + 8 * W + 4
        writes += 4 + 8 * min(G, W) + 8 * changed
    return reads + writes


def tick_both(torch, sim, case, what, views=None):
    """One tick's waves through the plain loop and through route_tick,
    each from its own copy of the state; every output and the policy
    state must be equal bit for bit, and route_tick's views (read off
    the call: the engine's TickRoute leaves them out) the views the
    plain loop routed each wave on, its dV also ``steering_dv_waves``
    on those views.  Returns the kernel's TickRoute."""
    from repro_torch.core.policies.base import (
        RouteContext,
        steering_dv_waves,
    )
    from repro_torch.kernels.midas_route import ops

    cfg, policy, st, knobs, now, keys, mask, feas, draws, consts = case
    out, real, calls = {}, ops.route_tick, []

    def record(*args, **kw):
        calls.append(real(*args, **kw))
        return calls[-1]

    for impl in ("ref", "cuda"):
        s = st._replace(policy=clone(st.policy))
        ops.route_tick = record
        try:
            out[impl] = sim._route_waves(cfg, policy, s, knobs, now, keys,
                                         mask, feas, draws, impl, consts,
                                         views)
        finally:
            ops.route_tick = real
    torch.cuda.synchronize()
    check(len(calls) == 1, f"route_tick {what}: {len(calls)} calls, "
          f"expected 1")
    (wps, wt), (gps, gt) = out["ref"], out["cuda"]
    want_views = views
    if views is None:  # the shared view plus the earlier waves' sends
        sent, rows = torch.zeros_like(st.L), []
        for g in range(keys.shape[0]):
            rows.append(st.L_hat + sent)
            sent = sent + sim._wave_counts(cfg.m, mask[g], wt.assign[g])
        want_views = torch.stack(rows)
    ctx = RouteContext(keys=keys, mask=mask, feas=feas, L_view=None,
                       p50_view=None, knobs=None, now_ms=None, draws=None,
                       m=cfg.m, fixed_d=None)
    pairs = [("assign", wt.assign, gt.assign),
             ("views", want_views, calls[0][1]),
             ("dV against steering_dv_waves",
              steering_dv_waves(ctx, want_views, wt.assign), calls[0][5]),
             ("arrivals", wt.arrivals, gt.arrivals)]
    pairs += [(f, getattr(wt.stats, f), getattr(gt.stats, f))
              for f in ("steered", "eligible", "dV")]
    pairs += [(f, getattr(wps, f), getattr(gps, f))
              for f in getattr(wps, "_fields", ())]
    check(type(wps) is type(gps), f"route_tick {what}: the policy state "
          f"differs from the waves one at a time")
    for name, w, g in pairs:
        if w.dtype == torch.float32:  # the bits: +0.0 and -0.0 differ
            w, g = w.view(torch.int32), g.view(torch.int32)
        check(w.dtype == g.dtype and torch.equal(w, g),
              f"route_tick {what}: {name} differs from the waves one at a "
              f"time")
    return gt


def tick_kernel_call(torch, kernel, case, mode, views=None):
    """The route_tick call of ``case``'s tick in ``mode`` (the engine's
    arguments; per-wave base views when given)."""
    cfg, policy, st, knobs, now, keys, mask, feas, draws, consts = case
    L = st.L_hat if views is None else views
    if mode == "chbl":
        return lambda: kernel.route_tick(keys, mask, feas, None, None, L,
                                         mode="chbl")
    if mode == "power_of_d":
        return lambda: kernel.route_tick(keys, mask, feas, draws.rank,
                                         draws.tie, L, d=consts.fixed_d,
                                         mode="power_of_d")
    args = (keys, mask, feas, draws.rank, draws.tie, L, st.p50_hat,
            *st.policy)
    kw = dict(d=knobs.d, delta_l=knobs.delta_l, delta_t=knobs.delta_t,
              f_max=knobs.f_max, pin_ms=knobs.pin_ms, now_ms=now)
    return lambda: kernel.route_tick(*args, **kw)


def phase_route_tick(torch, np, sim, kernel):
    """route_tick in each mode against the engine's waves one at a time,
    bitwise on every output (the dV to the bit) and on midas's state;
    then timed at the engine's shape in each mode.  Returns midas's row
    (the kernels line times the main path's mode; the other modes' times
    are printed here)."""
    for mode in TICK_POLICIES:
        steered = eligible = binds = moved = 0
        for seed, f_max, pool in TICK_CASES:
            case = tick_case(torch, np, sim, seed, f_max, pool, policy=mode)
            gt = tick_both(torch, sim, case, (mode, seed, f_max, pool))
            n_st, n_el = int(gt.stats.steered), int(gt.stats.eligible)
            steered, eligible = steered + n_st, eligible + n_el
            binds += int(n_st < n_el)
            moved += float(gt.stats.dV) != 0.0
        check(moved > 0, f"route_tick {mode}: no case moved a request")
        check(mode != "midas" or (steered > 0 and binds > 0),
              f"route_tick cases steered {steered} of {eligible}, with a "
              f"binding budget in {binds}: they test too little")
        check(mode != "chbl" or steered > 0, "chbl's cases never steered")
        say(f"[2] route_tick {mode}: {len(TICK_CASES)} ticks at (G, Rg, m, "
            f"d_max, N) = {TICK_SHAPE}"
            + (f", W={TICK_W} (keys repeated within and across waves, live "
               f"and expired pins, f_max 0.3 and 1)" if mode == "midas"
               else "")
            + f", ragged masks, equal to the waves one at a time on assign,"
            f" the views routed on, arrivals, steered, eligible and dV "
            f"(bits; the dV also against steering_dv_waves)"
            + (", pin tables, histories and hist_idx" if mode == "midas"
               else "")
            + (f" ({steered} of {eligible} eligible steered" if mode == "midas"
               else f" ({steered} steered")
            + f"; {moved} ticks with a nonzero dV)")
        fleet_moved = 0
        for seed, f_max, pool in TICK_CASES:
            case = tick_case(torch, np, sim, seed, f_max, pool, policy=mode)
            gt = tick_both(torch, sim, case,
                           f"{mode} fleet views {(seed, f_max, pool)}",
                           fleet_views(torch, np, seed))
            fleet_moved += float(gt.stats.dV) != 0.0
        check(fleet_moved > 0, f"route_tick {mode}'s fleet-view cases never "
              f"moved a request")
        say(f"[2] route_tick {mode} with per-wave base views (fleet "
            f"routing: wave g on its proxy's view alone, no sends shared): "
            f"the same {len(TICK_CASES)} ticks equal to the waves one at a "
            f"time fed the same views on every output")
    # chbl with loads exactly on its cap: the first wave's view on one
    # shared view, every wave's on per-wave views
    case = tick_case(torch, np, sim, 7, 0.3, 40, policy="chbl", on_cap=True)
    feas = case[7]
    feas[0, ::2, 0] = 0  # primaries on the cap: kept (load <= cap)
    feas[0, 1::4, 1] = 3  # a successor on the cap
    gt = tick_both(torch, sim, case, "chbl, loads on the cap")
    kept = gt.assign[0, ::2][case[6][0, ::2]]
    check(bool((kept == 0).all()), "chbl: a primary on the cap was left")
    G, _, m, _, _ = TICK_SHAPE
    views = np.stack([on_the_cap(np, torch, v, (g, g + 3)) for g, v in
                      enumerate(fleet_views(torch, np, 7).cpu().numpy())])
    tick_both(torch, sim, case, "chbl, per-wave views on the cap",
              torch.as_tensor(views).cuda())
    say(f"[2] route_tick chbl with two servers' loads exactly on the cap "
        f"(a fixed point of load_cap): equal to the waves one at a time on "
        f"one view and on {G} per-wave views on the cap; the primaries on "
        f"the cap kept their requests")

    for mode in TICK_POLICIES:
        case = tick_case(torch, np, sim, *TICK_CASES[0], policy=mode)
        cfg, policy, st, knobs, now, keys, mask, feas, draws, consts = case
        before = clone(st.policy)
        k_fn = tick_kernel_call(torch, kernel, case, mode)
        k_fn()
        torch.cuda.synchronize()
        changed = 0 if mode != "midas" else int(
            ((before.pin_server != st.policy.pin_server)
             | (before.pin_expiry != st.policy.pin_expiry)).sum())
        bound = (tick_bytes(np, keys, TICK_W, changed, mode)
                 / HBM_BYTES_PER_S * 1e3)

        def path(impl, case=case):
            cfg, policy, st, knobs, now, keys, mask, feas, draws, consts = \
                case
            return lambda: sim._route_waves(cfg, policy, st, knobs, now,
                                            keys, mask, feas, draws, impl,
                                            consts)

        k_fleet = tick_kernel_call(torch, kernel, case, mode,
                                   fleet_views(torch, np, TICK_CASES[0][0]))
        row = dict(
            name="route_tick", mode=mode, shape=TICK_SHAPE,
            ms=device_ms(torch, [k_fn], N_GRAPH),
            fleet_ms=device_ms(torch, [k_fleet], N_GRAPH),
            plain_ms=device_ms(torch, [path("ref")], 10),
            host_ms=host_ms(torch, k_fn),
            tick_host_ms=host_ms(torch, path("cuda")),
            plain_host_ms=host_ms(torch, path("ref"), 50),
            bound_ms=bound, bound_by="bytes", library_ms=None,
            max_abs_err=0.0)
        if mode == "midas":
            midas_row = row
        say(f"[2] route_tick {mode} (G, Rg, m, d_max, N) = {TICK_SHAPE}: "
            f"device kernel {row['ms'] * 1e3:.3f} us, plain waves "
            f"{row['plain_ms'] * 1e3:.3f} us, bound {bound * 1e3:.4f} us "
            f"(bytes); called one at a time from Python: kernel "
            f"{row['host_ms'] * 1e3:.2f} us, the engine's tick routing "
            f"with it {row['tick_host_ms'] * 1e3:.2f} us, plain waves "
            f"{row['plain_host_ms'] * 1e3:.2f} us; per-wave base views: "
            f"device kernel {row['fleet_ms'] * 1e3:.3f} us")
    return midas_row


# ---------------------------------------------------------------------------
# phase 2 (continued): the route kernels on a membership fault's sets
# ---------------------------------------------------------------------------

# (m, dead servers): phase 3's shape with server 0 dead, and m = 4 with
# three dead, where every row repeats its one live server
MEMBER_CASES = [(64, (0,)), (4, (0, 1, 3))]
MEMBER_ROWS = 512  # route_select rows a case


def phase_member_route(torch, np, sim, kernel, ref):
    """route_tick and route_select fed the feasible sets of a membership
    fault (``feasible_set(member=)``, repeated entries included), each
    bitwise its plain version."""
    from repro_torch.core.faults import base as faults_base

    for m, dead in MEMBER_CASES:
        member = np.ones(m, bool)
        member[list(dead)] = False
        live = torch.as_tensor(member).cuda()
        steered = repeated = 0
        for (seed, f_max, pool), mode in ((c, p) for c in TICK_CASES[:4]
                                          for p in TICK_POLICIES):
            case = tick_case(torch, np, sim, seed, f_max, pool, m=m,
                             member=member, policy=mode)
            feas = case[7]
            check(bool(live[feas.long()].all()),
                  f"member-aware sets at m={m} hold a dead server")
            if mode == "midas":
                repeated += int((feas[..., 1:] == feas[..., :1]).any(-1)
                                .sum())
            gt = tick_both(torch, sim, case, f"{mode} on member-aware sets "
                           f"(m={m}, dead {dead}, seed {seed})")
            # (midas's pins here name any server, dead ones too)
            check(mode == "midas"
                  or bool(live[gt.assign[gt.assign >= 0].long()].all()),
                  f"route_tick {mode} chose a dead server")
            steered += int(gt.stats.steered)
        if m - len(dead) < TICK_SHAPE[3]:
            check(repeated == TICK_SHAPE[0] * TICK_SHAPE[1] * 4,
                  f"m={m}: not every row repeats its live server")
        for variant in range(3):
            feas, load, p50, sampled, tie, scal = route_inputs(
                torch, MEMBER_ROWS, m, 4, seed=1000 + m + variant)
            g = torch.Generator(device="cuda").manual_seed(variant)
            keys = torch.randint(0, FULL["N"], (MEMBER_ROWS,), generator=g,
                                 device="cuda")
            feas = member_feasible(torch, np, keys, m, 4, member)
            for mode in ("power_of_d", "chbl", "midas"):
                args = (feas, load, p50, sampled, tie, scal)
                want = ref.route_select(*args, mode=mode)
                got = kernel.route_select(*args, mode=mode)
                torch.cuda.synchronize()
                for w, k in zip(want, got):
                    check(w.dtype == k.dtype and torch.equal(w, k),
                          f"route_select {mode} on member-aware sets "
                          f"(m={m}, dead {dead}) differs")
                check(bool(live[got[0].long()].all()),
                      f"route_select {mode} chose a dead server")
        width = faults_base._scan_width(m, FULL["V"], member[None])
        say(f"[2] member-aware feasible sets, m={m} with servers {dead} "
            f"dead (scan width {width}, {repeated} rows with a repeated "
            f"entry): route_tick midas, power_of_d and chbl on 4 ticks each "
            f"equal to the waves one at a time on every output and the "
            f"policy state ({steered} steered), power_of_d and chbl never "
            f"a dead server; "
            f"route_select power_of_d, chbl and midas "
            f"on {MEMBER_ROWS} rows x 3 input sets bitwise, never a dead "
            f"server")


# ---------------------------------------------------------------------------
# phase 2 (continued): the attention kernels against their plain versions
# ---------------------------------------------------------------------------

# (B, S, H, KV, D, window, softcap, dtype): the CPU tests' cases, then
# SmolLM-360M's serving shapes (a 512-token prompt; one token against a
# 544-row cache at its last position) and a ragged, padded-head shape;
# prefill also Qwen3-MoE's 512-token prompt;
# decode also a cache no multiple of its span, rows at other positions,
# a window narrower than a span, a 65536-row cache (spans of many
# tiles) and Qwen3-MoE's decode shape; both also at phase 15's shapes:
# MusicGen-Large (32 heads over 32 KV heads, D 64; 512 frames, a 528-row
# cache) and LLaVA-NeXT (32 over 8, D 128; 576 patches + 512 tokens, a
# 1104-row cache)
FA_SHAPES = [
    (1, 128, 4, 2, 64, 0, 0.0, "float32"),
    (2, 256, 8, 8, 64, 0, 0.0, "float32"),
    (1, 256, 4, 1, 128, 0, 0.0, "bfloat16"),
    (1, 256, 8, 2, 64, 64, 0.0, "float32"),
    (1, 128, 4, 4, 64, 0, 50.0, "float32"),
    (1, 256, 2, 2, 256, 128, 30.0, "bfloat16"),
    (2, 100, 6, 2, 20, 24, 20.0, "float32"),
    (1, 512, 15, 5, 64, 0, 0.0, "float32"),
    (1, 512, 64, 4, 128, 0, 0.0, "float32"),
    (1, 512, 32, 32, 64, 0, 0.0, "float32"),
    (1, 1088, 32, 8, 128, 0, 0.0, "float32"),
]
DA_SHAPES = [
    (2, 256, 8, 2, 64, 0, 0.0, "float32"),
    (1, 512, 4, 4, 64, 0, 0.0, "bfloat16"),
    (2, 256, 8, 8, 128, 0, 0.0, "float32"),
    (2, 256, 4, 2, 64, 128, 0.0, "float32"),
    (1, 256, 8, 4, 64, 0, 50.0, "float32"),
    (4, 99, 6, 3, 20, 16, 10.0, "float32"),
    (1, 547, 15, 5, 64, 0, 0.0, "float32"),
    (3, 400, 8, 2, 64, 0, 0.0, "float32"),
    (2, 300, 8, 2, 64, 3, 0.0, "float32"),
    (1, 65536, 64, 4, 128, 0, 0.0, "float32"),
    (1, 544, 15, 5, 64, 0, 0.0, "float32"),
    (1, 544, 64, 4, 128, 0, 0.0, "float32"),
    (1, 528, 32, 32, 64, 0, 0.0, "float32"),
    (1, 1104, 32, 8, 128, 0, 0.0, "float32"),
]
FA_SERVE = (1, 512, 15, 5, 64, 0, 0.0, "float32")
FA_MOE = (1, 512, 64, 4, 128, 0, 0.0, "float32")  # qwen3-moe's prefill
DA_SERVE = (1, 544, 15, 5, 64, 0, 0.0, "float32")
DA_MOE = (1, 544, 64, 4, 128, 0, 0.0, "float32")  # qwen3-moe's decode
# phase 15's serving shapes: MusicGen-Large's and LLaVA-NeXT's
FA_FRONTEND = [(1, 512, 32, 32, 64, 0, 0.0, "float32"),
               (1, 1088, 32, 8, 128, 0, 0.0, "float32")]
DA_FRONTEND = [(1, 528, 32, 32, 64, 0, 0.0, "float32"),
               (1, 1104, 32, 8, 128, 0, 0.0, "float32")]


def attn_tol(dtype):
    """The JAX suite's tolerance (``tests/test_kernels.py:_tol``)."""
    return (2e-2, 2e-2) if dtype == "bfloat16" else (2e-5, 2e-5)


def kept_pairs(S, window, causal=True) -> int:
    """(query, key) pairs of one head that the masks keep."""
    n = 0
    for i in range(S):
        hi = i if causal else S - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        n += hi - lo + 1
    return n


def kept_rows(pos, S, window) -> int:
    """Cache rows one decode row reads (the rows its mask keeps)."""
    hi = min(pos, S - 1)
    lo = max(0, pos - window + 1) if window > 0 else 0
    return max(hi - lo + 1, 0)


def fa_bound(B, S, H, KV, D, window, itemsize, rate=None, lse=False):
    """(bound ms, "bytes" or "operations") of causal attention: q, k, v
    read once and the output (with ``lse`` also the float32 row
    logsumexp the backward reads) written once against 4 D operations
    per kept pair and head on the tensor cores the kernel uses (float32
    as 3xTF32: the TF32 rate over 3), or at ``rate`` FLOP/s (the float32
    CUDA cores' of the CUDA-core kernel, kept for comparison)."""
    if rate is None:
        rate = (BF16_FLOP_PER_S if itemsize == 2 else TF32_FLOP_PER_S / 3)
    byts = (2 * B * S * H * D + 2 * B * S * KV * D) * itemsize
    if lse:
        byts += 4 * B * H * S
    flops = 4 * D * kept_pairs(S, window) * B * H
    t_b, t_f = byts / HBM_BYTES_PER_S, flops / rate
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def da_bound(B, H, KV, D, rows, itemsize):
    """(bound ms, "bytes" or "operations") of decode attention: q, the
    kept K and V rows and the output moved once, 4 D operations per kept
    row and head."""
    byts = (2 * B * H * D + 2 * sum(rows) * KV * D) * itemsize
    flops = 4 * D * H * sum(rows)
    t_b, t_f = byts / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def attn_err(torch, got, want, dtype, what) -> float:
    rtol, atol = attn_tol(dtype)
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: not finite")
    ok = (g - w).abs() <= atol + rtol * w.abs()
    check(bool(ok.all()), f"{what}: differs from the plain version beyond "
          f"rtol={rtol} atol={atol}: max |diff| "
          f"{(g - w).abs().max().item():.3g}")
    return (g - w).abs().max().item()


def phase_attention(torch, fa_kernel, fa_ref, da_kernel, da_ref):
    import torch.nn.functional as F

    rows, max_err = [], {"flash_attention": 0.0, "decode_attention": 0.0}
    for shape in FA_SHAPES:
        B, S, H, KV, D, window, cap, dtype = shape
        g = torch.Generator(device="cuda").manual_seed(S + H + D)
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((B, S, n, D), generator=g, device="cuda",
                               dtype=dt) for n in (H, KV, KV))
        kw = dict(causal=True, window=window, softcap=cap)
        got = fa_kernel.flash_attention(q, k, v, **kw)
        want = fa_ref.mha(q, k, v, **kw)
        torch.cuda.synchronize()
        err = attn_err(torch, got, want, dtype, f"flash_attention {shape}")
        max_err["flash_attention"] = max(max_err["flash_attention"], err)
        # key splits merge in warp order: a repeat is bitwise equal
        check(torch.equal(got, fa_kernel.flash_attention(q, k, v, **kw)),
              f"flash_attention {shape}: a repeated call differs")
        k_fn = lambda: fa_kernel.flash_attention(q, k, v, **kw)  # noqa: E731
        p_fn = lambda: fa_ref.mha(q, k, v, **kw)  # noqa: E731
        lib_ms = None
        if window == 0 and cap == 0.0:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = device_ms(torch, [lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)], N_GRAPH)
        bound, by = fa_bound(B, S, H, KV, D, window, q.element_size())
        simt, _ = fa_bound(B, S, H, KV, D, window, q.element_size(),
                           rate=FP32_FLOP_PER_S)
        rows.append(dict(
            name="flash_attention", shape=shape,
            ms=device_ms(torch, [k_fn], N_GRAPH),
            plain_ms=device_ms(torch, [p_fn], N_GRAPH),
            host_ms=host_ms(torch, k_fn), bound_ms=bound, bound_by=by,
            cuda_core_bound_ms=simt, library_ms=lib_ms, max_abs_err=err))
    for shape in DA_SHAPES:
        B, S, H, KV, D, window, cap, dtype = shape
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(S + H + D)
        # the serving shapes read their cache cold, as a decode step does
        # (the step streams the model's weights between two reads of one
        # layer's cache): 40 input sets (1.4 and 2.3 MB each; 8.7 and
        # 9.0 MB at phase 15's shapes) exceed the L2
        serving = shape in (DA_SERVE, DA_MOE, *DA_FRONTEND)
        n_sets = 40 if serving else 1
        sets = []
        for _ in range(n_sets):
            q = torch.randn((B, H, D), generator=g, device="cuda", dtype=dt)
            kc, vc = (torch.randn((B, S, KV, D), generator=g, device="cuda",
                                  dtype=dt) for _ in range(2))
            sets.append((q, kc, vc))
        positions = [S - 1] * B if serving else torch.randint(
            1, S - 1, (B,), generator=g, device="cuda").tolist()
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        kw = dict(window=window, softcap=cap)
        err = 0.0
        for q, kc, vc in sets:
            got = da_kernel.decode_attention(q, kc, vc, pos, **kw)
            want = da_ref.decode_attention(q, kc, vc, pos, **kw)
            torch.cuda.synchronize()
            err = max(err, attn_err(torch, got, want, dtype,
                                    f"decode_attention {shape}"))
        # the merge runs in split order: a repeat is bitwise equal; and
        # with nothing kept (pos -1) the result is the mean of v
        q, kc, vc = sets[0]
        check(torch.equal(da_kernel.decode_attention(q, kc, vc, pos, **kw),
                          da_kernel.decode_attention(q, kc, vc, pos, **kw)),
              f"decode_attention {shape}: a repeated call differs")
        none = torch.full_like(pos, -1)
        err = max(err, attn_err(
            torch, da_kernel.decode_attention(q, kc, vc, none, **kw),
            da_ref.decode_attention(q, kc, vc, none, **kw), dtype,
            f"decode_attention {shape} pos -1"))
        max_err["decode_attention"] = max(max_err["decode_attention"], err)
        k_fns = [lambda a=a: da_kernel.decode_attention(*a, pos, **kw)
                 for a in sets]
        p_fns = [lambda a=a: da_ref.decode_attention(*a, pos, **kw)
                 for a in sets]
        lib_ms = None
        if cap == 0.0:
            si = torch.arange(S, device="cuda")[None, :]
            mask = si <= pos[:, None].long()
            if window > 0:
                mask &= si > pos[:, None].long() - window
            mask = mask[:, None, None, :]
            lib_ms = device_ms(torch, [
                lambda a=a: F.scaled_dot_product_attention(
                    a[0][:, :, None], a[1].transpose(1, 2),
                    a[2].transpose(1, 2), attn_mask=mask, enable_gqa=True)
                for a in sets], N_GRAPH)
        kept = [kept_rows(int(p), S, window) for p in positions]
        bound, by = da_bound(B, H, KV, D, kept, sets[0][0].element_size())
        rows.append(dict(
            name="decode_attention", shape=shape,
            ms=device_ms(torch, k_fns, N_GRAPH),
            plain_ms=device_ms(torch, p_fns, N_GRAPH),
            host_ms=host_ms(torch, k_fns[0]), bound_ms=bound, bound_by=by,
            library_ms=lib_ms, max_abs_err=err))
    for r in rows:
        lib = ("n/a (window or softcap)" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.3f} us")
        simt = ("" if "cuda_core_bound_ms" not in r else
                f", CUDA-core bound {r['cuda_core_bound_ms'] * 1e3:.3f} us")
        say(f"[2] {r['name']} (B, S, H, KV, D, window, softcap, dtype) = "
            f"{r['shape']}: agrees (max |diff| {r['max_abs_err']:.3g}); "
            f"device kernel {r['ms'] * 1e3:.3f} us, plain "
            f"{r['plain_ms'] * 1e3:.3f} us, sdpa {lib}, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}){simt}; called "
            f"from Python {r['host_ms'] * 1e3:.2f} us")
    return rows, max_err


# ---------------------------------------------------------------------------
# phase 2 (continued): chunk_scan against its plain version
# ---------------------------------------------------------------------------

# (Bt, Q, DI, ST, dtype): the CPU tests' cases, a ragged d_inner,
# bfloat16 inputs, falcon-mamba's smoke chunk (a 16-token prompt, d_inner
# 128, d_state 8), chunks ragged against the kernel's 32-step pass at
# d_state 16 and 64, and the serving chunk (128 steps of d_inner 8192)
CS_SHAPES = [
    (2, 16, 32, 8, "float32"),
    (1, 32, 64, 16, "float32"),
    (2, 16, 32, 8, "bfloat16"),
    (2, 40, 100, 16, "float32"),
    (2, 40, 100, 16, "bfloat16"),
    (1, 16, 128, 8, "float32"),
    (1, 37, 64, 16, "float32"),
    (2, 161, 100, 16, "float32"),
    (1, 37, 24, 64, "bfloat16"),
    (1, 161, 48, 64, "float32"),
    (1, 128, 8192, 16, "float32"),
]
CS_SERVE = (1, 128, 8192, 16, "float32")


def cs_bound(Bt, Q, DI, ST, itemsize):
    """(bound ms, "bytes" or "operations") of one chunk: h0, A, x, dt, B
    and C read once, y and h_out written once (h0, A, y and h_out in
    float32), against Q DI ST exponentials on the special-function
    units and 7 other float32 operations per (step, channel, state) on
    the CUDA cores, whichever of the two takes longer."""
    byts = (4 * (2 * Bt * DI * ST + DI * ST + Bt * Q * DI)
            + itemsize * (2 * Bt * Q * DI + 2 * Bt * Q * ST))
    n = Bt * Q * DI * ST
    t_b = byts / HBM_BYTES_PER_S
    t_o = max(n / EXP_PER_S, 7 * n / FP32_FLOP_PER_S)
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def scan_inputs(torch, Bt, Q, DI, ST, dtype, g):
    """h0, x, dt, A, B, C on the card: A = -exp(N/2), dt = softplus(N),
    as the CPU tests draw them."""
    dt_ = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    h0 = randn(Bt, DI, ST)
    x = randn(Bt, Q, DI).to(dt_)
    dt = torch.nn.functional.softplus(randn(Bt, Q, DI)).to(dt_)
    A = -torch.exp(randn(DI, ST) * 0.5)
    return h0, x, dt, A, randn(Bt, Q, ST).to(dt_), randn(Bt, Q, ST).to(dt_)


def phase_chunk_scan(torch, kernel, ref):
    rows, max_err = [], 0.0
    for shape in CS_SHAPES:
        Bt, Q, DI, ST, dtype = shape
        g = torch.Generator(device="cuda").manual_seed(Q + DI + ST)
        # the serving chunk is timed cold: 6 input sets (86 MB) exceed
        # the 50 MB L2
        n_sets = 6 if shape == CS_SERVE else 1
        sets = [scan_inputs(torch, *shape, g) for _ in range(n_sets)]
        err = 0.0
        for args in sets:
            got = kernel.chunk_scan(*args)
            want = ref.chunk_scan(*args)
            torch.cuda.synchronize()
            for name, gv, wv in zip(("y", "h_out"), got, want):
                check(bool(torch.isfinite(gv).all()),
                      f"chunk_scan {shape}: {name} not finite")
                diff = (gv - wv).abs()
                check(bool((diff <= SCAN_TOL + SCAN_TOL * wv.abs()).all()),
                      f"chunk_scan {shape}: {name} differs from the plain "
                      f"version by {diff.max().item():.3g}")
                err = max(err, diff.max().item())
        max_err = max(max_err, err)
        k_fns = [lambda a=a: kernel.chunk_scan(*a) for a in sets]
        p_fns = [lambda a=a: ref.chunk_scan(*a) for a in sets]
        n = N_GRAPH if shape != CS_SERVE else 24
        bound, by = cs_bound(Bt, Q, DI, ST, sets[0][1].element_size())
        rows.append(dict(
            name="chunk_scan", shape=shape,
            ms=device_ms(torch, k_fns, n), plain_ms=device_ms(torch, p_fns, n),
            host_ms=host_ms(torch, k_fns[0]), bound_ms=bound, bound_by=by,
            library_ms=None, max_abs_err=err))
    for r in rows:
        say(f"[2] chunk_scan (Bt, Q, DI, ST, dtype) = {r['shape']}: agrees "
            f"(max |diff| {r['max_abs_err']:.3g}, allowed {SCAN_TOL} rel + "
            f"abs); device kernel {r['ms'] * 1e3:.3f} us, plain "
            f"{r['plain_ms'] * 1e3:.3f} us, bound {r['bound_ms'] * 1e3:.3f}"
            f" us ({r['bound_by']}); called from Python "
            f"{r['host_ms'] * 1e3:.2f} us")
    return rows, max_err


# ---------------------------------------------------------------------------
# phase 2 (continued): the MoE dispatch kernels against their plain versions
# ---------------------------------------------------------------------------

# (T, E, k, d, f_max): tests/test_kernels.py's MR_CASES and
# MR_FMAX_CASES (ragged T = 37 and 250 included), qwen3-moe's serving
# shapes (a 512-token prompt and one decode token; E 128, top-8, d 2)
# at both f_max, dbrx's E = 16 (top-4) and jamba's (top-2)
MR_SHAPES = [
    (256, 8, 2, 2, 1.0), (256, 16, 4, 2, 1.0), (512, 128, 8, 4, 1.0),
    (256, 4, 2, 2, 1.0), (256, 16, 4, 2, 0.5), (250, 16, 4, 2, 0.25),
    (37, 8, 2, 2, 0.5), (512, 128, 8, 4, 0.25), (250, 16, 4, 2, 1.0),
    (512, 128, 8, 2, 0.25), (512, 128, 8, 2, 1.0), (1, 128, 8, 2, 0.25),
    (1, 128, 8, 2, 1.0), (512, 16, 4, 2, 0.25), (512, 16, 2, 2, 0.25),
    (1, 16, 4, 2, 0.25),
]
# dispatch_steer beyond MR_SHAPES' f_max < 1 cases: f_max 0, the margin
# rule, the most tokens whose state stays in shared memory, and a batch
# whose state leaves it (kernel.STEER_SMEM_T); the register kernel's
# edges: one warp (31, 32) and a block (33), its select's crossover
# (kernel.STEER_COUNT_MAX = 320 tokens) +- 1, its last token (512) and
# the shared-memory kernel's first (513, 1025), k + d = 16 at E = 1024
STEER_EXTRA = [(300, 16, 4, 2, 0.0), (300, 16, 4, 2, 1.0),
               (1, 128, 8, 2, 0.0), (4096, 128, 8, 2, 0.25),
               (5000, 128, 8, 2, 0.25), (31, 128, 8, 2, 0.25),
               (32, 128, 8, 2, 0.25), (33, 128, 8, 2, 0.5),
               (319, 128, 8, 2, 0.25), (320, 128, 8, 2, 0.25),
               (321, 128, 8, 2, 0.25), (513, 128, 8, 2, 0.25),
               (1025, 128, 8, 2, 0.25), (512, 1024, 12, 4, 0.25),
               (200, 1024, 15, 1, 0.9)]
# dispatch_steer's inputs: MR_SHAPES' three, infinite loads, and loads
# under which most benefits clear the floor (its select runs)
STEER_VARIANTS = ("random", "ties", "balanced", "infs", "hot", "hot ties")
# timed: qwen3-moe's decode token (the JSON row) and prefill
MR_TIMED = [(1, 128, 8, 2), (512, 128, 8, 2)]
MR_SERVE = (1, 128, 8, 2)
PARENT_FMAX_PATH_MS = "4.0-6.5 ms"  # the f_max 0.25 dispatch, parent tree


def dispatch_inputs(torch, T, E, seed, variant, k=8):
    """Gate logits (T, E) and load (E,) on the card: skewed loads, so
    tokens steer; ``ties`` rounds both to a few values; ``balanced``
    is the serving path's load of ones, under which nothing steers (every
    benefit -inf); ``infs`` the skewed load with every fifth expert's
    infinite; ``hot`` ranks experts 0, 1, ... about alike for every
    token, within the gate slack, with the load hot on the first k, so
    that most benefits clear the floor and dispatch_steer's quantile
    selects; ``hot ties`` rounds that load."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((T, E), generator=g, device="cuda") * 2.0
    load = torch.randn((E,), generator=g, device="cuda").abs() * 3.0
    if variant == "ties":
        logits = torch.round(logits) / 2.0 + 0.0
        load = torch.round(load)
    if variant == "balanced":
        load = torch.ones_like(load)
    if variant == "infs":
        load[::5] = float("inf")
    if variant.startswith("hot"):
        e = torch.arange(E, device="cuda")
        logits = -0.05 * e[None, :] + 0.02 * logits
        load = torch.where(e < k, 6.0 + load / 3.0, load)
        if variant == "hot ties":
            load = torch.round(load)
    return logits.contiguous(), load


def dispatch_bound(T, E, k, kd, name):
    """(bound ms, "bytes" or "operations") of a dispatch kernel: its
    inputs read once and outputs written once, against its operations
    at the float32 rate.  Candidates: the logits in, ids int32 and
    logits float32 per candidate out, the (k+d)·E compare-selects of a
    row; fused: the logits and the load in, experts int32, weights
    float32 and one steered byte per slot out, the same compares;
    steer: the candidates and the load in, the fused kernel's outputs
    out, 8·T·(k+d) + 4·E + 9·T·k bytes (its arithmetic, a few
    operations a slot and token, is no bound)."""
    if name == "dispatch_steer":
        byts, ops = 8 * T * kd + 4 * E + 9 * T * k, 0
    elif name == "dispatch_fused":
        byts, ops = 4 * T * E + 4 * E + 9 * T * k, T * E * kd
    else:
        byts, ops = 4 * T * E + 8 * T * kd, T * E * kd
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_dispatch(torch, kernel, ref, ops):
    """The three dispatch kernels against the plain version on identical
    inputs: candidates, experts and steered flags equal, weights within
    W_TOL; then their times at the serving shapes, the whole dispatch's
    called from Python, and the launch floor."""
    err = dict.fromkeys(("dispatch_candidates", "dispatch_fused",
                         "dispatch_steer"), 0.0)
    steered = cases = 0
    for (T, E, k, d, f_max), variant in [
            (shape, v) for shape in MR_SHAPES
            for v in ("random", "ties", "balanced")]:
        logits, load = dispatch_inputs(torch, T, E, T + E + k + d, variant)
        what = f"(T, E, k, d, f_max) = {(T, E, k, d, f_max)} {variant}"
        kd = k + min(d, E - k)
        ids, vals = kernel.dispatch_candidates(logits, kd)
        want_ids, want_vals = ref.top_candidates(logits, kd)
        got = ops.midas_dispatch(logits, load, k, d, f_max=f_max,
                                 impl="cuda")
        want = ref.midas_dispatch(logits, load, k, d, f_max=f_max)
        torch.cuda.synchronize()
        check(torch.equal(ids, want_ids), f"dispatch_candidates {what}: "
              f"candidate ids differ")
        check(torch.equal(vals, want_vals), f"dispatch_candidates {what}: "
              f"candidate logits differ")
        check(torch.equal(got[0], want[0]), f"dispatch {what}: experts "
              f"differ")
        check(torch.equal(got[2], want[2]), f"dispatch {what}: steered "
              f"differs")
        w_err = (got[1] - want[1]).abs().max().item()
        check(w_err <= W_TOL, f"dispatch {what}: weights differ by {w_err}")
        name = "dispatch_fused" if f_max >= 1.0 else "dispatch_steer"
        err[name] = max(err[name], w_err)
        if variant == "balanced":
            check(not bool(got[2].any()), f"dispatch {what}: a token "
                  f"steered under balanced load")
        steered += int(got[2].sum())
        cases += 1
    check(steered > 0, "no dispatch case steered")
    say(f"[2] dispatch_candidates, dispatch_fused and dispatch_candidates +"
        f" dispatch_steer through ops.midas_dispatch: {cases} cases "
        f"(tests/test_kernels.py's MR shapes, ragged T, ties, qwen3-moe's "
        f"serving shapes, E = 16) equal to the plain version on "
        f"candidates, experts and steered ({steered} slots steered); "
        f"weights within {max(err.values()):.3g} (allowed {W_TOL})")
    phase_dispatch_steer(torch, kernel, ref, err)

    one = torch.zeros(1, device="cuda")
    floor_ms = device_ms(torch, [lambda: one.add_(1.0)], N_GRAPH)
    say(f"[2] launch floor: a one-element add_ in the same graph replay "
        f"takes {floor_ms * 1e3:.3f} us of device time a call")
    rows = []
    for T, E, k, d in MR_TIMED:
        kd = k + d
        logits, load = dispatch_inputs(torch, T, E, 7, "random")
        cand, vals = kernel.dispatch_candidates(logits, kd)
        fns = {  # name: (kernel, plain version, library call or None)
            "dispatch_candidates": (
                lambda: kernel.dispatch_candidates(logits, kd),
                lambda: ref.top_candidates(logits, kd),
                lambda: torch.topk(logits, kd)),
            "dispatch_fused": (
                lambda: kernel.dispatch_fused(logits, load, k, d),
                lambda: ref.midas_dispatch(logits, load, k, d, f_max=1.0),
                None),
            "dispatch_steer": (
                lambda: kernel.dispatch_steer(cand, vals, load, k,
                                              f_max=0.25),
                lambda: ref.steer_from_candidates(cand, vals, load, k,
                                                  f_max=0.25),
                None),
        }
        for name, (k_fn, p_fn, lib_fn) in fns.items():
            bound, by = dispatch_bound(T, E, k, kd, name)
            rows.append(dict(
                name=name, shape=(T, E, k, d),
                ms=device_ms(torch, [k_fn], N_GRAPH),
                plain_ms=device_ms(torch, [p_fn], N_GRAPH),
                host_ms=host_ms(torch, k_fn),
                bound_ms=bound, bound_by=by,
                library_ms=(None if lib_fn is None
                            else device_ms(torch, [lib_fn], N_GRAPH)),
                max_abs_err=err[name]))
        for f_max in (0.25, 1.0):
            path = host_ms(torch, lambda: ops.midas_dispatch(
                logits, load, k, d, f_max=f_max, impl="cuda"), 200)
            plain = host_ms(torch, lambda: ref.midas_dispatch(
                logits, load, k, d, f_max=f_max), 200)
            parent = (f"; the parent tree's kernel path took "
                      f"{PARENT_FMAX_PATH_MS} (PERF.md)" if f_max < 1 else "")
            say(f"[2] the whole dispatch at f_max {f_max}, (T, E, k, d) = "
                f"{(T, E, k, d)}, called from Python: kernel path "
                f"{path * 1e3:.1f} us, plain {plain * 1e3:.1f} us{parent}")
    for r in rows:
        lib = ("none computes it" if r["library_ms"] is None
               else f"torch.topk {r['library_ms'] * 1e3:.3f} us")
        say(f"[2] {r['name']} (T, E, k, d) = {r['shape']}: device kernel "
            f"{r['ms'] * 1e3:.3f} us, plain {r['plain_ms'] * 1e3:.3f} us, "
            f"{lib}, bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}); "
            f"called from Python {r['host_ms'] * 1e3:.2f} us; launch floor "
            f"{floor_ms * 1e3:.3f} us")
    return rows, err


def phase_dispatch_steer(torch, kernel, ref, err):
    """dispatch_steer against ref.steer_from_candidates on the same
    candidates, at every f_max < 1 case of MR_SHAPES and STEER_EXTRA:
    experts and steered equal, weights within W_TOL; a decode token
    (T = 1) and f_max 0 steer nothing."""
    cases = steered = 0
    shapes = [s for s in MR_SHAPES if s[4] < 1.0] + STEER_EXTRA
    for (T, E, k, d, f_max), variant in [
            (shape, v) for shape in shapes for v in STEER_VARIANTS]:
        logits, load = dispatch_inputs(torch, T, E, T + E + k + d, variant,
                                       k)
        what = f"(T, E, k, d, f_max) = {(T, E, k, d, f_max)} {variant}"
        cand, vals = kernel.dispatch_candidates(logits, k + d)
        got = kernel.dispatch_steer(cand, vals, load, k, f_max=f_max)
        want = ref.steer_from_candidates(cand, vals, load, k, f_max=f_max)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]), f"dispatch_steer {what}: "
              f"experts differ")
        check(torch.equal(got[2], want[2]), f"dispatch_steer {what}: "
              f"steered differs")
        w_err = (got[1] - want[1]).abs().max().item()
        check(w_err <= W_TOL, f"dispatch_steer {what}: weights differ by "
              f"{w_err}")
        err["dispatch_steer"] = max(err["dispatch_steer"], w_err)
        if (T == 1 and variant != "infs") or f_max <= 0.0 or \
                variant == "balanced":
            check(not bool(got[2].any()), f"dispatch_steer {what}: steered")
        steered += int(got[2].sum())
        cases += 1
    check(steered > 0, "no dispatch_steer case steered")
    say(f"[2] dispatch_steer: {cases} cases (MR shapes at f_max < 1, f_max "
        f"0 and 1, T = 1, one warp's and a block's edges, the select's "
        f"crossover +- 1, the register kernel's last token and the "
        f"shared-memory kernel's first, k + d = 16 at E = 1024, T = 5000 "
        f"beyond shared memory; {', '.join(STEER_VARIANTS)}) equal to "
        f"ref.steer_from_candidates on the same candidates on experts and "
        f"steered ({steered} slots steered; none at T = 1 (finite loads), "
        f"f_max 0 or balanced load); weights within "
        f"{err['dispatch_steer']:.3g}")


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


def check_result(np, res, wl, T, m, counts_eligible=True):
    """The engine's own invariants on a finished run (``counts_eligible``:
    the policy reports steer-eligible requests, so steered <= eligible;
    chbl steers without an eligibility count)."""
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
    if counts_eligible:
        check((res.steered <= res.eligible).all(), "steered > eligible")
    check(((res.d_timeline >= 1) & (res.d_timeline <= 4)).all(),
          "d out of bounds")
    check(np.isfinite(res.pressure).all(), "pressure is not finite")


FIELDS = ("queue_timeline", "arrivals", "lat_pred", "d_timeline",
          "delta_l_timeline", "f_max_timeline", "pressure", "steered",
          "eligible", "cache_hits")


def zero_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def kernels_per_tick(torch, sim, cfg, targets, wl,
                     lead=PROFILE_LEAD, metrics="full",
                     ticks=PROFILE_TICKS) -> float:
    """Device kernels a tick of a path, counted by torch.profiler over
    ticks ``lead`` to ``lead`` + ``ticks`` (their horizon set-up
    included) in the given metrics mode, as
    benchmarks_torch/profile_main_path.py counts them."""
    from torch.profiler import ProfilerActivity, profile

    lo, hi = lead, lead + ticks
    st = sim.init_state(cfg, *targets, device="cuda")
    st, _ = sim.run_ticks(cfg, st, wl.keys[:lo], wl.mask[:lo],
                          wl.is_write[:lo])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        sim.run_ticks(cfg, st, wl.keys[lo:hi], wl.mask[lo:hi],
                      wl.is_write[lo:hi], t0=lo, metrics=metrics)
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())
    check(n > 0, "the profiler saw no device events")
    return n / ticks


def phase_main(torch, np, core, sim, counters):
    cfg = core.SimConfig(policy="midas", middleware=("cache",),
                         cache_mode="lease", **FULL)
    wl = core.make_workload("bursty", T=T_FULL, m=cfg.m, seed=SEED,
                            N=cfg.N, R=R_FULL, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    targets = sim.warmup(cfg, device="cuda")
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = time.perf_counter()
    res = core.simulate(cfg, wl, device="cuda")
    run_s = time.perf_counter() - t0
    counts = read_counts(counters)
    want = dict.fromkeys(counters, 0)
    want["route_tick"] = T_FULL
    say(f"[3] launches in the main path: {counts} (expected one route_tick "
        f"a tick, {T_FULL}, and no other kernel)")
    check(counts == want, f"{counts} launches, expected {want}")
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
        f"state on the card {state_bytes / 1e6:.2f} MB, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    per_tick = kernels_per_tick(torch, sim, cfg, targets, wl)
    say(f"[3] main run: {T_FULL / main_s:.1f} ticks/s, {per_tick:.1f} "
        f"kernels a tick (ticks {PROFILE_LEAD}-"
        f"{PROFILE_LEAD + PROFILE_TICKS} profiled); card {card_line()}")
    return cfg, wl, res, targets, counts["route_tick"]


def tree_leaves(tree):
    import torch

    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t)]
    return []


def check_runs_equal(torch, a, b, what, pair="kernel vs plain") -> None:
    """Two run_ticks results (final state, per-tick outputs): every
    per-tick output (dV included) and every leaf of the final state
    bit for bit."""
    (fa, oa), (fb, ob) = a, b
    for f in oa._fields:
        x, y = getattr(oa, f), getattr(ob, f)
        check(x.dtype == y.dtype and torch.equal(x, y),
              f"{what}: {pair}: per-tick {f} differs")
    la, lb = tree_leaves(fa), tree_leaves(fb)
    check(len(la) == len(lb), f"{what}: {pair}: final states differ")
    for i, (x, y) in enumerate(zip(la, lb)):
        check(x.dtype == y.dtype and torch.equal(x, y),
              f"{what}: {pair}: final state leaf {i} differs")


def run_both(torch, sim, cfg, grid, targets):
    """The grid from init_state with the kernels and with the plain
    versions: {impl: ((final state, per-tick outputs), seconds)}."""
    runs = {}
    for impl in ("cuda", "ref"):
        c = dataclasses.replace(cfg, route_impl=impl)
        st = sim.init_state(c, *targets, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim.run_ticks(c, st, *grid)
        torch.cuda.synchronize()
        runs[impl] = (out, time.perf_counter() - t0)
    return runs


def phase_power_of_d(torch, np, core, sim, counters, wl):
    """The baseline policy at the main path's constants: route_tick once
    a tick, equal to its plain run bit for bit."""
    cfg = core.SimConfig(policy="power_of_d", middleware=("cache",),
                         cache_mode="lease", **FULL)
    T = POD_TICKS
    wl = wl._replace(keys=wl.keys[:T], mask=wl.mask[:T],
                     is_write=wl.is_write[:T])
    grid = (wl.keys, wl.mask, wl.is_write)
    zero_counts(counters)
    # the plain run launches no kernel, so the counts are the kernel run's
    runs = run_both(torch, sim, cfg, grid, (0.15, 5.0 * cfg.service_ms))
    counts = read_counts(counters)
    want = dict.fromkeys(counters, 0)
    want["route_tick"] = T
    say(f"[3] launches in the power_of_d run: {counts} (expected one "
        f"route_tick a tick, {T}, and no other kernel)")
    check(counts == want, f"{counts} launches, expected {want}")
    check_runs_equal(torch, runs["cuda"][0], runs["ref"][0], "power_of_d")
    (_, outs), secs = runs["cuda"]
    check_result(np, sim._to_result(cfg, outs, None), wl, T, cfg.m)
    say(f"[3] power_of_d, {T} ticks at the same constants: {T / secs:.1f} "
        f"ticks/s; every per-tick output (dV included) and the final state "
        f"bit-for-bit equal to the plain waves' run "
        f"({runs['ref'][1]:.3f} s)")
    return counts["route_tick"]


def phase_parity(torch, np, core, sim, cfg, wl, res, targets):
    T = PARITY_TICKS
    grid = (wl.keys[:T], wl.mask[:T], wl.is_write[:T])
    runs = run_both(torch, sim, cfg, grid, targets)
    (_, outs), _ = runs["cuda"]
    again = sim._to_result(cfg, outs, None)
    for f in FIELDS:
        check(np.array_equal(getattr(res, f)[:T], getattr(again, f)),
              f"simulate vs run_ticks: {f} differs")
    check_runs_equal(torch, runs["cuda"][0], runs["ref"][0], "midas")
    say(f"[4] {T} ticks with the plain wave loop (route_select's plain "
        f"version, pins and bucket in PyTorch) on the card: every timeline, "
        f"the dV timeline and the final state (pin tables, histories, "
        f"hist_idx) bit-for-bit equal to the route_tick run, which equals "
        f"phase 3's (plain {runs['ref'][1]:.3f} s, kernel "
        f"{runs['cuda'][1]:.3f} s)")


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


# ---------------------------------------------------------------------------
# phase 10: the evaluation plane -- baselines, control laws, ablations,
# the guard, E1/E2
# ---------------------------------------------------------------------------

PLANE_TICKS = 60  # each phase-10 run at phase 3's constants (cut from 100)
PLANE_VARIANTS = (  # midas + cache under each, through route_tick
    dict(ablate="no_margin"), dict(ablate="no_pin"),
    dict(ablate="no_bucket"), dict(controller="aimd"),
    dict(controller="deadband_pid"), dict(controller="static"),
    dict(guard=True),
)
PLANE_BASELINES = ("round_robin", "rr_request", "uniform", "jsq")
# the small card-vs-CPU runs (phase 5's grid): every new policy bare, and
# midas + cache under every new control law, an ablation mix, the guard
PLANE_SMALL = tuple(dict(policy=p) for p in PLANE_BASELINES + ("chbl",)) \
    + tuple(dict(policy="midas", middleware=("cache",), **kw) for kw in (
        dict(controller="aimd"), dict(controller="deadband_pid"),
        dict(controller="static"), dict(ablate="no_margin,no_pin,no_bucket"),
        dict(guard=True)))
GUARD_TICKS = 1200  # the small guard run: two slow windows of 600 ticks
CLAIMS_T = 200  # E1/E2 cut from the paper's T = 3000 for time


def plane_grid(wl, T):
    return wl._replace(keys=wl.keys[:T], mask=wl.mask[:T],
                       is_write=wl.is_write[:T])


def label(kw) -> str:
    return ",".join(f"{k}={v}" for k, v in kw.items() if k != "middleware")


def phase_plane_kernels(torch, np, core, sim, counters, wl, targets):
    """chbl and midas + cache under every new control law, ablation and
    the guard (route_tick once a tick), each against its plain run bit
    for bit.  Returns the launches."""
    T = PLANE_TICKS
    wl = plane_grid(wl, T)
    grid = (wl.keys, wl.mask, wl.is_write)
    runs_cfg = [(core.SimConfig(policy="chbl", **FULL), "route_tick", T,
                 (0.15, 500.0))]
    runs_cfg += [(core.SimConfig(policy="midas", middleware=("cache",),
                                 cache_mode="lease", **FULL, **kw),
                  "route_tick", T, targets) for kw in PLANE_VARIANTS]
    total = dict.fromkeys(counters, 0)
    for cfg, name, n, tg in runs_cfg:
        what = "chbl" if cfg.policy == "chbl" else label(
            {k: getattr(cfg, k) for k in ("ablate", "controller", "guard")
             if getattr(cfg, k) != getattr(core.SimConfig(), k)})
        zero_counts(counters)
        runs = run_both(torch, sim, cfg, grid, tg)
        counts = read_counts(counters)
        want = dict.fromkeys(counters, 0)
        want[name] = n
        check(counts == want, f"{what}: {counts} launches, expected {want}")
        check_runs_equal(torch, runs["cuda"][0], runs["ref"][0], what)
        (final, outs), secs = runs["cuda"]
        res = sim._to_result(cfg, outs, None)
        check_result(np, res, wl, T, cfg.m,
                     counts_eligible=cfg.policy != "chbl")
        extra = ""
        if cfg.guard:
            gi = final.ctrl.inner
            extra = (f"; guard: {int(gi.frozen)} windows frozen at the "
                     f"end, {int(gi.flips)} d flips in the open slow "
                     f"window (T_slow is {cfg.t_slow_ticks} ticks: the "
                     f"breaker is consulted only at a slow tick)")
        say(f"[10] {what}: {n} {name} launches, no other kernel; every "
            f"per-tick output and the final state bit-for-bit its plain "
            f"run; {T / secs:.1f} ticks/s (plain {T / runs['ref'][1]:.1f});"
            f" steered={res.steered.sum():.0f} "
            f"mean_queue={res.mean_queue():.6f}{extra}")
        for k in total:
            total[k] += counts[k]
    for policy in PLANE_BASELINES:
        cfg = core.SimConfig(policy=policy, **FULL)
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = core.simulate(cfg, wl, do_warmup=False, device="cuda")
        secs = time.perf_counter() - t0
        counts = read_counts(counters)
        check(not any(counts.values()), f"{policy} launched {counts}")
        check_result(np, res, wl, T, cfg.m)
        say(f"[10] {policy}: no kernel launched; {T / secs:.1f} ticks/s; "
            f"mean_queue={res.mean_queue():.6f} "
            f"worst_case_queue={res.worst_case_queue():.6f} "
            f"dispersion={res.dispersion():.6f}")
    return total


def phase_plane_small(np, core, sim):
    """Phase 5's card-vs-CPU run for every new policy and control law,
    and a guard run long enough to trip (two slow windows), its trips
    counted window by window on both devices."""
    wl = core.make_workload("bursty", T=400, m=8, seed=3, N=512,
                            device="cpu")
    for kw in PLANE_SMALL:
        cfg = core.SimConfig(m=8, N=512, **kw)
        cpu = core.simulate(cfg, wl, do_warmup=False, device="cpu")
        gpu = core.simulate(cfg, wl, do_warmup=False, device="cuda")
        for f in FIELDS:
            a, b = getattr(cpu, f), getattr(gpu, f)
            if f == "pressure":
                check(np.allclose(a, b, rtol=1e-6, atol=0),
                      f"{label(kw)}: pressure differs")
            else:
                check(np.array_equal(a, b),
                      f"{label(kw)}: card vs CPU: {f} differs")
        say(f"[10] small {label(kw)}: the card equals the CPU; "
            f"steered={cpu.steered.sum():.0f}")
    cfg = core.SimConfig(m=8, N=512, policy="midas", middleware=("cache",),
                         guard=True)
    wl = core.make_workload("bursty", T=GUARD_TICKS, m=8, seed=3, N=512,
                            device="cpu")
    targets = sim.warmup(cfg, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        st = sim.init_state(cfg, *targets, device=dev)
        S, trips, d = cfg.t_slow_ticks, 0, []
        for lo in range(0, GUARD_TICKS, S):
            st, o = sim.run_ticks(
                cfg, st, *(x[lo:lo + S].to(dev)
                           for x in (wl.keys, wl.mask, wl.is_write)),
                t0=lo)
            trips += int(st.ctrl.inner.frozen) == \
                core.controllers.HOLD_WINDOWS
            d.append(o.d.cpu().numpy())
        out[dev] = (trips, np.concatenate(d))
    check(out["cpu"][0] == out["cuda"][0]
          and np.array_equal(out["cpu"][1], out["cuda"][1]),
          "guard: card vs CPU differ")
    say(f"[10] small guard run (m=8, N=512, bursty, T={GUARD_TICKS}, "
        f"warmup targets): {out['cuda'][0]} trips on the card and on the "
        f"CPU, equal d timelines")


def phase_claims(core, counters):
    """E1/E2 at the paper's m = 8 on its five workloads, cut to
    CLAIMS_T ticks: round_robin (no kernel) against power_of_d
    (route_tick once a tick).  Returns the launches."""
    sys.path.insert(0, str(ROOT / "benchmarks_torch"))
    import paper_claims

    zero_counts(counters)
    claims = paper_claims.run(T=CLAIMS_T, device="cuda",
                              out=ROOT / "build" / "paper_claims_smoke",
                              say=lambda line: say(f"[10] {line}"))
    counts = read_counts(counters)
    want = dict.fromkeys(counters, 0)
    want["route_tick"] = len(paper_claims.PAPER_WORKLOADS) * CLAIMS_T
    check(counts == want, f"E1/E2: {counts} launches, expected {want}")
    tps = claims["ticks_per_s"]
    say(f"[10] E1/E2 at T={CLAIMS_T} (cut from 3000): "
        f"{want['route_tick']} route_tick launches (power_of_d), none "
        f"for round_robin; ticks/s round_robin {tps['round_robin']:.1f}, "
        f"power_of_d {tps['power_of_d']:.1f}")
    return counts


# ---------------------------------------------------------------------------
# phase 11: the fleet path -- E9's scenarios served by P proxies with
# gossip, each proxy routing its own wave on its own view
# ---------------------------------------------------------------------------

FLEET = dict(FULL, P=8, policy="midas", middleware=("fleet_cache",),
             fleet_routing=True, gossip_ms=100.0, cache_mode="lease")
FLEET_TICKS = 200  # cut from 300 for time
FLEET_SCENARIO = "rename_storm"
FLEET_PROFILE_LEAD = 150  # the 50-tick profiler window starts here
FLEET_POD_TICKS = 100  # the power_of_d fleet run
FLEET_SMALL_T = 200  # the card-vs-CPU runs at m = 8
# the four E9 scenarios (benchmarks/fleet.py) and the other composed
# workloads; the nine (gossip ms, cache mode) cells of E9 take them in turn
FLEET_SMALL_WL = ("rename_storm", "job_startup", "flash_crowd", "skewed",
                  "multi_tenant", "adversarial", "trace_replay")
FLEET_SMALL_CELLS = tuple((g, mode) for g in (0.0, 100.0, 400.0)
                          for mode in ("lease", "ttl_aggregate",
                                       "ttl_per_key"))
FLEET_COUNTERS = (("hits_p", "hits"), ("misses_p", "misses"),
                  ("stale_p", "stale_serves"), ("bypasses_p", "bypasses"))


def check_fleet_counters(fc, P, what) -> None:
    """The per-proxy counters sum to the aggregate ones."""
    for per, agg in FLEET_COUNTERS:
        check(int(getattr(fc, per).sum()) == int(getattr(fc, agg)),
              f"{what}: {per} sums to {int(getattr(fc, per).sum())}, the "
              f"aggregate {agg} is {int(getattr(fc, agg))}")
    check(tuple(fc.hits_p.shape) == (P,), f"{what}: {P} proxies expected")


def phase_fleet(torch, np, core, sim, counters):
    """The fleet path at phase 3's constants: midas + fleet_cache with
    fleet routing (one route_tick launch a tick, each wave on its proxy's
    view), bitwise its plain run; the Δ = 0 contract; power_of_d under
    fleet routing (route_tick once a tick too); the card against the CPU
    on the composed workloads.  Returns power_of_d's launches."""
    cfg = core.SimConfig(**FLEET)
    T = FLEET_TICKS
    wl = core.make_workload(FLEET_SCENARIO, T=T, m=cfg.m, seed=SEED,
                            N=cfg.N, R=R_FULL, device="cuda")
    grid = (wl.keys, wl.mask, wl.is_write)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    targets = sim.warmup(cfg, device="cuda")
    warm_s = time.perf_counter() - t0

    zero_counts(counters)
    t0 = time.perf_counter()
    res = core.simulate(cfg, wl, device="cuda")
    run_s = time.perf_counter() - t0
    counts = read_counts(counters)
    want = dict.fromkeys(counters, 0)
    want["route_tick"] = T
    say(f"[11] launches in the fleet run: {counts} (expected one route_tick "
        f"a tick, {T}, and no other kernel)")
    check(counts == want, f"{counts} launches, expected {want}")
    check_result(np, res, wl, T, cfg.m)
    fc = res.final_cache
    check_fleet_counters(fc, cfg.P, "fleet run")
    served = int(((fc.hits_p + fc.misses_p) > 0).sum())
    check(served == cfg.P, f"only {served} of {cfg.P} proxies served")
    ring = tensor_bytes((fc.lag_expiry, fc.lag_version))
    main_s = max(run_s - warm_s, 1e-9)
    say(f"[11] {FLEET_SCENARIO} at m={cfg.m} N={cfg.N} R={R_FULL} "
        f"P={cfg.P} gossip {cfg.gossip_ms:g} ms (ring of "
        f"{fc.lag_expiry.shape[0]} ticks, {ring / 1e6:.1f} MB), T={T}: "
        f"mean_queue={res.mean_queue():.6f} "
        f"worst_case_queue={res.worst_case_queue():.6f} "
        f"steered={res.steered.sum():.0f} "
        f"hits={int(fc.hits)} misses={int(fc.misses)} "
        f"stale={int(fc.stale_serves)} bypasses={int(fc.bypasses)}; "
        f"per proxy: hits {fc.hits_p.tolist()}, stale "
        f"{fc.stale_p.tolist()} (they sum to the aggregates)")
    per_tick = kernels_per_tick(torch, sim, cfg, targets, wl,
                                lead=FLEET_PROFILE_LEAD)
    say(f"[11] fleet run: {T / main_s:.1f} ticks/s ({run_s:.3f} s incl. "
        f"warmup, {warm_s:.3f} s alone), {per_tick:.1f} kernels a tick "
        f"(ticks {FLEET_PROFILE_LEAD}-{FLEET_PROFILE_LEAD + PROFILE_TICKS} "
        f"profiled); card {card_line()}")

    runs = run_both(torch, sim, cfg, grid, targets)
    check_runs_equal(torch, runs["cuda"][0], runs["ref"][0], "fleet midas")
    again = sim._to_result(cfg, runs["cuda"][0][1], None)
    for f in FIELDS:
        check(np.array_equal(getattr(res, f), getattr(again, f)),
              f"fleet: simulate vs run_ticks: {f} differs")
    say(f"[11] the same {T} ticks with the plain wave loop: every per-tick "
        f"output (dV included) and the final state (FleetState: the "
        f"converged table, the gossip log, the lag ring, hits_p, misses_p, "
        f"stale_p, bypasses_p; the pin tables and histories) bit-for-bit "
        f"equal to the route_tick run ({T / runs['cuda'][1]:.1f} ticks/s, "
        f"plain {T / runs['ref'][1]:.1f})")

    fleet0 = dataclasses.replace(cfg, gossip_ms=0.0, fleet_routing=False)
    shared = dataclasses.replace(fleet0, middleware=("cache",))
    (fa, oa), (fb, ob) = (
        sim.run_ticks(c, sim.init_state(c, *targets, device="cuda"), *grid)
        for c in (fleet0, shared))
    for f in oa._fields:
        check(torch.equal(getattr(oa, f), getattr(ob, f)),
              f"Δ=0: per-tick {f} differs from the shared cache's")
    for i, (x, y) in enumerate(zip(tree_leaves(fa.mw[0].shared),
                                   tree_leaves(fb.mw[0]))):
        check(torch.equal(x, y), f"Δ=0: table leaf {i} differs")
    check(all(torch.equal(x, y) for x, y in
              zip(tree_leaves(fa.policy), tree_leaves(fb.policy))),
          "Δ=0: the policy state differs")
    check_fleet_counters(fa.mw[0], cfg.P, "Δ=0 fleet run")
    say(f"[11] Δ=0: a gossip_ms=0 fleet run (fleet routing off) equals the "
        f"shared ('cache',) run bit for bit: every per-tick output, the "
        f"table, the counters ({int(fb.mw[0].hits)} hits, "
        f"{int(fb.mw[0].stale_serves)} stale) and the policy state")

    pod = dataclasses.replace(cfg, policy="power_of_d")
    n = FLEET_POD_TICKS
    zero_counts(counters)
    runs = run_both(torch, sim, pod, tuple(x[:n] for x in grid),
                    (0.15, 5.0 * cfg.service_ms))
    counts = read_counts(counters)
    want = dict.fromkeys(counters, 0)
    want["route_tick"] = n
    check(counts == want, f"power_of_d fleet: {counts}, expected {want}")
    check_runs_equal(torch, runs["cuda"][0], runs["ref"][0],
                     "power_of_d fleet")
    say(f"[11] power_of_d under fleet routing, {n} ticks: "
        f"{want['route_tick']} route_tick launches (each proxy's wave on "
        f"its own view), no other kernel; bit-for-bit its plain run; "
        f"{n / runs['cuda'][1]:.1f} ticks/s")
    pod_launches = counts["route_tick"]

    for i, (gossip, mode) in enumerate(FLEET_SMALL_CELLS):
        name = FLEET_SMALL_WL[i % len(FLEET_SMALL_WL)]
        small = core.SimConfig(m=8, P=8, policy="midas",
                               middleware=("fleet_cache",),
                               fleet_routing=True, gossip_ms=gossip,
                               cache_mode=mode)
        swl = core.make_workload(name, T=FLEET_SMALL_T, m=8, seed=i,
                                 device="cpu")
        cpu = core.simulate(small, swl, do_warmup=False, device="cpu")
        gpu = core.simulate(small, swl, do_warmup=False, device="cuda")
        what = f"{name}, gossip {gossip:g} ms, {mode}"
        for f in FIELDS:
            a, b = getattr(cpu, f), getattr(gpu, f)
            if f == "pressure":
                check(np.allclose(a, b, rtol=1e-6, atol=0),
                      f"{what}: pressure differs")
            else:
                check(np.array_equal(a, b), f"{what}: card vs CPU: {f} "
                      f"differs")
        for per, agg in FLEET_COUNTERS:
            for x in (per, agg):
                check(torch.equal(getattr(cpu.final_cache, x),
                                  getattr(gpu.final_cache, x).cpu()),
                      f"{what}: card vs CPU: {x} differs")
        say(f"[11] small {what} (m=8, T={FLEET_SMALL_T}, CPU-realized): "
            f"the card equals the CPU; steered={cpu.steered.sum():.0f} "
            f"hits={int(cpu.final_cache.hits)} "
            f"stale={int(cpu.final_cache.stale_serves)}")
    return pod_launches


# ---------------------------------------------------------------------------
# phase 12: the fault layer -- E12's scenario under E13's compound
# programs at phase 11's full width
# ---------------------------------------------------------------------------

FAULT_TICKS = 300  # the first 300 ticks of phase 3's bursty grid
FAULT_POD_TICKS = 100  # the power_of_d run under the same program
FAULT_OFF_TICKS = 100  # the zero-cost and proxy_join runs
FAULT_PROFILE = ((150, 200), (250, 300))  # in and after the fault window
# benchmarks/resilience.py (E12): its config, horizon, seeds and the
# recovery rule's hold; (d) cuts the horizon to 150 ticks and divides
# every event's t0 and duration by 6, for time
E12 = dict(m=8, N=1024, middleware=("fleet_cache",), gossip_ms=100.0)
# the headline runs seed 0 alone, for time (E12 averages seeds 0 and 1)
E12_T, E12_SEEDS, E12_HOLD = 900, (0,), 20
E12_SMALL_T, E12_CUT = 150, 6
E12_CELLS = (("midas", "hysteresis"), ("round_robin", "static"),
             ("power_of_d", "hysteresis"))


def fault_program(faults, cut=1):
    """E13's three compound programs (benchmarks/redteam.py), retimed to
    400 ticks and applied together; every time divided by ``cut``."""
    ev = faults.FaultEvent
    return (
        faults.overlap(
            ev("ckpt_storm_fleet", t0=100 // cut, duration=150 // cut,
               magnitude=0.6),
            ev("proxy_crash", t0=120 // cut, duration=120 // cut,
               target=0))
        + faults.rolling("server_brownout", targets=(1, 2, 3),
                         t0=100 // cut, duration=80 // cut,
                         stagger=50 // cut, magnitude=0.3)
        + (faults.CascadeEvent(
            trigger=ev("proxy_crash", t0=120 // cut, duration=120 // cut,
                       target=0),
            effect=ev("gossip_partition", t0=0, duration=100 // cut,
                      target=-1),
            offset=10 // cut),))


def e12_blocks(faults, cut=1):
    """E12's six fault blocks, every t0 and duration divided by ``cut``."""
    ev = faults.FaultEvent
    return {
        "none": None,
        "proxy_crash": (ev("proxy_crash", t0=300 // cut,
                           duration=250 // cut, target=0),),
        "proxy_join": (ev("proxy_join", t0=300 // cut, target=0),),
        "server_brownout": (ev("server_brownout", t0=300 // cut,
                               duration=250 // cut, target=1,
                               magnitude=0.25),),
        "gossip_partition": (ev("gossip_partition", t0=300 // cut,
                                duration=250 // cut, target=-1),),
        "ckpt_storm_fleet": (ev("ckpt_storm_fleet", t0=300 // cut,
                                duration=200 // cut, magnitude=0.6),),
    }


def recovery_ms(mean_q, t_clear, band, dt_ms) -> float:
    """E12's recovery rule (benchmarks/resilience.py): ms from the fault
    clearing until the mean queue stays within ``band`` for E12_HOLD
    ticks; the remaining horizon when it never re-enters."""
    run = 0
    for i, good in enumerate(mean_q[t_clear:] <= band):
        run = run + 1 if good else 0
        if run >= E12_HOLD:
            return float((i - E12_HOLD + 1) * dt_ms)
    return float(len(mean_q[t_clear:]) * dt_ms)


class TickProbe:
    """Wraps the engine's tick for one run: records the remap masks the
    engine makes (their ticks), the availability each tick's fleet stage
    is handed, and profiles the device kernels of chosen tick windows."""

    def __init__(self, torch, sim, core, windows=()):
        self.torch, self.sim, self.core = torch, sim, core
        self.windows = windows
        self.flips, self.avail, self.kernels = [], [], []
        self.prof = None

    def __enter__(self):
        from repro_torch.core import faults, middleware

        sim, torch = self.sim, self.torch
        self.saved = (sim._tick, faults.moved_mask,
                      middleware.FleetCache.on_batch)
        tick, moved, on_batch = self.saved
        probe = self

        def probed_tick(cfg, policy, mws, controller, impl, consts, hz, t,
                        state):
            starts = [lo for lo, _ in probe.windows]
            ends = [hi for _, hi in probe.windows]
            if t in starts:
                probe.start()
            out = tick(cfg, policy, mws, controller, impl, consts, hz, t,
                       state)
            if t + 1 in ends:
                probe.stop(ends.index(t + 1))
            return out

        def probed_moved(fc, fx, t):
            probe.flips.append(t)
            return moved(fc, fx, t)

        def probed_batch(mw, state, batch, cfg):
            if batch.faults is not None:
                probe.avail.append(batch.faults.avail)
            return on_batch(mw, state, batch, cfg)

        sim._tick = probed_tick
        faults.moved_mask = probed_moved
        middleware.FleetCache.on_batch = probed_batch
        return self

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self, i):
        torch = self.torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in self.prof.events())
        lo, hi = self.windows[i]
        self.kernels.append(n / (hi - lo))
        self.prof = None

    def __exit__(self, *exc):
        from repro_torch.core import faults, middleware

        (self.sim._tick, faults.moved_mask,
         middleware.FleetCache.on_batch) = self.saved
        return False


def phase_faults(torch, np, core, sim, counters, wl3):
    """E12's scenario (the first 300 ticks of phase 3's bursty grid)
    under E13's compound programs at phase 11's constants: midas through
    route_tick bitwise its plain run, with the fault layer's invariants;
    power_of_d through route_tick too; zero cost when off and
    proxy_join; the card against the CPU over E12's fault blocks; E12's
    headline.  Returns route_tick's launches (midas, power_of_d)."""
    from repro_torch.core import faults

    T = FAULT_TICKS
    program = fault_program(faults)
    cfg = core.SimConfig(**FLEET, faults=program)
    wl = plane_grid(wl3, T)
    grid = (wl.keys, wl.mask, wl.is_write)
    fc = faults.compile_faults(cfg, T)
    flips = [int(t) for t in fc.flips]
    crash, rejoin = 120, 240
    detect = crash + fc.timeout_ticks
    check(flips == [detect, rejoin],
          f"the compiled schedule flips at {flips}, expected "
          f"{[detect, rejoin]}")

    # (a) the full-width run through simulate, with warmup
    t_a = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    targets = sim.warmup(cfg, device="cuda")
    warm_s = time.perf_counter() - t0
    zero_counts(counters)
    with TickProbe(torch, sim, core) as probe:
        t0 = time.perf_counter()
        res = core.simulate(cfg, wl, device="cuda")
        run_s = time.perf_counter() - t0
    counts = read_counts(counters)
    want = dict.fromkeys(counters, 0)
    want["route_tick"] = T
    say(f"[12] launches in the faulted fleet run: {counts} (expected one "
        f"route_tick a tick, {T}, and no other kernel)")
    check(counts == want, f"{counts} launches, expected {want}")
    check(probe.flips == flips,
          f"remap invalidation ran at ticks {probe.flips}, the schedule "
          f"flips at {flips}")
    # the storm's writes join the offered traffic: check against its grid
    st_keys, st_mask, st_w = faults.apply_traffic(fc, *grid)
    check_result(np, res, wl._replace(mask=st_mask), T, cfg.m)
    # after detection no feasible set holds server 0; only a pin made
    # before it (live for at most PIN_C_MS) may still send a key there
    arr, q = res.arrivals, res.queue_timeline
    lo = detect + int(np.ceil(core.controllers.PIN_C_MS / cfg.dt_ms))
    pinned = float(arr[detect:lo, 0].sum())
    check((arr[lo:rejoin, 0] == 0).all(),
          f"the dead server got {arr[lo:rejoin, 0].sum():.0f} arrivals "
          f"between detection (+ the pin time) and rejoin")
    check((q[lo - 1:rejoin, 0] == q[lo - 1, 0]).all(),
          "the dead server's queue moved between detection and rejoin")
    avail = torch.stack(probe.avail).cpu().numpy()
    degraded = ~fc.detected.all(axis=1)
    check(avail.shape == (T,) and np.array_equal(
        avail < faults.AVAIL_FULL, degraded),
        "avail is not below AVAIL_FULL exactly on the detected-degraded "
        "ticks")
    fl = res.final_cache
    check_fleet_counters(fl, cfg.P, "faulted fleet run")
    main_s = max(run_s - warm_s, 1e-9)
    storm = int(st_mask.sum().item()) - int(wl.mask.sum().item())
    say(f"[12] E12's bursty grid (ticks 0-{T} of phase 3's) at m={cfg.m} "
        f"N={cfg.N} R={R_FULL} P={cfg.P} gossip {cfg.gossip_ms:g} ms, "
        f"fleet routing, under E13's three programs together (storm "
        f"100-250 mag 0.6, crash of server 0 120-240, rolling brownouts "
        f"of servers 1-3 from 100, partition of every proxy "
        f"{detect + 10}-{detect + 110}): flips at {flips} (detection "
        f"{fc.timeout_ticks} ticks after the crash), remap invalidation "
        f"at exactly those ticks; server 0 got {pinned:.0f} arrivals over "
        f"[{detect}, {lo}) (pins made before detection), none over "
        f"[{lo}, {rejoin}), and its queue stayed at {q[lo - 1, 0]:.1f}; avail "
        f"< AVAIL_FULL on exactly the {int(degraded.sum())} degraded "
        f"ticks; {storm} storm writes; mean_queue={res.mean_queue():.6f} "
        f"worst_case_queue={res.worst_case_queue():.6f} "
        f"steered={res.steered.sum():.0f} hits={int(fl.hits)} "
        f"stale={int(fl.stale_serves)} bypasses={int(fl.bypasses)} (the "
        f"per-proxy counters sum to them)")
    with TickProbe(torch, sim, core, FAULT_PROFILE) as prof:
        st = sim.init_state(cfg, *targets, device="cuda")
        sim.run_ticks(cfg, st, *grid)
    say(f"[12] faulted fleet run: {T / main_s:.1f} ticks/s ({run_s:.3f} s "
        f"incl. warmup, {warm_s:.3f} s alone); kernels a tick "
        + ", ".join(f"{k:.1f} over ticks {lo}-{hi}" for k, (lo, hi) in
                    zip(prof.kernels, FAULT_PROFILE))
        + f" (the tick alone, torch.profiler); card {card_line()}")
    runs = run_both(torch, sim, cfg, grid, targets)
    check_runs_equal(torch, runs["cuda"][0], runs["ref"][0],
                     "faulted fleet midas")
    again = sim._to_result(cfg, runs["cuda"][0][1], None)
    for f in FIELDS:
        check(np.array_equal(getattr(res, f), getattr(again, f)),
              f"faulted: simulate vs run_ticks: {f} differs")
    say(f"[12] the same {T} ticks with the plain wave loop: every per-tick "
        f"output (dV included) and the final state (the whole FleetState, "
        f"the pin tables and histories) bit-for-bit equal to the "
        f"route_tick run ({T / runs['cuda'][1]:.1f} ticks/s, plain "
        f"{T / runs['ref'][1]:.1f})")
    tick_launches = T

    say(f"[12] (a) took {time.perf_counter() - t_a:.1f} s")

    # (b) power_of_d under the same program and fleet routing
    t_b = time.perf_counter()
    n = FAULT_POD_TICKS
    pod = dataclasses.replace(cfg, policy="power_of_d")
    zero_counts(counters)
    runs = run_both(torch, sim, pod, tuple(x[:n] for x in grid),
                    (0.15, 5.0 * cfg.service_ms))
    counts = read_counts(counters)
    want = dict.fromkeys(counters, 0)
    want["route_tick"] = n
    check(counts == want, f"faulted power_of_d: {counts}, expected {want}")
    check_runs_equal(torch, runs["cuda"][0], runs["ref"][0],
                     "faulted power_of_d")
    say(f"[12] power_of_d under the same program and fleet routing, {n} "
        f"ticks: {want['route_tick']} route_tick launches, no other "
        f"kernel; bit-for-bit its plain run; {n / runs['cuda'][1]:.1f} "
        f"ticks/s ((b) took {time.perf_counter() - t_b:.1f} s)")
    pod_launches = counts["route_tick"]

    # (c) zero cost when off, then proxy_join at full width
    t_c = time.perf_counter()
    n = FAULT_OFF_TICKS
    short = tuple(x[:n] for x in grid)
    zero_counts(counters)
    outs = {}
    for name, fa in (("None", None), ("()", ()),
                     ("benign", (faults.FaultEvent("proxy_crash", t0=n + 50,
                                                   target=0),))):
        c = dataclasses.replace(cfg, faults=fa)
        outs[name] = sim.run_ticks(c, sim.init_state(c, *targets,
                                                     device="cuda"), *short)
    for name in ("()", "benign"):
        (fa, oa), (fb, ob) = outs["None"], outs[name]
        for f in oa._fields:
            check(torch.equal(getattr(oa, f), getattr(ob, f)),
                  f"faults={name}: per-tick {f} differs from faults=None")
        for i, (x, y) in enumerate(zip(tree_leaves(fa), tree_leaves(fb))):
            check(torch.equal(x, y),
                  f"faults={name}: final state leaf {i} differs")
    join = dataclasses.replace(
        cfg, faults=(faults.FaultEvent("proxy_join", t0=50, target=0),))
    runs = run_both(torch, sim, join, short, targets)
    check_runs_equal(torch, runs["cuda"][0], runs["ref"][0], "proxy_join")
    counts = read_counts(counters)
    check(counts["route_tick"] == 4 * n and sum(counts.values()) == 4 * n,
          f"zero-cost and proxy_join runs launched {counts}")
    jflips = [int(t) for t in faults.compile_faults(join, n).flips]
    (_, jo), _ = runs["cuda"]
    check(jflips == [fc.timeout_ticks, 50],
          f"proxy_join flips at {jflips}")
    absent = int(jo.arrivals[jflips[0] + 6:50, 0].sum().item())
    check(absent == 0, "the absent server got arrivals once detected")
    say(f"[12] zero cost when off, {n} ticks at full width: faults=() and a "
        f"benign event (t0 past the horizon) equal faults=None bit for bit "
        f"(every per-tick output, the final state); proxy_join (t0=50, "
        f"server 0; presumed alive for the detection window, so flips at "
        f"{jflips}) bit-for-bit its plain run, no arrivals to server 0 "
        f"from {jflips[0] + 6} (detection + the pin time) until it joins "
        f"((c) took {time.perf_counter() - t_c:.1f} s)")
    tick_launches += 4 * n

    # (d) the card against the CPU over E12's fault blocks
    blocks = e12_blocks(faults, E12_CUT)
    swl = core.make_workload("bursty", T=E12_SMALL_T, m=E12["m"], seed=0,
                             N=E12["N"], device="cpu")
    t0 = time.perf_counter()
    # each block under one (policy, controller) cell in turn, so every
    # cell meets two blocks: a cut from the 18 pairs, for time
    for i, (block, events) in enumerate(blocks.items()):
        for policy, ctrl in (E12_CELLS[i % len(E12_CELLS)],):
            small = core.SimConfig(**E12, policy=policy, controller=ctrl,
                                   faults=events)
            cpu = core.simulate(small, swl, do_warmup=False, device="cpu")
            gpu = core.simulate(small, swl, do_warmup=False, device="cuda")
            what = f"E12 {block}, {policy}+{ctrl}"
            for f in FIELDS:
                a, b = getattr(cpu, f), getattr(gpu, f)
                if f == "pressure":
                    check(np.allclose(a, b, rtol=1e-6, atol=0),
                          f"{what}: pressure differs")
                else:
                    check(np.array_equal(a, b),
                          f"{what}: card vs CPU: {f} differs")
            for i, (x, y) in enumerate(zip(tree_leaves(cpu.final_cache),
                                           tree_leaves(gpu.final_cache))):
                check(torch.equal(x, y.cpu()),
                      f"{what}: card vs CPU: FleetState leaf {i} differs")
    say(f"[12] E12's six fault blocks, each under one of the "
        f"{len(E12_CELLS)} (policy, controller) cells in turn, at "
        f"m={E12['m']} N={E12['N']}, T={E12_SMALL_T} (cut from {E12_T}, t0 "
        f"and durations / {E12_CUT}), CPU-realized grid: the card equals "
        f"the CPU on every output and the FleetState "
        f"({time.perf_counter() - t0:.1f} s)")

    # (e) E12's headline at its own horizon, on port-realized grids
    t_e = time.perf_counter()
    ewl = core.make_workload("bursty", T=E12_T, m=E12["m"], seed=0,
                             N=E12["N"], device="cuda")
    crash = e12_blocks(faults)["proxy_crash"]
    fc12 = faults.compile_faults(
        core.SimConfig(**E12, faults=crash), E12_T)
    active = np.flatnonzero(fc12.active)
    a0, a1 = int(active[0]), int(active[-1])
    head = {}
    for policy, ctrl in E12_CELLS[:2]:
        mq = {}
        for block in ("none", "proxy_crash"):
            qs = []
            for seed in E12_SEEDS:
                c = core.SimConfig(**E12, policy=policy, controller=ctrl,
                                   faults=None if block == "none" else
                                   crash, seed=seed)
                r = core.simulate(c, ewl, do_warmup=False, device="cuda")
                qs.append(r.queue_timeline)
            mq[block] = np.stack(qs)
        mu = float(mq["none"].mean(axis=2).mean())
        band = max(1.5 * mu, mu + 0.5)
        mean_q = mq["proxy_crash"].mean(axis=2)
        rec = [recovery_ms(mean_q[s], a1 + 1, band, 50.0)
               for s in range(len(E12_SEEDS))]
        head[f"{policy}+{ctrl}"] = dict(
            recovery_ms=float(np.mean(rec)),
            peak=float(mq["proxy_crash"][:, a0:a1 + 1].max()), band=band)
    ad, sta = head["midas+hysteresis"], head["round_robin+static"]
    say("[12] " + json.dumps({"e12_headline": {
        "crash_recovery_ms_adaptive": ad["recovery_ms"],
        "crash_recovery_ms_static": sta["recovery_ms"],
        "adaptive_recovers_faster": ad["recovery_ms"] < sta["recovery_ms"],
        "crash_peak_adaptive": ad["peak"], "crash_peak_static": sta["peak"],
        "band_adaptive": ad["band"], "band_static": sta["band"],
        "T": E12_T, "seeds": list(E12_SEEDS), "grid": "port-realized",
        "seconds": time.perf_counter() - t_e}}))
    return tick_launches, pod_launches


# ---------------------------------------------------------------------------
# phase 13: sweeps at full width -- SweepSpec / run_sweep in both metrics
# modes, the cells one after another through the engine
# ---------------------------------------------------------------------------

SWEEP_TICKS = 50  # the 24-cell sweeps (100 before, cut for time)
E13_SWEEP_TICKS = 100  # the faulted sweep: E13's program retimed to 100
SWEEP_POLICIES = ("midas", "power_of_d", "round_robin")
SWEEP_CONTROLLERS = ("hysteresis", "static")
SWEEP_SEEDS = (0, 1)
SWEEP_PROFILE = (10, 40)  # kernels a tick over ticks 10-50 of one cell
# E13's crash_during_storm (benchmarks/redteam.py: a storm over 400-700
# with a crash of server 0 over 450-650, of 1200 ticks) retimed to 100
E13_SWEEP = dict(FULL, policy="midas", middleware=("fleet_cache",), P=8,
                 gossip_ms=100.0, cache_mode="lease")
E13_CONTROLLERS = ("hysteresis", "aimd")
SUMMARY_FIELDS = ("n_ticks", "queue_sum", "queue_max_v", "cv_sum",
                  "cv_count", "queue_hist", "lat_hist", "arrivals_total",
                  "steered_total", "eligible_total", "cache_hits_total",
                  "d_timeline", "delta_l_timeline", "f_max_timeline",
                  "pressure", "q_mean_timeline")


def rows_equal(np, a, b, fields) -> bool:
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if x.dtype != y.dtype or not np.array_equal(x, y):
            return False
    return True


def stand_alone(sim, cfg, wl, targets):
    """``simulate``'s own steps for one cell, with ``targets``."""
    st = sim.init_state(cfg, *targets, device="cuda")
    final, outs = sim.run_ticks(cfg, st, wl.keys, wl.mask, wl.is_write)
    return sim._to_result(cfg, outs, sim._final_cache(cfg, final))


def e13_storm_crash(faults):
    ev = faults.FaultEvent
    return faults.overlap(
        ev("ckpt_storm_fleet", t0=33, duration=25, magnitude=0.6),
        ev("proxy_crash", t0=38, duration=17, target=0))


def phase_sweeps(torch, np, core, sim, counters, wl3, targets):
    """Phase 3's constants swept over policies × controllers × (bursty,
    storm) × seeds in both metrics modes, with phase 3's targets; then
    E13's crash_during_storm on the fleet cache as a faults= override,
    with the sweep's own warmup.  Returns route_tick's launches."""
    from repro_torch.core import faults
    from repro_torch.obs import trace as obs_trace

    T = SWEEP_TICKS
    cfg = core.SimConfig(policy="midas", middleware=("cache",),
                         cache_mode="lease", **FULL)
    t0 = time.perf_counter()
    storm = core.make_workload("storm", T=T, m=cfg.m, seed=SEED, N=cfg.N,
                               R=R_FULL, device="cuda")
    torch.cuda.synchronize()
    grids = (plane_grid(wl3, T), storm)
    say(f"[13] grids: the first {T} ticks of phase 3's bursty grid and a "
        f"storm grid made on the card ({time.perf_counter() - t0:.2f} s)")
    res, peak, kpt = {}, {}, {}
    n_pol = len(SWEEP_CONTROLLERS) * len(grids) * len(SWEEP_SEEDS)
    for mode in ("full", "summary"):
        spec = core.SweepSpec(config=cfg, workloads=grids,
                              policies=SWEEP_POLICIES,
                              controllers=SWEEP_CONTROLLERS,
                              seeds=SWEEP_SEEDS, metrics=mode,
                              targets=targets)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        obs_trace.configure(enabled=True, fresh=True)
        zero_counts(counters)
        t0 = time.perf_counter()
        res[mode] = core.run_sweep(spec, device="cuda")
        secs = time.perf_counter() - t0
        counts = read_counts(counters)
        peak[mode] = (torch.cuda.max_memory_allocated(), before)
        want = dict.fromkeys(counters, 0)
        # midas and power_of_d, one route_tick a tick each
        want["route_tick"] = 2 * n_pol * T
        say(f"[13] launches in the {mode} sweep: {counts} (expected "
            f"{want['route_tick']} route_tick and no other kernel)")
        check(counts == want, f"{mode} sweep: {counts}, expected {want}")
        check(len(res[mode].cells) == spec.n_cells == 3 * n_pol,
              f"{mode} sweep has {len(res[mode].cells)} rows")
        spans = [e for e in obs_trace.RECORDER.events
                 if e["name"] == "sweep/execute"]
        check(len(spans) == len(SWEEP_POLICIES) * len(SWEEP_CONTROLLERS),
              f"{len(spans)} sweep/execute spans")
        rate = {}
        for p in SWEEP_POLICIES:
            us = sum(e["dur"] for e in spans if e["args"]["policy"] == p)
            rate[p] = n_pol * T / (us * 1e-6)
        lead, n = SWEEP_PROFILE
        kpt[mode] = kernels_per_tick(torch, sim, cfg, targets, grids[0],
                                     lead=lead, metrics=mode, ticks=n)
        say(f"[13] {mode} sweep, {spec.n_cells} cells x {T} ticks in "
            f"{secs:.3f} s; ticks/s by policy (sweep/execute spans): "
            + ", ".join(f"{p} {r:.1f}" for p, r in rate.items())
            + f"; midas {kpt[mode]:.1f} kernels a tick (ticks "
            f"{lead}-{lead + n}); "
            f"peak allocated {peak[mode][0] / 1e6:.1f} MB "
            f"({(peak[mode][0] - peak[mode][1]) / 1e6:.1f} MB above the "
            f"{peak[mode][1] / 1e6:.1f} MB held before); card "
            f"{card_line()}")
    full, summ = res["full"], res["summary"]
    by_name = {w.name: w for w in grids}
    for coord, row in full.items():
        check_result(np, row, by_name[coord[2]], T, cfg.m)
        s = summ.cells[coord]
        check(all(getattr(s, f).shape == (T,) for f in SUMMARY_FIELDS
                  if f.endswith("timeline") or f == "pressure"),
              f"{coord}: a summary trace is not (T,)")
        check(rows_equal(np, core.summarize(row, device="cuda"), s,
                         SUMMARY_FIELDS),
              f"{coord}: the summary row is not summarize of the full row")
    say(f"[13] every one of the {len(summ.cells)} summary rows is "
        f"summarize(full row) bit for bit (sums, max, CV sums, both "
        f"HistSketch histograms, totals, the (T,) knob traces and q_mean); "
        f"no summary row holds a (T, m) array; peak allocated full "
        f"{peak['full'][0] / 1e6:.1f} MB, summary "
        f"{peak['summary'][0] / 1e6:.1f} MB; midas kernels a tick full "
        f"{kpt['full']:.1f}, summary {kpt['summary']:.1f}")
    # two rows against their single runs
    mid = dataclasses.replace(cfg, seed=1)
    alone = core.simulate(mid, grids[0], device="cuda")
    check(rows_equal(np, alone, full.row("midas", "hysteresis", "bursty", 1),
                     FIELDS), "midas x hysteresis x bursty x 1 is not its "
          "simulate (warmup included: phase 3's targets)")
    pod = dataclasses.replace(cfg, policy="power_of_d", controller="static")
    alone = stand_alone(sim, pod, grids[1], targets)
    check(rows_equal(np, alone, full.row("power_of_d", "static", "storm", 0),
                     FIELDS), "power_of_d x static x storm x 0 is not its "
          "single run")
    say("[13] midas x hysteresis x bursty x seed 1 equals its simulate "
        "(whose warmup gives phase 3's targets) and power_of_d x static x "
        "storm x seed 0 its single run with the sweep's targets "
        "(simulate's steps; simulate gives a non-adaptive policy the "
        "default targets) bit for bit on every timeline")
    tick_launches = 2 * 2 * n_pol * T

    # the faulted fleet: a faults= override, the sweep's own warmup
    t0 = time.perf_counter()
    T = E13_SWEEP_TICKS
    fgrid = plane_grid(wl3, T)
    program = e13_storm_crash(faults)
    fcfg = core.SimConfig(**E13_SWEEP)
    spec = core.SweepSpec(config=fcfg, workloads=fgrid,
                          controllers=E13_CONTROLLERS, seeds=SWEEP_SEEDS,
                          faults=program)
    obs_trace.configure(fresh=True)
    zero_counts(counters)
    fres = core.run_sweep(spec, device="cuda")
    counts = read_counts(counters)
    want = dict.fromkeys(counters, 0)
    want["route_tick"] = len(fres.cells) * T
    check(counts == want, f"faulted sweep: {counts}, expected {want}")
    sweep_s = time.perf_counter() - t0
    warmups = [e["name"] for e in obs_trace.RECORDER.events
               if e["name"].endswith("/warmup")]
    check(warmups == ["sim/warmup", "sweep/warmup"],
          f"the faulted sweep's warmup spans are {warmups}")
    # one warmup for the single runs: it strips the faults and ignores
    # the controller, so every row's simulate would make the same one
    ftargets = sim.warmup(spec.config, device="cuda")
    for (p, c, w, seed), row in fres.items():
        rcfg = dataclasses.replace(spec.config, controller=c, seed=seed)
        _, st_mask, _ = faults.apply_traffic(
            faults.compile_faults(rcfg, T), fgrid.keys, fgrid.mask,
            fgrid.is_write)
        check_result(np, row, fgrid._replace(mask=st_mask), T, fcfg.m)
        check_fleet_counters(row.final_cache, fcfg.P, f"faulted {c} {seed}")
        alone = stand_alone(sim, rcfg, fgrid, ftargets)
        check(rows_equal(np, alone, row, FIELDS),
              f"faulted sweep {c} x seed {seed} is not its single run")
        for i, (x, y) in enumerate(zip(tree_leaves(alone.final_cache),
                                       tree_leaves(row.final_cache))):
            check(torch.equal(x, y),
                  f"faulted sweep {c} x seed {seed}: FleetState leaf {i}")
    q = fres.row(controller="hysteresis", seed=0).queue_timeline
    say(f"[13] E13's crash_during_storm retimed to {T} ticks (storm 33-58 "
        f"mag 0.6, crash of server 0 38-55) as a faults= override on "
        f"fleet_cache (P={fcfg.P}, gossip {fcfg.gossip_ms:g} ms) at phase "
        f"3's constants, controllers {E13_CONTROLLERS} x seeds "
        f"{SWEEP_SEEDS}: {want['route_tick']} route_tick launches and no "
        f"other kernel; one warmup (its spans) for both controllers; every "
        f"row and its FleetState bit for bit its single run (simulate's "
        f"steps after one warmup of the config); server 0's queue peaked "
        f"at {q[:, 0].max():.1f} ({sweep_s:.1f} s)")
    return tick_launches + want["route_tick"]


# ---------------------------------------------------------------------------
# phase 14: the unrolled-waves engine (E10's "before"), theory and the
# report CLI
# ---------------------------------------------------------------------------

UNROLL_TICKS = 150  # the first 150 ticks of phase 3's bursty grid
UNROLL_WARMUP_TICKS = 300  # both engines' warmup on 300 light ticks
UNROLL_PROFILE = (100, 10)  # kernels a tick over ticks 100-110
UNROLL_FAULT_TICKS, UNROLL_FAULT_CUT = 100, 4  # phase 12's program / 4
THEORY = dict(n_balls=64, m=64, trials=30, seed=0)


def timed_run(torch, sim, cfg, targets, grid):
    """((final state, per-tick outputs), seconds) of one run_ticks."""
    st = sim.init_state(cfg, *targets, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.run_ticks(cfg, st, *grid)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def engine_pair(torch, sim, counters, cfg, targets, grid, what):
    """The grid under the unrolled engine (route_select once a wave) and
    the hoisted one (route_tick once a tick), each with its launches
    counted, bitwise equal.  Returns (unrolled run, its seconds, hoisted
    seconds, launches of each)."""
    T = grid[0].shape[0]
    G = cfg.P if cfg.fleet_routing else cfg.n_groups
    runs, launches = {}, {}
    for unroll in (True, False):
        c = dataclasses.replace(cfg, unroll_waves=unroll)
        zero_counts(counters)
        runs[unroll] = timed_run(torch, sim, c, targets, grid)
        launches[unroll] = read_counts(counters)
    for unroll, name, n in ((True, "route_select", T * G),
                            (False, "route_tick", T)):
        want = dict.fromkeys(counters, 0)
        want[name] = n
        check(launches[unroll] == want,
              f"{what}, {'unrolled' if unroll else 'hoisted'} engine: "
              f"{launches[unroll]} launches, expected {want}")
    check_runs_equal(torch, runs[True][0], runs[False][0], what,
                     pair="unrolled vs hoisted")
    return runs[True], runs[False][1], launches


def phase_unrolled(torch, np, core, sim, counters, wl3, targets):
    """The unrolled-waves engine at phase 3's constants: its warmup
    (on 300 ticks of the light grid, for time) equal to the hoisted
    engine's; with phase 3's targets, the first 150 ticks of phase 3's
    grid under midas + cache + hysteresis (1200 route_select launches,
    no route_tick) bitwise the hoisted engine's run, both engines'
    ticks/s and kernels a tick (E10's before and after); phase 12's faulted fleet retimed to 100 ticks
    under both engines (800 route_select, bitwise, FleetState
    included); balls-into-bins on the card bitwise the CPU's; the
    report CLI's --check on the trace and artifact the phase writes.
    Returns the launches (route_select, route_tick)."""
    from repro_torch.core import faults, prng, theory
    from repro_torch.obs import report, windows
    from repro_torch.obs import trace as obs_trace

    out_dir = ROOT / "build" / "unrolled"
    obs_trace.configure(path=out_dir / "unrolled.trace.jsonl", fresh=True)
    started = time.strftime("%Y-%m-%dT%H:%M:%S")
    T = UNROLL_TICKS
    wl = plane_grid(wl3, T)
    grid = (wl.keys, wl.mask, wl.is_write)
    cfg = core.SimConfig(policy="midas", middleware=("cache",),
                         cache_mode="lease", unroll_waves=True, **FULL)

    # (a) the warmup under both engines (the runs take phase 3's)
    Tw = UNROLL_WARMUP_TICKS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sim.warmup(cfg, T=Tw, device="cuda")
    warm_s = time.perf_counter() - t0
    want = sim.warmup(dataclasses.replace(cfg, unroll_waves=False), T=Tw,
                      device="cuda")
    check(got == want, f"the unrolled engine's warmup gives {got}, the "
          f"hoisted engine's {want}")
    say(f"[14] the warmup ({Tw} ticks of the light grid) under the "
        f"unrolled engine: targets {got}, the hoisted engine's "
        f"({warm_s:.1f} s); the runs take phase 3's, {targets}")

    # (b) midas + cache + hysteresis, both engines, bitwise
    with obs_trace.span("unrolled/midas", cat="execute", T=T):
        (u_run, u_s), h_s, launches = engine_pair(
            torch, sim, counters, cfg, targets, grid, "midas + cache")
    u_res = sim._to_result(cfg, u_run[1], sim._final_cache(cfg, u_run[0]))
    check_result(np, u_res, wl, T, cfg.m)
    lead, n = UNROLL_PROFILE
    kpt = {name: kernels_per_tick(torch, sim, dataclasses.replace(
        cfg, unroll_waves=unroll), targets, wl, lead=lead, ticks=n)
        for name, unroll in (("unrolled", True), ("hoisted", False))}
    e10 = {"unrolled": {"ticks_per_s": T / u_s,
                        "kernels_per_tick": kpt["unrolled"],
                        "route_select": launches[True]["route_select"]},
           "hoisted": {"ticks_per_s": T / h_s,
                       "kernels_per_tick": kpt["hoisted"],
                       "route_tick": launches[False]["route_tick"]}}
    say(f"[14] midas + cache + hysteresis, the first {T} ticks of phase "
        f"3's grid: unrolled engine {launches[True]['route_select']} "
        f"route_select launches and no route_tick, hoisted "
        f"{launches[False]['route_tick']} route_tick; every per-tick output "
        f"(dV included) and the final state bit for bit equal; steered "
        f"{u_res.steered.sum():.0f} of eligible {u_res.eligible.sum():.0f}, "
        f"cache hits {u_res.cache_hits.sum():.0f}")
    say(f"[14] E10 before/after: unrolled {T / u_s:.1f} ticks/s, "
        f"{kpt['unrolled']:.1f} kernels a tick; hoisted {T / h_s:.1f} "
        f"ticks/s, {kpt['hoisted']:.1f} kernels a tick (ticks "
        f"{lead}-{lead + n} profiled); card {card_line()}")

    # (c) phase 12's faulted fleet, retimed into 100 ticks
    Tf = UNROLL_FAULT_TICKS
    fcfg = core.SimConfig(**FLEET, unroll_waves=True,
                          faults=fault_program(faults, UNROLL_FAULT_CUT))
    fwl = plane_grid(wl3, Tf)
    fc = faults.compile_faults(fcfg, Tf)
    check(fc.has_remap and len(fc.flips) == 2,
          f"the retimed program flips at {list(fc.flips)}")
    with obs_trace.span("unrolled/faulted_fleet", cat="execute", T=Tf):
        (f_run, f_s), fh_s, f_launches = engine_pair(
            torch, sim, counters, fcfg, targets,
            (fwl.keys, fwl.mask, fwl.is_write), "faulted fleet")
    check_fleet_counters(f_run[0].mw[0], fcfg.P, "unrolled faulted fleet")
    say(f"[14] phase 12's faulted fleet (P={fcfg.P}, fleet routing, E13's "
        f"three programs with every time / {UNROLL_FAULT_CUT}: flips at "
        f"{[int(t) for t in fc.flips]}), the first {Tf} ticks: unrolled "
        f"{f_launches[True]['route_select']} route_select launches, "
        f"hoisted {f_launches[False]['route_tick']} route_tick; every "
        f"output and the whole final state (FleetState included) bit for "
        f"bit equal; {Tf / f_s:.1f} against {Tf / fh_s:.1f} ticks/s")
    e10["faulted_fleet"] = {"unrolled_ticks_per_s": Tf / f_s,
                            "hoisted_ticks_per_s": Tf / fh_s}

    # (d) balls-into-bins on the card, bitwise the CPU's
    th = {}
    with obs_trace.span("unrolled/theory", cat="execute"):
        for d in (1, 2):
            kw = dict(THEORY, d=d)
            loads = {dev: theory.balls_into_bins(
                prng.split(prng.PRNGKey(kw["seed"], dev), kw["trials"]),
                kw["n_balls"], kw["m"], d).cpu() for dev in ("cuda", "cpu")}
            check(torch.equal(loads["cuda"], loads["cpu"]),
                  f"balls_into_bins d={d}: card and CPU loads differ")
            gaps = {dev: theory.maxload_gap_empirical(
                kw["n_balls"], kw["m"], d, trials=kw["trials"],
                seed=kw["seed"], device=dev) for dev in ("cuda", "cpu")}
            check(gaps["cuda"] == gaps["cpu"],
                  f"maxload_gap_empirical d={d}: {gaps}")
            th[d] = gaps["cuda"]
    bound = theory.power_of_d_maxload_gap_theory(THEORY["m"], 2)
    check(th[2][0] < th[1][0] and th[1][0] > bound,
          f"the gaps {th} do not order as the reference's claims")
    say(f"[14] balls-into-bins at n = m = {THEORY['m']}, "
        f"{THEORY['trials']} trials on the card: loads bitwise the CPU's; "
        f"gap (mean, std) d=1 {th[1]}, d=2 {th[2]} (power-of-2 bound "
        f"{bound:.3f}); uniform theory "
        f"{theory.uniform_maxload_gap_theory(THEORY['m']):.3f}")

    # (e) the artifact and its trace, read back by the report CLI
    doc = {"meta": {"torch_version": torch.__version__,
                    "device_kind": torch.cuda.get_device_name(0),
                    "started_at": started,
                    "written_at": time.strftime("%Y-%m-%dT%H:%M:%S")},
           "e10": dict(e10, midas_cache=windows.cell_block([u_res])),
           "theory": {f"d{d}": {"mean_gap": g[0], "std_gap": g[1]}
                      for d, g in th.items()}}
    obs_trace.RECORDER.path = None  # later phases write no trace
    (out_dir / "unrolled.json").write_text(json.dumps(doc, indent=1))
    rc = report.main(["--check", str(out_dir)])
    check(rc == 0, f"repro_torch.obs.report --check {out_dir} exited {rc}")
    report.main([str(out_dir / "unrolled.json")])
    return (launches[True]["route_select"]
            + f_launches[True]["route_select"],
            launches[False]["route_tick"] + f_launches[False]["route_tick"])


# ---------------------------------------------------------------------------
# phases 6-8: serving
# ---------------------------------------------------------------------------


def replay_traffic(np, serving, router, cfg, *, requests, prompt_len, seed,
                   **_):
    """The launcher's traffic on the host: each request's session is
    routed, then its prefill inputs drawn (``serve.request_inputs``:
    prompt tokens, and frames or patches for a frontend arch), from one
    numpy generator.  Returns the inputs and the routes an independent
    router takes."""
    rng = np.random.default_rng(seed)
    prompts, routes = [], []
    for req in range(requests):
        session = int(rng.zipf(1.4)) % 16
        route = router.route(session, req * 50.0, prefix_hash=session % 4)
        routes.append(route)
        prompts.append(serving.request_inputs(cfg, rng, prompt_len))
        router.complete(route[0])
        router.ingest_telemetry()
    return prompts, routes


def teacher_forced(torch, models, model, prompt, tokens, impl, cache_len,
                   device="cuda", cache_dtype=None):
    """Logits (1 + decode steps, V) of one request fed ``tokens`` after
    its prefill inputs ``prompt`` (``serve.request_inputs``), as the
    launcher runs it (a bfloat16 cache read back in float32), or with a
    ``cache_dtype`` cache."""
    batch = {k: torch.as_tensor(v, dtype=torch.int32 if k == "tokens"
                                else torch.float32, device=device)
             for k, v in prompt.items()}
    lg, cache = models.prefill(model, batch, cache_len=cache_len,
                               cache_dtype=cache_dtype or torch.bfloat16,
                               impl=impl)
    cache = {p: {n: a.float() for n, a in c.items()}
             for p, c in cache.items()}
    out = [lg[0, -1]]
    P = sum(v.shape[1] for k, v in prompt.items())  # the cache rows used
    tok = torch.as_tensor(tokens, dtype=torch.int32, device=device)
    for t in range(tokens.shape[0] - 1):
        pos = torch.tensor([P + t], dtype=torch.int32, device=device)
        lg, cache = models.decode_step(model, cache, tok[t:t + 1][None],
                                       pos, impl=impl)
        out.append(lg[0, -1])
    return torch.stack(out).float().cpu()


def margin_check(torch, np, tokens, other, lp, tol, what):
    """The margin rule of tests/test_torch_serve.py: where the plain
    (or CPU) run's teacher-forced top-2 margin exceeds 2 (tol + tol
    |top|), ``tokens`` must be its argmax; and ``other``, the plain
    run's own greedy tokens, must equal ``tokens`` up to the request's
    first near-tie, where the two contexts part.  ``lp`` is (requests,
    positions, V) teacher-forced on ``tokens``.  Returns the count of
    near-ties."""
    top2 = lp.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    top = top2[..., 0].abs().numpy()
    decided = margin > 2 * (tol + tol * top)
    greedy = lp.argmax(-1).numpy()
    check(np.array_equal(tokens[decided], greedy[decided]),
          f"{what}: a served token differs from the plain run's argmax at "
          f"a decisive position")
    for req in range(tokens.shape[0]):
        ties = np.flatnonzero(~decided[req])
        upto = ties[0] + 1 if ties.size else tokens.shape[1]
        check(np.array_equal(tokens[req, :upto], other[req, :upto]),
              f"{what}: request {req}: the two runs' tokens part before "
              f"the first near-tie")
    return int((~decided).sum())


def make_model(torch, cfg, tag):
    """``cfg`` with random weights from SERVE's seed on the card."""
    from repro_torch import models

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = models.init_params(cfg, SERVE["seed"], device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    if cfg.mamba is not None:
        shape = (f"d_inner {cfg.mamba.expand * cfg.d_model}, d_state "
                 f"{cfg.mamba.d_state}, d_conv {cfg.mamba.d_conv}")
    else:
        shape = (f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads, "
                 f"head_dim {cfg.resolved_head_dim}")
    if cfg.moe is not None:
        mo = cfg.moe
        shape += (f", {mo.num_experts} experts top-{mo.experts_per_token} "
                  f"of width {mo.d_ff_expert}, midas_d {mo.midas_d}, f_max "
                  f"{mo.midas_fmax}")
    say(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {shape}, vocab {cfg.vocab_size}: {n_params} "
        f"parameters ({n_params * 4 / 1e9:.2f} GB float32) made from seed "
        f"{SERVE['seed']} in {time.perf_counter() - t0:.1f} s")
    return model


def phase_serve(torch, np, serving, counters, model, *, tag, per_layer,
                traffic=SERVE, f32_cache=False):
    """Serve ``model`` at full width with ``traffic``, kernels then
    plain, and check what comes out.  ``per_layer(R, P, T)`` gives the
    launches expected of each kernel per layer; every other kernel must
    not launch.  A dense model must give the same tokens on both paths;
    a Mamba or MoE model the same tokens under the margin rule (its
    scan sums in another order than the plain one; its routing can
    swap an expert on a last-bit difference upstream of the gate)."""
    from repro_torch import models
    from repro_torch.config import RunConfig
    from repro_torch.serve import MidasRouter

    cfg, run = model.cfg, RunConfig()
    # a short warm-up (the card's first matmuls and allocations)
    serving.serve(cfg, run, requests=1, prompt_len=SERVE["prompt_len"],
                  decode_len=2, replicas=4, device="cuda", model=model)

    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    res = serving.serve(cfg, run, device="cuda", model=model, **traffic)
    launches = read_counts(counters)
    R, P = traffic["requests"], traffic["prompt_len"]
    T = traffic["decode_len"]
    want = dict.fromkeys(counters, 0)
    for name, n in per_layer(R, P, T).items():
        want[name] = n * cfg.num_layers
    say(f"[{tag}] launches in the serving run: {launches} (expected "
        f"{want})")
    check(launches == want, f"{launches} launches, expected {want}")
    check(res.tokens.shape == (R, T + 1), f"tokens {res.tokens.shape}")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "a token outside the vocabulary")
    prompts, routes = replay_traffic(
        np, serving, MidasRouter(replicas=traffic["replicas"], d=3,
                                 f_max=0.25), cfg, **traffic)
    check(res.routes == routes, "the router's decisions differ from a "
          "replay of the same traffic")
    L = serving.prefix_len(cfg) + P + T  # the cache rows a request fills
    check(res.stats.routed == R, f"routed {res.stats.routed}")
    say(f"[{tag}] router: routed={res.stats.routed} steered="
        f"{res.stats.steered} prefix_hits={res.stats.cache_hits} queue_cv="
        f"{res.queue_dispersion:.3f}; equal to a host replay of the traffic")
    say(f"[{tag}] prefill {res.prefill_ms_per_request():.2f} ms per request "
        f"({P} tokens); decode {res.decode_ms_per_token():.3f} ms per token;"
        f" {res.tokens_per_s():.1f} decode tokens/s over the whole loop "
        f"({res.wall_s:.2f} s); peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    zero_counts(counters)
    plain = serving.serve(cfg, run, device="cuda", model=model, impl="ref",
                          **traffic)
    check(all(n == 0 for n in read_counts(counters).values()),
          "the plain run launched a kernel")
    check(plain.routes == res.routes, "plain run routed differently")
    exact = cfg.mamba is None and cfg.moe is None
    if exact:
        check(np.array_equal(plain.tokens, res.tokens),
              "kernel and plain path give different greedy tokens")
    say(f"[{tag}] the same run on the plain path on the card: plain "
        f"prefill {plain.prefill_ms_per_request():.2f} ms per request, "
        f"decode {plain.decode_ms_per_token():.3f} ms per token")

    worst, lps = 0.0, []
    for req in range(R):
        lk = teacher_forced(torch, models, model, prompts[req],
                            res.tokens[req], "cuda", L)
        lp = teacher_forced(torch, models, model, prompts[req],
                            res.tokens[req], "ref", L)
        check(bool(torch.isfinite(lk).all()), "logits not finite")
        diff = (lk - lp).abs()
        check(bool((diff <= SERVE_LOGIT_TOL * (1 + lp.abs())).all()),
              f"request {req}: teacher-forced logits differ by "
              f"{diff.max().item():.3g}")
        check(torch.equal(lk.argmax(-1), torch.as_tensor(
            res.tokens[req], dtype=torch.int64)),
            f"request {req}: teacher-forced argmax is not the served token")
        worst = max(worst, diff.max().item())
        lps.append(lp)
    say(f"[{tag}] teacher-forced logits, kernel vs plain path, all "
        f"{R} requests x {T + 1} positions: max |diff| {worst:.3g} "
        f"(allowed {SERVE_LOGIT_TOL} relative and absolute)")
    if f32_cache:  # the same pair on a float32 cache, reported only
        worst32 = 0.0
        for req in range(R):
            lk, lp = (teacher_forced(torch, models, model, prompts[req],
                                     res.tokens[req], impl, L,
                                     cache_dtype=torch.float32)
                      for impl in ("cuda", "ref"))
            worst32 = max(worst32, (lk - lp).abs().max().item())
        say(f"[{tag}] the same teacher-forced logits on a float32 cache: "
            f"kernel vs plain path max |diff| {worst32:.3g} (on the served "
            f"bfloat16 cache {worst:.3g})")
    if exact:
        say(f"[{tag}] kernel and plain path: identical greedy tokens "
            f"({res.tokens.size})")
    else:
        ties = margin_check(torch, np, res.tokens, plain.tokens,
                            torch.stack(lps), SERVE_LOGIT_TOL,
                            f"{cfg.name} kernel vs plain")
        say(f"[{tag}] kernel and plain path: the same greedy token at every "
            f"decisive position; {ties} of {res.tokens.size} positions are "
            f"near-ties (top-2 margin <= 2 (tol + tol |top|), tol "
            f"{SERVE_LOGIT_TOL}); {int((plain.tokens == res.tokens).sum())}"
            f" tokens equal")
    return res, launches


def phase_serve_small(torch, np, serving):
    from repro_torch import models
    from repro_torch.config import RunConfig, get_smoke_arch
    from repro_torch.serve import MidasRouter

    kw = dict(requests=8, prompt_len=16, decode_len=16, replicas=4, seed=0)
    for arch in ("smollm-360m", "gemma2-2b", "falcon-mamba-7b",
                 "qwen3-moe-235b-a22b", "dbrx-132b", "jamba-v0.1-52b",
                 "musicgen-large", "llava-next-mistral-7b"):
        cfg = get_smoke_arch(arch)
        run = RunConfig(arch=arch)
        cpu_model = models.init_params(cfg, kw["seed"], device="cpu")
        gpu_model = models.init_params(cfg, kw["seed"], device="cuda")
        cpu = serving.serve(cfg, run, device="cpu", model=cpu_model, **kw)
        gpu = serving.serve(cfg, run, device="cuda", model=gpu_model, **kw)
        check(cpu.stats == gpu.stats, f"{cfg.name}: router stats differ")
        if cfg.mamba is None and cfg.moe is None:
            check(np.array_equal(cpu.tokens, gpu.tokens),
                  f"{cfg.name}: card and CPU tokens differ")
            say(f"[7] {cfg.name} (head_dim {cfg.resolved_head_dim}, window "
                f"{cfg.window_size}, softcap {cfg.logit_softcap}, frontend "
                f"{cfg.frontend}): the card's {gpu.tokens.size} tokens "
                f"equal the CPU run's")
            continue
        prompts, _ = replay_traffic(
            np, serving, MidasRouter(replicas=kw["replicas"], d=3,
                                     f_max=0.25), cfg, **kw)
        P, T = kw["prompt_len"], kw["decode_len"]

        def forced(cache_dtype):
            """(card, CPU) teacher-forced logits of every request."""
            lg = [teacher_forced(torch, models, m, prompts[r],
                                 gpu.tokens[r], "auto", P + T, device=dev,
                                 cache_dtype=cache_dtype)
                  for r in range(kw["requests"])
                  for m, dev in ((gpu_model, "cuda"), (cpu_model, "cpu"))]
            return torch.stack(lg[0::2]), torch.stack(lg[1::2])

        # the logits are held on a float32 cache: with the served
        # bfloat16 cache a last-bit difference of a cached float32 value
        # can round to the neighbouring bfloat16 (2**-8 relative), on the
        # plain path as well as the kernels'; the served tokens are held
        # under the margin rule against the CPU's served-cache logits
        lk, lp32 = forced(torch.float32)
        diff = (lk - lp32).abs()
        check(bool((diff <= SMALL_LOGIT_TOL * (1 + lp32.abs())).all()),
              f"{cfg.name}: card and CPU teacher-forced logits differ by "
              f"{diff.max().item():.3g}")
        lk16, lp = forced(torch.bfloat16)
        ties = margin_check(torch, np, gpu.tokens, cpu.tokens, lp,
                            SMALL_LOGIT_TOL, f"{cfg.name} card vs CPU")
        parts = []
        if cfg.mamba is not None:
            parts.append(f"d_inner {cfg.mamba.expand * cfg.d_model}, "
                         f"d_state {cfg.mamba.d_state}: chunk_scan")
        if cfg.moe is not None:
            parts.append(f"{cfg.moe.num_experts} experts top-"
                         f"{cfg.moe.experts_per_token}: dispatch_candidates")
        say(f"[7] {cfg.name} ({'; '.join(parts)}): teacher-forced logits "
            f"of the card and the CPU on a float32 cache within "
            f"{diff.max().item():.3g} (allowed {SMALL_LOGIT_TOL}; on the "
            f"served bfloat16 cache {(lk16 - lp).abs().max().item():.3g});"
            f" the same token at every decisive position, {ties} near-ties"
            f" of {gpu.tokens.size}; {int((cpu.tokens == gpu.tokens).sum())}"
            f" tokens equal")


def rebind(models, model, cfg):
    """A model of ``cfg`` over ``model``'s weights (no copy): the same
    architecture under other router settings."""
    other = models.Model(cfg, device="meta")
    other.load_state_dict(model.state_dict(), assign=True)
    return other


def phase_moe(torch, np, serving, counters):
    """Qwen3-MoE at full width, 4 layers: the SERVE traffic through
    ``dispatch_candidates`` and ``dispatch_steer`` (f_max 0.25), a check
    that the serving path's balanced telemetry steers nothing, then the
    f_max = 1 variant's run through ``dispatch_fused`` on the same
    weights; decode ms a token of both runs."""
    from repro_torch import models
    from repro_torch.config import get_arch
    from repro_torch.serve import MidasRouter

    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    say(f"[9] {full.name}: cut to {MOE_LAYERS} of its {full.num_layers} "
        f"layers (depth only; every width as published)")
    model = make_model(torch, cfg, 9)
    capped, launches = phase_serve(
        torch, np, serving, counters, model, tag=9,
        per_layer=lambda R, P, T: {"dispatch_candidates": R * (1 + T),
                                   "dispatch_steer": R * (1 + T),
                                   "flash_attention": R,
                                   "decode_attention": R * T})
    prompt = torch.as_tensor(replay_traffic(
        np, serving, MidasRouter(replicas=SERVE["replicas"], d=3,
                                 f_max=0.25), cfg, **SERVE)[0][0]["tokens"],
        dtype=torch.int32, device="cuda")
    _, _, aux = models.forward(model, {"tokens": prompt}, return_moe=True)
    steer = torch.stack([a.steer_rate for a in aux.values()])
    drop = torch.cat([a.drop_rate for a in aux.values()])
    check(not bool(steer.any()), f"balanced telemetry steered: {steer}")
    drops = ", ".join(f"{x:.4f}" for x in drop.cpu().tolist())
    say(f"[9] a served prompt through the layers under the serving path's "
        f"balanced telemetry: steered nothing in any layer (as the "
        f"reference); drop rate per layer {drops}")

    fused_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, midas_fmax=1.0))
    fused_model = rebind(models, model, fused_cfg)
    traffic = dict(SERVE, requests=MOE_FUSED_REQUESTS)
    fused, fused_launches = phase_serve(
        torch, np, serving, counters, fused_model, tag=9,
        per_layer=lambda R, P, T: {"dispatch_fused": R * (1 + T),
                                   "flash_attention": R,
                                   "decode_attention": R * T},
        traffic=traffic)
    say(f"[9] decode: {capped.decode_ms_per_token():.3f} ms per token at "
        f"f_max {cfg.moe.midas_fmax} ({SERVE['requests']} requests), "
        f"{fused.decode_ms_per_token():.3f} ms per token at f_max 1 "
        f"({MOE_FUSED_REQUESTS} requests)")
    return launches, fused_launches


# ---------------------------------------------------------------------------
# phase 15: the audio and vision frontends at full width
# ---------------------------------------------------------------------------

# 4 requests of 512 frames (MusicGen) or 576 patches + 512 tokens
# (LLaVA-NeXT), 16 greedy decode steps each, 4 replicas
FRONTEND_TRAFFIC = dict(requests=4, prompt_len=512, decode_len=16,
                        replicas=4, seed=0)
# MusicGen at 24 of its 48 layers (cut from full depth for time)
FRONTENDS = (("musicgen-large", 24), ("llava-next-mistral-7b", 8))


def phase_frontends(torch, np, serving, counters):
    """MusicGen-Large cut to 24 of 48 layers and LLaVA-NeXT-Mistral-7B
    cut to 8 of 32 layers, both at full width, each served with FRONTEND_TRAFFIC,
    kernels then plain attention: one flash_attention launch a layer a
    prefill and one decode_attention a layer a decode step, tokens
    equal between the two paths.  Returns the launches of each arch."""
    from repro_torch.config import get_arch

    out = {}
    for arch, layers in FRONTENDS:
        full = get_arch(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, num_layers=layers)
        lead = serving.prefix_len(cfg)
        prompt = FRONTEND_TRAFFIC["prompt_len"]
        decode = FRONTEND_TRAFFIC["decode_len"]
        say(f"[15] {full.name} ({full.frontend}: "
            + (f"{lead} patches + {prompt} prompt tokens" if lead else
               f"{prompt} frames")
            + f" a request, a {lead + prompt + decode}-row cache): "
            + ("every layer" if layers is None else
               f"cut to {layers} of its {full.num_layers} layers (depth "
               f"only; every width as published)"))
        t0 = time.perf_counter()
        model = make_model(torch, cfg, 15)
        _, out[arch] = phase_serve(
            torch, np, serving, counters, model, tag=15,
            per_layer=lambda R, P, T: {"flash_attention": R,
                                       "decode_attention": R * T},
            traffic=FRONTEND_TRAFFIC)
        del model
        torch.cuda.empty_cache()
        say(f"[15] {full.name} took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: training
# ---------------------------------------------------------------------------

# (B, S, H, KV, D, window, softcap, dtype): SmolLM-360M's training shape
# in both dtypes, Qwen3-MoE's heads, MusicGen's G = 1, gemma2's window
# and softcap (head_dim 256), and a ragged S with a padded head_dim
FA_BWD_SHAPES = [
    (8, 512, 15, 5, 64, 0, 0.0, "bfloat16"),
    (8, 512, 15, 5, 64, 0, 0.0, "float32"),
    (1, 512, 64, 4, 128, 0, 0.0, "bfloat16"),
    (1, 512, 32, 32, 64, 0, 0.0, "bfloat16"),
    (2, 256, 8, 4, 256, 128, 50.0, "float32"),
    (2, 100, 6, 2, 20, 24, 20.0, "float32"),
]
FA_BWD_TRAIN = FA_BWD_SHAPES[0]
N_BWD = 20  # backward calls a timing
TRAIN = dict(batch=8, seq=512, steps=20)  # the main path's run
REMAT_STEPS = 3  # steps a remat policy (and "none") is timed over
EIGHT_BIT_STEPS = 5
PLAIN_STEPS = 3  # kernel path against plain path, float32 activations
RESUME_LAYERS = 4  # the kill-and-resume run: 4 of SmolLM's 32 layers
LOSS_TOL = 1e-4  # kernel vs plain and card vs CPU: |diff| <= tol (1 + |x|)
GNORM_TOL = 1e-3
TRAIN_SMOKE = ("smollm-360m", "gemma2-2b", "musicgen-large",
               "llava-next-mistral-7b", "qwen3-moe-235b-a22b",
               "falcon-mamba-7b", "jamba-v0.1-52b")


def bwd_tol(dtype):
    """The backward against ``ref.mha_backward``: |diff| <= tol (max
    |want| + |want|); float32 1e-4 (the forward's 3xTF32 output and its
    ex2.approx logsumexp enter p and D = dO . o), bfloat16 2e-2, the
    forward's tolerance (gradients rounded to bfloat16, D from the
    bfloat16 output)."""
    return 2e-2 if dtype == "bfloat16" else 1e-4


def fa_bwd_bound(B, S, H, KV, D, window, itemsize):
    """(bound ms, "bytes" or "operations") of the attention backward:
    q, k, v, o, dO and the row logsumexp read once, dq, dk, dv written
    once, against five products of D (10 D operations) per kept pair
    and head on the tensor cores (bfloat16 at 989 TFLOP/s, float32 as
    3xTF32 at 495 / 3)."""
    rate = BF16_FLOP_PER_S if itemsize == 2 else TF32_FLOP_PER_S / 3
    byts = (4 * B * S * H * D + 4 * B * S * KV * D) * itemsize \
        + 4 * B * H * S
    flops = 10 * D * kept_pairs(S, window) * B * H
    t_b, t_f = byts / HBM_BYTES_PER_S, flops / rate
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def sass_ops(source, flags):
    """(tensor-core MMA instructions, RED/ATOM instructions of any type,
    those of a float type) in the SASS of the library built from
    ``source`` (``cuobjdump --dump-sass``)."""
    from repro_torch.kernels import _build

    lib = _build.library_path(source, flags)
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "--dump-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    atomics = re.findall(r"\b(?:RED|ATOM|ATOMG|ATOMS)\.(\S*)", out)
    floats = [a for a in atomics if re.search(r"F(?:16|32|64)|BF16", a)]
    return (len(re.findall(r"\bH(?:G)?MMA\.", out)), len(atomics),
            len(floats))


def phase_train_kernel(torch, fa_kernel, fa_ref):
    """The backward kernels against ``ref.mha_backward`` at every case,
    causal, bitwise on a repeat; its SASS (tensor-core instructions, no
    atomics); times at SmolLM's training shape: the backward beside
    SDPA's backward alone, the port's forward and backward pair beside
    SDPA's, and the forward alone (with its row logsumexp, as training
    runs it) beside SDPA's forward."""
    import torch.nn.functional as F

    mma, atomics, float_atomics = sass_ops(fa_kernel.BWD_SOURCE,
                                           fa_kernel.FLAGS)
    check(mma > 0 and atomics == 0,
          f"flash_attention_backward's SASS: {mma} tensor-core "
          f"instructions, {atomics} atomics")
    say(f"[16] flash_attention_backward's SASS: {mma} HMMA instructions, "
        f"{atomics} RED/ATOM instructions ({float_atomics} of a float "
        f"type)")
    max_err, row = 0.0, None
    for shape in FA_BWD_SHAPES:
        B, S, H, KV, D, window, cap, dtype = shape
        g = torch.Generator(device="cuda").manual_seed(S + H + D)
        dt = getattr(torch, dtype)
        q, k, v, dout = (torch.randn((B, S, n, D), generator=g,
                                     device="cuda", dtype=dt)
                         for n in (H, KV, KV, H))
        kw = dict(causal=True, window=window, softcap=cap)
        out, lse = fa_kernel._forward(q, k, v, True, window, cap, True)
        got = fa_kernel.flash_attention_backward(q, k, v, out, dout, lse,
                                                 **kw)
        want = fa_ref.mha_backward(q, k, v, dout, **kw)
        torch.cuda.synchronize()
        tol, err = bwd_tol(dtype), 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()), f"{shape} {name} not finite")
            diff = (a - b).abs()
            scale = b.abs().max().item()
            check(bool((diff <= tol * (scale + b.abs())).all()),
                  f"flash_attention_backward {shape} {name}: max |diff| "
                  f"{diff.max().item():.3g} at scale {scale:.3g}")
            err = max(err, diff.max().item())
        again = fa_kernel.flash_attention_backward(q, k, v, out, dout, lse,
                                                   **kw)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_attention_backward {shape}: a repeated call differs")
        max_err = max(max_err, err)
        say(f"[16] flash_attention_backward {shape}: agrees with "
            f"ref.mha_backward (max |diff| {err:.3g}, tol {tol} x scale), "
            f"bitwise on a repeat")
        if shape != FA_BWD_TRAIN:
            continue
        k_fn = lambda: fa_kernel.flash_attention_backward(  # noqa: E731
            q, k, v, out, dout, lse, **kw)
        p_fn = lambda: fa_ref.mha_backward(q, k, v, dout, **kw)  # noqa
        qs, ks, vs = (x.detach().transpose(1, 2).requires_grad_(True)
                      for x in (q, k, v))
        d_t = dout.transpose(1, 2)

        def l_fn():
            # SDPA's forward and backward: autograd runs a backward on
            # its forward's stream, so both go into the graph (as the
            # plain backward's forward does)
            out_t = F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(out_t, (qs, ks, vs), d_t)

        # SDPA's backward alone: its forward made once, outside the
        # graph, on the stream the backward is captured on
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out_s = F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True)

        def lb_fn():
            return torch.autograd.grad(out_s, (qs, ks, vs), d_t,
                                       retain_graph=True)

        qf, kf, vf = (x.detach().requires_grad_(True) for x in (q, k, v))

        def pair_fn():
            # the port's forward (with its logsumexp) and backward
            o = fa_kernel.FlashAttention.apply(qf, kf, vf, True, window, cap)
            return torch.autograd.grad(o, (qf, kf, vf), dout)

        bound, by = fa_bwd_bound(B, S, H, KV, D, window, q.element_size())
        # the plain backward (autograd of ref.mha, with its forward) from
        # a CUDA graph too
        row = dict(shape=shape, ms=device_ms(torch, [k_fn], N_BWD),
                   host_ms=host_ms(torch, k_fn, N_BWD),
                   plain_ms=device_ms(torch, [p_fn], N_BWD),
                   library_ms=device_ms(torch, [lb_fn], N_BWD, stream=side),
                   pair_ms=device_ms(torch, [pair_fn], N_BWD),
                   library_pair_ms=device_ms(torch, [l_fn], N_BWD),
                   bound_ms=bound, bound_by=by)
        say(f"[16] flash_attention_backward {shape}: device "
            f"{row['ms'] * 1e3:.1f} us (called {row['host_ms'] * 1e3:.1f} "
            f"us), sdpa's backward alone {row['library_ms'] * 1e3:.1f} us, "
            f"plain forward + backward {row['plain_ms'] * 1e3:.1f} us, "
            f"bound {bound * 1e3:.3f} us ({by}); forward + backward: the "
            f"port's {row['pair_ms'] * 1e3:.1f} us, sdpa's "
            f"{row['library_pair_ms'] * 1e3:.1f} us")
        # the forward alone at the training shape, as training runs it
        f_fn = lambda: fa_kernel._forward(  # noqa: E731
            q, k, v, True, window, cap, True)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fl_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        f_bound, f_by = fa_bound(B, S, H, KV, D, window, q.element_size(),
                                 lse=True)
        f_ms = device_ms(torch, [f_fn], N_BWD)
        fl_ms = device_ms(torch, [fl_fn], N_BWD)
        say(f"[16] flash_attention forward {shape} with its row "
            f"logsumexp: device {f_ms * 1e3:.3f} us, sdpa's forward "
            f"{fl_ms * 1e3:.3f} us, bound {f_bound * 1e3:.3f} us ({f_by})")
    return row, max_err


def train_counts(counters):
    return (counters["flash_attention"].launches,
            counters["flash_attention_backward"].launches)


def timed_steps(torch, step_fn, state, batches, held=0):
    """(final state, losses, grad norms, ms a step over all but the
    first step, peak GB): ``step_fn`` over ``batches`` on the card; the
    peak counts what the run allocated above ``held`` bytes (memory the
    caller keeps for other runs, such as a copy of the initial
    state)."""
    losses, gnorms, times = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    ms = 1e3 * sum(times[1:]) / max(len(times) - 1, 1)
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    return state, losses, gnorms, ms, peak


def clone_state(torch, state):
    from repro_torch.utils import tree_map

    return tree_map(torch.clone, state)


def states_equal(torch, a, b) -> bool:
    from repro_torch.utils import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def phase_train(torch, np, counters):
    """SmolLM-360M trained at full width on the card: the main path
    through ``launch.train``, the remat policies, 8-bit AdamW, kernel
    against plain, kill and resume, and the smoke configs against the
    CPU.  Returns the main path's launches."""
    import shutil
    import tempfile

    from repro_torch.config import RunConfig, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as launch_train
    from repro_torch.train import step as tstep
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch("smollm-360m")
    B, S, n = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    tokens = n * B * S
    # (b) the main path: the launcher at RunConfig's defaults
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    trainer, state = launch_train.main([
        "--arch", "smollm-360m", "--full-config", "--steps", str(n),
        "--batch", str(B), "--seq", str(S)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    fwd, bwd = train_counts(counters)
    L = cfg.num_layers
    check(fwd == 2 * L * n and bwd == L * n,
          f"the main path launched flash_attention {fwd} and its backward "
          f"{bwd} times, expected {2 * L * n} and {L * n} (dots_saveable "
          f"recomputes each block's forward)")
    others = {k: v for k, v in launches.items()
              if k not in ("flash_attention", "flash_attention_backward")}
    check(not any(others.values()), f"other kernels launched: {others}")
    losses = [m["loss"].item() for m in trainer.history]
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    check(int(state.step) == n, f"the run ended at step {int(state.step)}")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5,
          f"the loss did not fall: {losses}")
    say(f"[16] {cfg.name} at full width ({L} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads}, "
        f"vocab {cfg.vocab_size}), batch {B} x seq {S}, bf16 activations, "
        f"float32 masters, AdamW, remat dots_saveable, through "
        f"launch.train: {n} steps in {wall:.1f} s (model made and the "
        f"first step included), loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"exactly {fwd // n} flash_attention and {bwd // n} backward "
        f"launches a step ({L} forward + {L} recomputed), no other kernel; "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"[16] losses: {[round(x, 4) for x in losses]}")
    del trainer, state
    torch.cuda.empty_cache()

    # the remat policies and "none", 8-bit AdamW: the same first steps
    src = SyntheticLM(cfg, B, S, seed=0)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in
                src.batch_at(i).items()} for i in range(EIGHT_BIT_STEPS)]
    run0 = RunConfig()
    init = tstep.init_train_state(cfg, run0, 0, device="cuda")
    base = None
    for policy in ("none", "dots_saveable",
                   "dots_with_no_batch_dims_saveable", "full"):
        run = dataclasses.replace(run0, remat_policy=policy)
        zero_counts(counters)
        held = torch.cuda.memory_allocated()  # the initial state's copy
        _, ls, gn, ms, peak = timed_steps(
            torch, tstep.make_train_step(cfg, run), clone_state(torch, init),
            batches[:REMAT_STEPS], held)
        fwd, bwd = train_counts(counters)
        per = REMAT_STEPS
        want_fwd = L if policy == "none" else 2 * L
        check(fwd == want_fwd * per and bwd == L * per,
              f"remat {policy}: {fwd} and {bwd} launches over {per} steps")
        if base is None:
            base = ls
        check(ls == base, f"remat {policy}: losses {ls} differ from "
              f"'none''s {base}")
        say(f"[16] remat {policy:34s}: {ms:8.2f} ms a step "
            f"({B * S / ms * 1e3:9.0f} tokens/s), peak {peak:6.2f} GB, "
            f"{fwd // per} + {bwd // per} attention launches a step, "
            f"losses {ls} (equal to none's bit for bit)")
    del init
    torch.cuda.empty_cache()
    run8 = dataclasses.replace(run0, optimizer="adamw8bit")
    _, ls8, _, ms8, peak8 = timed_steps(
        torch, tstep.make_train_step(cfg, run8),
        tstep.init_train_state(cfg, run8, 0, device="cuda"), batches)
    check(all(np.isfinite(ls8)) and ls8[0] == base[0] and ls8[-1] < ls8[0],
          f"adamw8bit losses {ls8}")
    say(f"[16] adamw8bit, {EIGHT_BIT_STEPS} steps: {ms8:.2f} ms a step, "
        f"peak {peak8:.2f} GB, losses {ls8}")
    torch.cuda.empty_cache()

    # (c) kernel path against plain path, float32 activations
    run32 = RunConfig(activation_dtype="float32", remat_policy="none")
    init = tstep.init_train_state(cfg, run32, 0, device="cuda")
    out = {}
    for impl in ("auto", "ref"):
        _, ls, gn, ms, _ = timed_steps(
            torch, tstep.make_train_step(cfg, run32, impl=impl),
            clone_state(torch, init), batches[:PLAIN_STEPS])
        out[impl] = (ls, gn, ms)
    (lk, gk, msk), (lp, gp, msp) = out["auto"], out["ref"]
    for a, b in zip(lk, lp):
        check(abs(a - b) <= LOSS_TOL * (1 + abs(b)),
              f"kernel vs plain losses {lk} and {lp}")
    for a, b in zip(gk, gp):
        check(abs(a - b) <= GNORM_TOL * (1 + abs(b)),
              f"kernel vs plain grad norms {gk} and {gp}")
    say(f"[16] float32 activations, {PLAIN_STEPS} steps, kernel path "
        f"against plain path: losses {lk} and {lp} (within {LOSS_TOL}), "
        f"grad norms {gk} and {gp} (within {GNORM_TOL}); {msk:.1f} "
        f"against {msp:.1f} ms a step")
    del init
    torch.cuda.empty_cache()

    # (d) kill and resume at 4 layers: checkpoints every 2 steps through
    # the MIDAS lanes; the process dies after step 5, a new one resumes
    # from step 4 to 6; the uninterrupted run's state bit for bit
    small = dataclasses.replace(cfg, num_layers=RESUME_LAYERS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        def trainer(steps, ckpt):
            tc = TrainerConfig(steps=steps, batch=B, seq=S, ckpt_every=2,
                               ckpt_dir=ckpt, log_every=steps)
            return Trainer(small, run0, tc, log_fn=lambda _: None)

        t = trainer(6, None)
        whole = t.train()
        t.close()
        t = trainer(5, tmp)
        t.train()
        t.close()
        t = trainer(6, tmp)
        resumed_from = t.ckpt.latest_step()
        resumed = t.train()
        t.close()
        check(resumed_from == 4, f"latest checkpoint {resumed_from}")
        check(states_equal(torch, whole, resumed),
              "the resumed run's state differs from the uninterrupted one")
        say(f"[16] kill and resume at {RESUME_LAYERS} of {L} layers: "
            f"checkpoints at steps 2 and 4 written asynchronously through "
            f"4 MIDAS lanes, killed after step 5, resumed from step 4 to "
            f"6: the state equals the uninterrupted run's bit for bit")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_train_small(torch, np, counters)
    return launches, dict(tokens=tokens, wall=wall)


def phase_train_small(torch, np, counters):
    """(e) Each smoke config's loss and gradients on the card against
    the CPU, float32 activations, then one train step on the card:
    Mamba models refuse the kernel path (``impl="auto"``) and run the
    plain one.  The MoE's gradient leaves are not compared one by one:
    a near-tie of two gate logits can send a token to another expert on
    the card than on the CPU."""
    from repro_torch.config import RunConfig, get_smoke_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.train import step as tstep
    from repro_torch.utils import tree_leaves

    run = RunConfig(activation_dtype="float32", remat_policy="none")
    for arch in TRAIN_SMOKE:
        cfg = get_smoke_arch(arch)
        batch = SyntheticLM(cfg, 2, 32, seed=0).batch_at(0)
        impl = "auto"
        if cfg.mamba is not None:
            st = tstep.init_train_state(cfg, run, 0, device="cuda")
            b = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
            try:
                tstep.make_train_step(cfg, run)(st, b)
            except NotImplementedError as e:
                check("chunk_scan" in str(e) and "ROADMAP" in str(e),
                      f"{arch}: the refusal does not name the queue: {e}")
            else:
                raise PhaseError(f"{arch}: the chunk_scan kernel trained")
            impl = "ref"
        res = {}
        zero_counts(counters)
        for dev in ("cuda", "cpu"):
            st = tstep.init_train_state(cfg, run, 0, device=dev)
            b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            (loss, _), grads = tstep.value_and_grad(
                cfg, run, st.params, st.moe_state, b, impl=impl)
            if dev == "cuda":
                n = read_counts(counters)
                # the card's pass ran the kernels' backward or, on the
                # plain path, none
                attn = n["flash_attention_backward"] > 0
                moe = n["dispatch_candidates"] + n["dispatch_fused"] > 0
                check(attn == (impl == "auto")
                      and moe == (impl == "auto" and cfg.moe is not None),
                      f"{arch}: launches {n}")
            res[dev] = (loss.item(), [g.float().cpu() for g in
                                      tree_leaves(grads)], st, b)
        (lc, gc, st, b), (lp, gp, _, _) = res["cuda"], res["cpu"]
        nc = sum(float((g.double() ** 2).sum()) for g in gc) ** 0.5
        npu = sum(float((g.double() ** 2).sum()) for g in gp) ** 0.5
        check(abs(lc - lp) <= LOSS_TOL * (1 + abs(lp))
              and abs(nc - npu) <= GNORM_TOL * (1 + npu),
              f"{arch}: card loss {lc}, grad norm {nc}; CPU {lp}, {npu}")
        worst = 0.0
        if cfg.moe is None:
            for a, w in zip(gc, gp):
                diff = (a - w).abs().max().item()
                check(diff <= LOSS_TOL * (1 + w.abs().max().item()),
                      f"{arch}: a gradient leaf differs by {diff:.3g}")
                worst = max(worst, diff)
        _, m = tstep.make_train_step(cfg, run, impl=impl)(st, b)
        check(np.isfinite(m["loss"].item()), f"{arch}: the step's loss")
        say(f"[16] {arch} smoke, impl {impl}: card loss {lc:.6f}, grad "
            f"norm {nc:.6f}; CPU {lp:.6f}, {npu:.6f}"
            + ("" if cfg.moe is not None else
               f"; gradient leaves within {worst:.3g}")
            + (" (impl 'auto' refused: no chunk_scan backward)"
               if impl == "ref" else "") + "; one train step on the card")


def kernel_entry(name, source, replaces, launches, max_err, row):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }


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
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.midas_route import kernel, ops, ref
    from repro_torch.kernels.ssm_scan import kernel as cs_kernel
    from repro_torch.kernels.ssm_scan import ref as cs_ref
    from repro_torch.config import get_arch
    from repro_torch.launch import serve as serving

    counters = {"route_select": kernel.route_select,
                "route_tick": kernel.route_tick,
                "flash_attention": fa_kernel.flash_attention,
                "flash_attention_backward":
                    fa_kernel.flash_attention_backward,
                "decode_attention": da_kernel.decode_attention,
                "chunk_scan": cs_kernel.chunk_scan,
                "dispatch_candidates": kernel.dispatch_candidates,
                "dispatch_fused": kernel.dispatch_fused,
                "dispatch_steer": kernel.dispatch_steer}
    sources = [(kernel.SOURCE, kernel.FLAGS),
               (kernel.DISPATCH_SOURCE, kernel.FLAGS),
               (fa_kernel.SOURCE, fa_kernel.FLAGS),
               (fa_kernel.BWD_SOURCE, fa_kernel.FLAGS),
               (da_kernel.SOURCE, da_kernel.FLAGS),
               (cs_kernel.SOURCE, cs_kernel.FLAGS)]
    loaders = [kernel.build, kernel.build_dispatch, fa_kernel.build,
               fa_kernel.build_backward, da_kernel.build, cs_kernel.build]
    t_start = time.perf_counter()
    try:
        phase_build(torch, _build, sources, loaders)
        rows, max_err = phase_kernel(torch, kernel, ref)
        tick_row = phase_route_tick(torch, np, sim, kernel)
        phase_member_route(torch, np, sim, kernel, ref)
        attn_rows, attn_err = phase_attention(torch, fa_kernel, fa_ref,
                                              da_kernel, da_ref)
        cs_rows, cs_err = phase_chunk_scan(torch, cs_kernel, cs_ref)
        mr_rows, mr_err = phase_dispatch(torch, kernel, ref, ops)
        say(f"[2] phases 1-2 took {time.perf_counter() - t_start:.1f} s")
        cfg, wl, res, targets, tick_launches = phase_main(
            torch, np, core, sim, counters)
        pod_launches = phase_power_of_d(torch, np, core, sim, counters,
                                        wl)
        phase_parity(torch, np, core, sim, cfg, wl, res, targets)
        phase_small(np, core)
        t10 = time.perf_counter()
        plane = phase_plane_kernels(torch, np, core, sim, counters, wl,
                                    targets)
        phase_plane_small(np, core, sim)
        claims_launches = phase_claims(core, counters)
        say(f"[10] phase 10 took {time.perf_counter() - t10:.1f} s")
        t11 = time.perf_counter()
        fleet_pod = phase_fleet(torch, np, core, sim, counters)
        say(f"[11] phase 11 took {time.perf_counter() - t11:.1f} s")
        t12 = time.perf_counter()
        fault_tick, fault_pod = phase_faults(torch, np, core, sim, counters,
                                             wl)
        say(f"[12] phase 12 took {time.perf_counter() - t12:.1f} s")
        t13 = time.perf_counter()
        sweep_tick = phase_sweeps(torch, np, core, sim, counters, wl,
                                  targets)
        say(f"[13] phase 13 took {time.perf_counter() - t13:.1f} s")
        t14 = time.perf_counter()
        unroll_pod, unroll_tick = phase_unrolled(torch, np, core, sim,
                                                 counters, wl, targets)
        say(f"[14] phase 14 took {time.perf_counter() - t14:.1f} s")
        model = make_model(torch, get_arch("smollm-360m"), 6)
        _, serve_launches = phase_serve(
            torch, np, serving, counters, model, tag=6,
            per_layer=lambda R, P, T: {"flash_attention": R,
                                       "decode_attention": R * T})
        del model
        torch.cuda.empty_cache()
        phase_serve_small(torch, np, serving)
        t8 = time.perf_counter()
        ssm = get_arch(SSM_ARCH)
        say(f"[8] {ssm.name}: cut to {SSM_LAYERS} of its {ssm.num_layers} "
            f"layers (depth only; every width as published)")
        model = make_model(
            torch, dataclasses.replace(ssm, num_layers=SSM_LAYERS), 8)
        _, ssm_launches = phase_serve(
            torch, np, serving, counters, model, tag=8,
            per_layer=lambda R, P, T: {"chunk_scan": R * -(-P // 128)},
            f32_cache=True)
        del model
        torch.cuda.empty_cache()
        say(f"[8] phase 8 took {time.perf_counter() - t8:.1f} s")
        t9 = time.perf_counter()
        moe_launches, fused_launches = phase_moe(torch, np, serving,
                                                 counters)
        say(f"[9] phase 9 took {time.perf_counter() - t9:.1f} s")
        t15 = time.perf_counter()
        fe_launches = phase_frontends(torch, np, serving, counters)
        say(f"[15] phase 15 took {time.perf_counter() - t15:.1f} s")
        t16 = time.perf_counter()
        bwd_row, bwd_err = phase_train_kernel(torch, fa_kernel, fa_ref)
        train_launches, _ = phase_train(torch, np, counters)
        say(f"[16] phase 16 took {time.perf_counter() - t16:.1f} s")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    main_row = next(
        r for r in rows
        if (r["R"], r["m"], r["d_max"]) == MAIN_SHAPE
        and r["mode"] == "power_of_d"
    )
    main_row = dict(main_row, bound_by="bytes", library_ms=None)
    fa_row = next(r for r in attn_rows if r["shape"] == FA_SERVE
                  and r["name"] == "flash_attention")
    da_row = next(r for r in attn_rows if r["shape"] == DA_SERVE
                  and r["name"] == "decode_attention")
    cs_row = next(r for r in cs_rows if r["shape"] == CS_SERVE)
    mr_row = {r["name"]: r for r in mr_rows if r["shape"] == MR_SERVE}
    # each attention kernel's launches over every serving path
    attn = {name: sum(run[name] for run in (
        serve_launches, moe_launches, fused_launches,
        *fe_launches.values(), train_launches))
        for name in ("flash_attention", "decode_attention")}
    csrc = "src/repro_torch/kernels/{0}/csrc/{1}.cu"
    mr_src = csrc.format("midas_route", "midas_dispatch")
    say(f"[*] total {time.perf_counter() - t_start:.1f} s")
    say(card_line())
    say(json.dumps({"kernels": [
        kernel_entry("route_select", csrc.format("midas_route",
                                                 "route_select"),
                     REPLACES, plane["route_select"]
                     + claims_launches["route_select"] + unroll_pod,
                     max_err, main_row),
        kernel_entry("route_tick", csrc.format("midas_route",
                                               "route_select"),
                     TICK_REPLACES, tick_launches + pod_launches
                     + plane["route_tick"] + claims_launches["route_tick"]
                     + FLEET_TICKS + fleet_pod + fault_tick + fault_pod
                     + sweep_tick + unroll_tick, 0.0, tick_row),
        kernel_entry("flash_attention",
                     csrc.format("flash_attention", "flash_attention"),
                     "src/repro/kernels/flash_attention/kernel.py:110",
                     attn["flash_attention"],
                     attn_err["flash_attention"], fa_row),
        kernel_entry("flash_attention_backward",
                     csrc.format("flash_attention", "flash_attention_bwd"),
                     "src/repro/kernels/flash_attention/kernel.py:110",
                     train_launches["flash_attention_backward"], bwd_err,
                     bwd_row),
        kernel_entry("decode_attention",
                     csrc.format("decode_attention", "decode_attention"),
                     "src/repro/kernels/decode_attention/kernel.py:93",
                     attn["decode_attention"],
                     attn_err["decode_attention"], da_row),
        kernel_entry("chunk_scan", csrc.format("ssm_scan", "chunk_scan"),
                     "src/repro/kernels/ssm_scan/kernel.py:58",
                     ssm_launches["chunk_scan"], cs_err, cs_row),
        kernel_entry("dispatch_candidates", mr_src,
                     "src/repro/kernels/midas_route/kernel.py:135",
                     moe_launches["dispatch_candidates"],
                     mr_err["dispatch_candidates"],
                     mr_row["dispatch_candidates"]),
        kernel_entry("dispatch_fused", mr_src,
                     "src/repro/kernels/midas_route/kernel.py:66",
                     fused_launches["dispatch_fused"],
                     mr_err["dispatch_fused"], mr_row["dispatch_fused"]),
        kernel_entry("dispatch_steer", mr_src,
                     "src/repro/kernels/midas_route/kernel.py:207",
                     moe_launches["dispatch_steer"],
                     mr_err["dispatch_steer"], mr_row["dispatch_steer"]),
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
