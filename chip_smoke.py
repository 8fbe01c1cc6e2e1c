#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version, drives the port's four
paths at full width and checks what comes out: the simulator
(``repro_torch.core.simulate``: MIDAS routing, the cooperative cache,
the hysteresis controller, the ``bursty`` workload) and serving
(``repro_torch.launch.serve.serve``: the MIDAS router in front of
prefill and greedy decode) of SmolLM-360M, falcon-mamba-7b and
Qwen3-MoE-235B-A22B.  Phases:

1. card and build: the card's name and power limit, the five sources
   built at once (one nvcc each);
2. every kernel against its plain version on the card, with its device
   time (CUDA-graph replay), the time a Python caller pays per call,
   its bound and, where one PyTorch call computes the same function,
   that call's time (a yardstick only; the port never calls it:
   ``scaled_dot_product_attention`` for attention, ``torch.topk`` for
   the dispatch candidates; no PyTorch call computes ``route_select``,
   ``chunk_scan`` or the fused dispatch); ``flash_attention`` also at
   Qwen3-MoE's prefill shape, with its bound on the tensor cores and
   the CUDA cores' beside it, and bitwise equal on a repeated call;
3. the simulator at full width (m = 64 servers, N = 10**6 keys, V = 64
   vnodes, 512 request slots per tick, T = 1200 ticks), counting
   ``route_select``'s launches;
4. the same run with the plain version in place of the kernel, which
   must give the same timelines bit for bit;
5. a small simulator run on the card against the same run on the CPU;
6. serving at SmolLM-360M's full width and depth (32 layers, d_model
   960, 15 query heads over 5 KV heads; random weights from seed 0):
   8 requests of a 512-token prompt and 32 greedy decode steps behind a
   4-replica router, counting both attention kernels' launches; the
   same run with the plain attention gives the same tokens, and
   teacher-forced logits of the two agree;
7. a small serving run at the smoke configs on the card against the
   same run on the CPU (falcon-mamba's, the MoE models' and jamba's
   tokens under the margin rule of phase 8, and their teacher-forced
   logits, on a float32 cache, within the CPU tests' 1e-4);
8. serving at falcon-mamba-7b's full width and depth (64 Mamba-1
   layers, d_model 4096, d_inner 8192, d_state 16; random weights from
   seed 0, 29.1 GB in float32) with phase 6's traffic, counting
   ``chunk_scan``'s launches (one per layer and 128-token chunk of
   each prompt; decode is plain PyTorch, as in the reference); the
   same run with the plain scan gives the same tokens wherever the
   plain run's teacher-forced top-2 margin is decisive, and
   teacher-forced logits of the two agree (and are reported on a
   float32 cache too);
9. serving at Qwen3-MoE-235B-A22B's full width (d_model 4096, 64 query
   heads over 4 KV heads, head_dim 128, 128 experts top-8 of width
   1536, midas_d 2, f_max 0.25, vocab 151936) cut to 4 of its 94
   layers (11.19 B parameters, 44.8 GB in float32, random from seed
   0) with phase 6's traffic, counting ``dispatch_candidates`` (one
   launch per layer per prefill and per decode step), both attention
   kernels and no other; tokens under the margin rule against the
   plain path; the serving path's telemetry is balanced, so nothing
   steers, as in the reference; then 2 requests through the f_max = 1
   variant on the same weights, which launches ``dispatch_fused``
   instead.

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
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 on the CUDA cores
# H100 SXM dense tensor-core peaks: TF32, whose 3xTF32 split makes three
# products of every float32 one, and bfloat16
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# serving (phase 6): the launcher's shapes at SmolLM-360M's width
SERVE = dict(requests=8, prompt_len=512, decode_len=32, replicas=4, seed=0)
SERVE_LOGIT_TOL = 2e-2  # kernel vs plain teacher-forced logits, rel + abs
SMALL_LOGIT_TOL = 1e-4  # card vs CPU at the smoke configs, as the CPU tests
# the exponentials of chunk_scan run on the special-function units: 16
# per SM per clock, 132 SMs, at the H100 SXM's 1.98 GHz boost clock
EXP_PER_S = 16 * 132 * 1.98e9
SCAN_TOL = 1e-4  # chunk_scan vs its plain version, rel + abs
N_TIMED = 1000  # back-to-back calls per host-side timing
N_GRAPH = 200  # calls per CUDA graph for device timing
# MoE serving (phase 9): Qwen3-MoE-235B-A22B at full width, depth cut
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 4
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


def device_ms(torch, fns, n) -> float:
    """Per-call device time: n calls captured in one CUDA graph and
    replayed between CUDA events, so no host-side cost is counted.
    Call j runs ``fns[j % len(fns)]``: several input sets whose total
    exceeds the 50 MB L2 make every call read its inputs cold.  The
    calls run once in the stream that captures them, so what a wrapper
    keeps per stream is made before the capture."""
    side = torch.cuda.Stream()
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
# phase 2 (continued): the attention kernels against their plain versions
# ---------------------------------------------------------------------------

# (B, S, H, KV, D, window, softcap, dtype): the CPU tests' cases, then
# SmolLM-360M's serving shapes (a 512-token prompt; one token against a
# 544-row cache at its last position) and a ragged, padded-head shape;
# prefill also Qwen3-MoE's 512-token prompt;
# decode also a cache no multiple of its span, rows at other positions,
# a window narrower than a span, a 65536-row cache (spans of many
# tiles) and Qwen3-MoE's decode shape
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
]
FA_SERVE = (1, 512, 15, 5, 64, 0, 0.0, "float32")
FA_MOE = (1, 512, 64, 4, 128, 0, 0.0, "float32")  # qwen3-moe's prefill
DA_SERVE = (1, 544, 15, 5, 64, 0, 0.0, "float32")
DA_MOE = (1, 544, 64, 4, 128, 0, 0.0, "float32")  # qwen3-moe's decode


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


def fa_bound(B, S, H, KV, D, window, itemsize, rate=None):
    """(bound ms, "bytes" or "operations") of causal attention: q, k, v
    read once and the output written once against 4 D operations per
    kept pair and head on the tensor cores the kernel uses (float32 as
    3xTF32: the TF32 rate over 3), or at ``rate`` FLOP/s (the float32
    CUDA cores' of the CUDA-core kernel, kept for comparison)."""
    if rate is None:
        rate = (BF16_FLOP_PER_S if itemsize == 2 else TF32_FLOP_PER_S / 3)
    byts = (2 * B * S * H * D + 2 * B * S * KV * D) * itemsize
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
        # layer's cache): 40 input sets (1.4 and 2.3 MB each) exceed the
        # L2
        serving = shape in (DA_SERVE, DA_MOE)
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
# timed: qwen3-moe's decode token (the JSON row) and prefill
MR_TIMED = [(1, 128, 8, 2), (512, 128, 8, 2)]
MR_SERVE = (1, 128, 8, 2)


def dispatch_inputs(torch, T, E, seed, variant):
    """Gate logits (T, E) and load (E,) on the card: skewed loads, so
    tokens steer; ``ties`` rounds both to a few values; ``balanced``
    is the serving path's load of ones, under which nothing steers."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((T, E), generator=g, device="cuda") * 2.0
    load = torch.randn((E,), generator=g, device="cuda").abs() * 3.0
    if variant == "ties":
        logits = torch.round(logits) / 2.0 + 0.0
        load = torch.round(load)
    if variant == "balanced":
        load = torch.ones_like(load)
    return logits.contiguous(), load


def dispatch_bound(T, E, k, kd, fused):
    """(bound ms, "bytes" or "operations"): the logits (and the load)
    read once and the outputs written once (candidates: ids int32 and
    logits float32 per candidate; fused: experts int32, weights float32
    and one steered byte per slot), against the (k+d)·E compare-selects
    of a row at the float32 rate."""
    byts = 4 * T * E + (4 * E + 9 * T * k if fused else 8 * T * kd)
    ops = T * E * kd
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_dispatch(torch, kernel, ref, ops):
    """Both dispatch kernels against the plain version on identical
    inputs: candidates, experts and steered flags equal, weights within
    W_TOL; then their times at the serving shapes."""
    err = {"dispatch_candidates": 0.0, "dispatch_fused": 0.0}
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
        name = "dispatch_fused" if f_max >= 1.0 else "dispatch_candidates"
        err[name] = max(err[name], w_err)
        if variant == "balanced":
            check(not bool(got[2].any()), f"dispatch {what}: a token "
                  f"steered under balanced load")
        steered += int(got[2].sum())
        cases += 1
    check(steered > 0, "no dispatch case steered")
    say(f"[2] dispatch_candidates and dispatch_fused: {cases} cases "
        f"(tests/test_kernels.py's MR shapes, ragged T, ties, qwen3-moe's "
        f"serving shapes, E = 16) equal to the plain version on "
        f"candidates, experts and steered ({steered} slots steered); "
        f"weights within {max(err.values()):.3g} (allowed {W_TOL})")

    rows = []
    for T, E, k, d in MR_TIMED:
        kd = k + d
        logits, load = dispatch_inputs(torch, T, E, 7, "random")
        for name, fused in (("dispatch_candidates", False),
                            ("dispatch_fused", True)):
            if fused:
                k_fn = lambda: kernel.dispatch_fused(  # noqa: E731
                    logits, load, k, d)
                p_fn = lambda: ref.midas_dispatch(  # noqa: E731
                    logits, load, k, d, f_max=1.0)
                lib_ms = None
                path = (lambda: ops.midas_dispatch(  # noqa: E731
                    logits, load, k, d, f_max=1.0, impl="cuda"), p_fn)
            else:
                k_fn = lambda: kernel.dispatch_candidates(  # noqa: E731
                    logits, kd)
                p_fn = lambda: ref.top_candidates(logits, kd)  # noqa: E731
                lib_ms = device_ms(torch, [lambda: torch.topk(logits, kd)],
                                   N_GRAPH)
                path = (lambda: ops.midas_dispatch(  # noqa: E731
                    logits, load, k, d, f_max=0.25, impl="cuda"),
                    lambda: ref.midas_dispatch(
                        logits, load, k, d, f_max=0.25))
            bound, by = dispatch_bound(T, E, k, kd, fused)
            rows.append(dict(
                name=name, shape=(T, E, k, d), ms=device_ms(
                    torch, [k_fn], N_GRAPH),
                plain_ms=device_ms(torch, [p_fn], N_GRAPH),
                host_ms=host_ms(torch, k_fn),
                path_ms=host_ms(torch, path[0], 200),
                plain_path_ms=host_ms(torch, path[1], 200),
                bound_ms=bound, bound_by=by, library_ms=lib_ms,
                max_abs_err=err[name]))
    for r in rows:
        lib = ("none computes it" if r["library_ms"] is None
               else f"torch.topk {r['library_ms'] * 1e3:.3f} us")
        path = ("f_max 1" if r["name"] == "dispatch_fused"
                else "f_max 0.25 with the quantile and steering")
        say(f"[2] {r['name']} (T, E, k, d) = {r['shape']}: device kernel "
            f"{r['ms'] * 1e3:.3f} us, plain {r['plain_ms'] * 1e3:.3f} us, "
            f"{lib}, bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}); "
            f"called from Python {r['host_ms'] * 1e3:.2f} us; the whole "
            f"dispatch ({path}) called from Python: kernel path "
            f"{r['path_ms'] * 1e3:.1f} us, plain "
            f"{r['plain_path_ms'] * 1e3:.1f} us")
    return rows, err


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


def zero_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def phase_main(torch, np, core, sim, counters):
    cfg = core.SimConfig(policy="midas", middleware=("cache",),
                         cache_mode="lease", **FULL)
    wl = core.make_workload("bursty", T=T_FULL, m=cfg.m, seed=SEED,
                            N=cfg.N, R=R_FULL, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.warmup(cfg, device="cuda")
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = time.perf_counter()
    res = core.simulate(cfg, wl, device="cuda")
    run_s = time.perf_counter() - t0
    counts = read_counts(counters)
    launches = counts["route_select"]
    want = dict.fromkeys(counters, 0)
    want["route_select"] = T_FULL * cfg.n_groups
    say(f"[3] launches in the main path: {counts} (expected T x n_groups "
        f"= {want['route_select']} route_select, no other kernel)")
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


# ---------------------------------------------------------------------------
# phases 6-8: serving
# ---------------------------------------------------------------------------


def replay_traffic(np, router, vocab, *, requests, prompt_len, seed, **_):
    """The launcher's traffic on the host: each request's session is
    routed, then its prompt drawn, from one numpy generator.  Returns
    the prompts and the routes an independent router takes."""
    rng = np.random.default_rng(seed)
    prompts, routes = [], []
    for req in range(requests):
        session = int(rng.zipf(1.4)) % 16
        route = router.route(session, req * 50.0, prefix_hash=session % 4)
        routes.append(route)
        prompts.append(rng.integers(0, vocab, (1, prompt_len)))
        router.complete(route[0])
        router.ingest_telemetry()
    return prompts, routes


def teacher_forced(torch, models, model, prompt, tokens, impl, cache_len,
                   device="cuda", cache_dtype=None):
    """Logits (1 + decode steps, V) of one request fed ``tokens``, as
    the launcher runs it (a bfloat16 cache read back in float32), or
    with a ``cache_dtype`` cache."""
    batch = {"tokens": torch.as_tensor(prompt, dtype=torch.int32,
                                       device=device)}
    lg, cache = models.prefill(model, batch, cache_len=cache_len,
                               cache_dtype=cache_dtype or torch.bfloat16,
                               impl=impl)
    cache = {p: {n: a.float() for n, a in c.items()}
             for p, c in cache.items()}
    out = [lg[0, -1]]
    P = prompt.shape[1]
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
        np, MidasRouter(replicas=traffic["replicas"], d=3, f_max=0.25),
        cfg.vocab_size, **traffic)
    check(res.routes == routes, "the router's decisions differ from a "
          "replay of the same traffic")
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
                            res.tokens[req], "cuda", P + T)
        lp = teacher_forced(torch, models, model, prompts[req],
                            res.tokens[req], "ref", P + T)
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
                                     res.tokens[req], impl, P + T,
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
                 "qwen3-moe-235b-a22b", "dbrx-132b", "jamba-v0.1-52b"):
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
                f"{cfg.window_size}, softcap {cfg.logit_softcap}): the "
                f"card's {gpu.tokens.size} tokens equal the CPU run's")
            continue
        prompts, _ = replay_traffic(
            np, MidasRouter(replicas=kw["replicas"], d=3, f_max=0.25),
            cfg.vocab_size, **kw)
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
    ``dispatch_candidates`` (f_max 0.25), a check that the serving
    path's balanced telemetry steers nothing, then the f_max = 1
    variant's run through ``dispatch_fused`` on the same weights."""
    from repro_torch import models
    from repro_torch.config import get_arch
    from repro_torch.serve import MidasRouter

    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    say(f"[9] {full.name}: cut to {MOE_LAYERS} of its {full.num_layers} "
        f"layers (depth only; every width as published)")
    model = make_model(torch, cfg, 9)
    _, launches = phase_serve(
        torch, np, serving, counters, model, tag=9,
        per_layer=lambda R, P, T: {"dispatch_candidates": R * (1 + T),
                                   "flash_attention": R,
                                   "decode_attention": R * T})
    prompt = torch.as_tensor(replay_traffic(
        np, MidasRouter(replicas=SERVE["replicas"], d=3, f_max=0.25),
        cfg.vocab_size, **SERVE)[0][0], dtype=torch.int32, device="cuda")
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
    _, fused_launches = phase_serve(
        torch, np, serving, counters, fused_model, tag=9,
        per_layer=lambda R, P, T: {"dispatch_fused": R * (1 + T),
                                   "flash_attention": R,
                                   "decode_attention": R * T},
        traffic=traffic)
    return launches, fused_launches


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
                "flash_attention": fa_kernel.flash_attention,
                "decode_attention": da_kernel.decode_attention,
                "chunk_scan": cs_kernel.chunk_scan,
                "dispatch_candidates": kernel.dispatch_candidates,
                "dispatch_fused": kernel.dispatch_fused}
    sources = [(kernel.SOURCE, kernel.FLAGS),
               (kernel.DISPATCH_SOURCE, kernel.FLAGS),
               (fa_kernel.SOURCE, fa_kernel.FLAGS),
               (da_kernel.SOURCE, da_kernel.FLAGS),
               (cs_kernel.SOURCE, cs_kernel.FLAGS)]
    loaders = [kernel.build, kernel.build_dispatch, fa_kernel.build,
               da_kernel.build, cs_kernel.build]
    t_start = time.perf_counter()
    try:
        phase_build(torch, _build, sources, loaders)
        rows, max_err = phase_kernel(torch, kernel, ref)
        attn_rows, attn_err = phase_attention(torch, fa_kernel, fa_ref,
                                              da_kernel, da_ref)
        cs_rows, cs_err = phase_chunk_scan(torch, cs_kernel, cs_ref)
        mr_rows, mr_err = phase_dispatch(torch, kernel, ref, ops)
        say(f"[2] phases 1-2 took {time.perf_counter() - t_start:.1f} s")
        cfg, wl, res, launches = phase_main(torch, np, core, sim, counters)
        phase_parity(torch, np, core, cfg, wl, res)
        phase_small(np, core)
        model = make_model(torch, get_arch("smollm-360m"), 6)
        _, serve_launches = phase_serve(
            torch, np, serving, counters, model, tag=6,
            per_layer=lambda R, P, T: {"flash_attention": R,
                                       "decode_attention": R * T})
        del model
        torch.cuda.empty_cache()
        phase_serve_small(torch, np, serving)
        t8 = time.perf_counter()
        model = make_model(torch, get_arch("falcon-mamba-7b"), 8)
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
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    main_row = next(
        r for r in rows
        if (r["R"], r["m"], r["d_max"]) == MAIN_SHAPE and r["mode"] == "midas"
    )
    main_row = dict(main_row, bound_by="bytes", library_ms=None)
    fa_row = next(r for r in attn_rows if r["shape"] == FA_SERVE
                  and r["name"] == "flash_attention")
    da_row = next(r for r in attn_rows if r["shape"] == DA_SERVE
                  and r["name"] == "decode_attention")
    cs_row = next(r for r in cs_rows if r["shape"] == CS_SERVE)
    mr_row = {r["name"]: r for r in mr_rows if r["shape"] == MR_SERVE}
    csrc = "src/repro_torch/kernels/{0}/csrc/{1}.cu"
    mr_src = csrc.format("midas_route", "midas_dispatch")
    say(f"[*] total {time.perf_counter() - t_start:.1f} s")
    say(card_line())
    say(json.dumps({"kernels": [
        kernel_entry("route_select", csrc.format("midas_route",
                                                 "route_select"),
                     REPLACES, launches, max_err, main_row),
        kernel_entry("flash_attention",
                     csrc.format("flash_attention", "flash_attention"),
                     "src/repro/kernels/flash_attention/kernel.py:110",
                     serve_launches["flash_attention"],
                     attn_err["flash_attention"], fa_row),
        kernel_entry("decode_attention",
                     csrc.format("decode_attention", "decode_attention"),
                     "src/repro/kernels/decode_attention/kernel.py:93",
                     serve_launches["decode_attention"],
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
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
