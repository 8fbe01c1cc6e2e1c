#!/usr/bin/env python3
"""Time the design steps of ``flash_attention``, ``decode_attention``,
``chunk_scan`` and the MoE dispatch on the card at the serving shapes,
and the flash-attention backward at the training shape.

    python3 benchmarks_torch/kernel_steps.py [--parent DIR]
        [--only flash_attention flash_attention_backward
                decode_attention chunk_scan dispatch]

Each variant is first checked against the plain version, then timed as
``chip_smoke.py`` phase 2 times a kernel: calls over input sets that
exceed the 50 MB L2, captured in one CUDA graph and replayed; and, for
``decode_attention``, one call at a time from Python (``host_ms``).
Variants:

- ``flash_attention`` at SmolLM-360M's and Qwen3-MoE's prefill shapes,
  step by step (``FA_STEPS``): the tensor cores with the 3xTF32 split
  alone (64-row query tiles of one head, as the CUDA-core kernel's
  grid; K/V tiles copied and waited for one at a time; units in grid
  order), then with the next tile's copies in flight, then with a GQA
  group's heads stacked in a block, then as shipped (heavy-first order
  and the plan's key splits); other block tilings than the plan's
  (``FA_PLANS``); and a 1xTF32 copy, information only (its error is
  reported, and it is never shipped).  The counts of tensor-core
  instructions (HMMA, HGMMA) in the built library come from
  ``cuobjdump --dump-sass``;
- ``decode_attention`` at SmolLM-360M's and Qwen3-MoE's decode shapes:
  the split plan's span, other spans (a grid of 2 x 132 blocks, and
  fewer, longer spans; the wrapper's ``split_plan`` replaced for the
  run, ``Plan``), and the plan with 4-byte loads (inputs offset by one
  element, so the 16-byte path is not taken); and the plan alone at a
  65536-row cache of Qwen3-MoE's widths;
- ``flash_attention_backward`` at SmolLM-360M's training shape (B 8,
  S 512, 15 heads over 5, head_dim 64) in bfloat16 and float32, as
  ``chip_smoke.py`` phase 16 times it (one input set, hot), checked
  against ``ref.mha_backward`` first; with the library's tensor-core
  and atomic instructions from ``cuobjdump --dump-sass``;
- ``chunk_scan`` at falcon-mamba-7b's serving chunk: 16-byte ``cp.async``
  copies, and 4-byte ones (inputs offset by one element);
- the MoE dispatch at qwen3-moe's decode token and prompt (T = 1 and
  512, E 128, top-8, d 2), hot as in ``chip_smoke.py`` phase 2:
  ``dispatch_candidates`` and ``dispatch_fused`` under the wrapper's
  selection plan and other rows a block (``SelectPlan``), pass 2
  of f_max 0.25 (``dispatch_steer``; in the other checkout, if it has
  none, ``ref.steer_from_candidates`` in PyTorch), and both passes of
  f_max 0.25 one after the other, under a skewed load and under the
  serving path's balanced one, each also called from Python;
- ``dispatch_steer``'s quantile select at T = 32 to 4096
  (``STEER_SELECT_T``) on a load under which most tokens' benefits
  clear the floor (``steer_hot``: the select runs in most slots), by
  each path (``SteerPlan``): shuffles in one warp (T <= 32), counting
  ranks, the radix select; beyond the register kernel's tokens only
  the radix select runs.

Some steps are copies of this checkout's source with one part put back
as it was, built into ``build/`` (``PATCHES``): ``decode_attention``
with 256 or with 512 threads for every group (the source picks 512 for
8 or more heads a KV group), and with a ``__threadfence`` and
``atomicAdd`` ticket in place of the acq_rel one; ``chunk_scan`` with
``__expf`` in place of the flushing exponential.

``--parent DIR`` also times the kernels of another checkout (its
``src/repro_torch/kernels/*/kernel.py``), in turns with this one:
parent, this, this, parent.  Results go to ``build/kernel_steps.json``
as well.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# and a 65536-row cache at Qwen3-MoE's widths (spans of many tiles;
# one input set of 268 MB is cold by itself, and only the plan is run)
DA_LONG = (1, 65536, 64, 4, 128, 0, 0.0, "float32")
DA_TIMED = [cs.DA_SERVE, cs.DA_MOE, DA_LONG]
N_SETS = 40
PARENT = "the other checkout's kernel"  # the --parent rows' label
KERNELS = ("flash_attention", "flash_attention_backward",
           "decode_attention", "chunk_scan", "dispatch")
FA_TIMED = [cs.FA_SERVE, cs.FA_MOE]
FA_BWD_TIMED = [cs.FA_BWD_TRAIN, cs.FA_BWD_SHAPES[1]]  # bf16, float32
FA_COLD_BYTES = 64e6  # input sets of a flash_attention timing, in all
# flash_attention's design switches, each set otherwise in a copy
FA_SWITCHES = {
    "sync": ("constexpr bool kAsync = true;",
             "constexpr bool kAsync = false;"),
    "grid order": ("constexpr bool kHeavyFirst = true;",
                   "constexpr bool kHeavyFirst = false;"),
    "1xTF32": ("constexpr bool kSplit = true;",
               "constexpr bool kSplit = false;"),
}


def group_plan(B, S, H, KV, D):
    """The most heads of the KV group that a block's warps take, strips
    for the rest of its warps, and no key splits."""
    max_warps = 4 if D > 128 else 8
    gh = max(x for x in range(1, max_warps + 1) if (H // KV) % x == 0)
    return gh, max(1, min(4, max_warps // gh)), 1


# (label, switches set otherwise, plan: None for the wrapper's, else a
# function of the shape); each step adds one design step to the last
FA_STEPS = [
    ("tensor cores, 3xTF32: 64-row tiles of one head, K/V waited for",
     ("sync", "grid order"), lambda *shape: (1, 4, 1)),
    ("+ K/V copies in flight (cp.async, two stages)", ("grid order",),
     lambda *shape: (1, 4, 1)),
    ("+ a GQA group's heads stacked in a block", ("grid order",),
     group_plan),
    ("+ heavy-first order and key splits (shipped)", (), None),
    ("1xTF32 copy, information only", ("1xTF32",), None),
]
# other block tilings (gh, nb, ks) at the two prefill shapes
FA_PLANS = {
    cs.FA_SERVE: [(1, 4, 1), (1, 1, 1), (1, 2, 2), (1, 1, 4), (3, 1, 1),
                  (3, 1, 2), (1, 4, 2), (1, 2, 4), (3, 2, 1)],
    cs.FA_MOE: [(8, 1, 1), (4, 1, 1), (4, 1, 2), (4, 2, 1), (2, 4, 1),
                (2, 1, 4), (1, 4, 1), (1, 4, 2), (2, 2, 2)],
}
# (kernel, variant): (text of the source, its replacement)
PATCHES = {
    ("decode_attention", "256 threads for every group"): (
        "  if (H / KV >= 8)\n", "  if (false)\n"),
    ("decode_attention", "512 threads for every group"): (
        "  if (H / KV >= 8)\n", "  if (true)\n"),
    ("decode_attention", "__threadfence + atomicAdd ticket"): (
        """    cuda::atomic_ref<int, cuda::thread_scope_device> ticket(*c);
    const int t = ticket.fetch_add(1, cuda::memory_order_acq_rel);
    s_last = t == splits - 1;
    if (s_last) ticket.store(0, cuda::memory_order_relaxed);  // reset""",
        """    __threadfence();
    const int t = atomicAdd(c, 1);
    s_last = t == splits - 1;
    if (s_last) *c = 0;
    __threadfence();"""),
    ("chunk_scan", "__expf"): (
        "exp_ftz(dv * a[i])", "__expf(dv * a[i])"),
}


def build_patched(module, edits, tag):
    """``module``'s library built from its source with each ``(old,
    new)`` of ``edits`` applied, with the argument types its wrapper
    declares."""
    from repro_torch.kernels import _build

    text = module.SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{module.SOURCE.name}: patch text not found")
        text = text.replace(old, new)
    src = ROOT / "build" / f"{module.SOURCE.stem}_{tag}.cu"
    src.parent.mkdir(exist_ok=True)
    src.write_text(text)
    lib = src.with_suffix(".so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *module.FLAGS, "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    patched = ctypes.CDLL(str(lib))
    name = f"{module.SOURCE.stem}_launch"
    fn, ref_fn = getattr(patched, name), getattr(module._lib(), name)
    fn.argtypes, fn.restype = ref_fn.argtypes, ref_fn.restype
    return patched


def sass_counts(source, flags) -> str:
    """Tensor-core instructions (HMMA, HGMMA) in the SASS of the library
    built from ``source``."""
    from repro_torch.kernels import _build

    lib = _build.library_path(source, flags)
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "--dump-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    n = collections.Counter(re.findall(r"\b(HMMA|HGMMA)\.(\S+)", out))
    return ", ".join(f"{op}.{kind}: {c}" for (op, kind), c in
                     sorted(n.items())) or "none"


class Plan:
    """Within the block, ``kernel``'s wrapper cuts the cache rows into
    spans of ``span`` rows (None: its own split plan)."""

    def __init__(self, kernel, span):
        self.kernel, self.span = kernel, span

    def __enter__(self):
        self.saved = self.kernel.split_plan
        if self.span is not None:
            self.kernel.split_plan = lambda B, S, KV: (self.span,
                                                       -(-S // self.span))
        self.kernel._plan.cache_clear()

    def __exit__(self, *exc):
        self.kernel.split_plan = self.saved
        self.kernel._plan.cache_clear()


class TilePlan:
    """Within the block, the flash_attention wrapper ``kernel`` tiles its
    blocks by ``plan(B, S, H, KV, D)`` (None: its own tile_plan)."""

    def __init__(self, kernel, plan):
        self.kernel, self.plan = kernel, plan

    def __enter__(self):
        self.saved = self.kernel.tile_plan
        if self.plan is not None:
            self.kernel.tile_plan = self.plan
        self.kernel._plan.cache_clear()

    def __exit__(self, *exc):
        self.kernel.tile_plan = self.saved
        self.kernel._plan.cache_clear()


class SelectPlan:
    """Within the block, the midas_route wrapper ``kernel`` runs its
    selection with ``plan`` rows a block for every shape."""

    def __init__(self, kernel, plan):
        self.kernel, self.plan = kernel, plan

    def __enter__(self):
        self.saved = self.kernel.select_plan
        self.kernel.select_plan = lambda T, E: self.plan
        self.kernel._plan.cache_clear()

    def __exit__(self, *exc):
        self.kernel.select_plan = self.saved
        self.kernel._plan.cache_clear()


class SteerPlan:
    """Within the block, the midas_route wrapper ``kernel`` runs
    ``dispatch_steer``'s select with ``plan`` (warp, count_max) at every
    T."""

    def __init__(self, kernel, plan):
        self.kernel, self.plan = kernel, plan

    def __enter__(self):
        self.saved = self.kernel.steer_plan
        self.kernel.steer_plan = lambda T: self.plan

    def __exit__(self, *exc):
        self.kernel.steer_plan = self.saved


class Swap:
    """Within the block, ``module``'s wrapper launches ``lib``."""

    def __init__(self, module, lib):
        self.module, self.lib = module, lib

    def __enter__(self):
        self.saved = self.module._lib
        self.module._lib = lambda: self.lib

    def __exit__(self, *exc):
        self.module._lib = self.saved


def ptxas_summary(log: str) -> str:
    """Functions, their registers, and those that spill, from a
    ``-Xptxas -v`` log."""
    name, regs, spills = "?", [], []
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("for", 1)[1].strip()
        elif "spill" in line and not line.strip().startswith(
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill"):
            spills.append(f"{name}: {line.strip()}")
        elif "Used" in line and "registers" in line:
            regs.append(int(line.split("Used", 1)[1].split()[0]))
    if not regs:
        return "built before this run (no log)"
    return (f"{len(regs)} functions, {min(regs)}-{max(regs)} registers, "
            f"spills: {'; '.join(spills) or 'none'}")


def load_parent(parent: Path, sub: str):
    """The parent checkout's kernel module ``sub`` (its own source, built
    under its own hash)."""
    path = parent / "src/repro_torch/kernels" / sub / "kernel.py"
    spec = importlib.util.spec_from_file_location(
        f"parent_{sub.replace('/', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def offset(torch, t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def da_variants(kernel, shape):
    """The split plan, and other spans: a grid of about 2 x 132 blocks,
    and fewer, longer spans."""
    B, S, KV = shape[0], shape[1], shape[3]
    span, splits = kernel.split_plan(B, S, KV)
    out = {f"plan: span {span} ({splits} splits, {B * KV * splits} "
           f"blocks)": dict(span=None)}
    if shape == DA_LONG:
        return out
    for sp in sorted({-(-S // max(1, 2 * kernel.SMS // (B * KV))), 16, 32}):
        if sp != span:
            n = -(-S // sp)
            out[f"span {sp} ({n} splits, {B * KV * n} blocks)"] = dict(
                span=sp)
    out["plan, 4-byte loads"] = dict(span=None, misalign=True)
    return out


def time_da(torch, kernel, ref, shape, label, span=None, misalign=False):
    B, S, H, KV, D, window, cap, dtype = shape
    g = torch.Generator(device="cuda").manual_seed(S + H + D)
    dt = getattr(torch, dtype)
    sets = []
    for _ in range(1 if shape == DA_LONG else N_SETS):
        q = torch.randn((B, H, D), generator=g, device="cuda", dtype=dt)
        kc, vc = (torch.randn((B, S, KV, D), generator=g, device="cuda",
                              dtype=dt) for _ in range(2))
        if misalign:
            q, kc, vc = (offset(torch, x) for x in (q, kc, vc))
        sets.append((q, kc, vc))
    pos = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
    kw = dict(window=window, softcap=cap)
    q, kc, vc = sets[0]
    fns = [lambda a=a: kernel.decode_attention(*a, pos, **kw) for a in sets]
    with (Plan(kernel, span) if span is not None else nullcontext()):
        got = kernel.decode_attention(q, kc, vc, pos, **kw)
        want = ref.decode_attention(q, kc, vc, pos, **kw)
        err = cs.attn_err(torch, got, want, dtype, f"{label} {shape}")
        return dict(kernel="decode_attention", shape=shape, variant=label,
                    ms=cs.device_ms(torch, fns, cs.N_GRAPH),
                    host_ms=cs.host_ms(torch, fns[0]), max_abs_err=err)


def time_fa(torch, kernel, ref, shape, label, plan=None, exact=True):
    """``kernel``'s flash_attention at ``shape`` over input sets of
    ``FA_COLD_BYTES`` in all, under ``plan`` (a function of the shape;
    None: the wrapper's own); ``exact=False`` reports the error without
    holding it to the tolerance."""
    B, S, H, KV, D, window, cap, dtype = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(S + H + D)
    per_set = (2 * B * S * H * D + 2 * B * S * KV * D) * dt.itemsize
    sets = [tuple(torch.randn((B, S, n, D), generator=g, device="cuda",
                              dtype=dt) for n in (H, KV, KV))
            for _ in range(max(2, -(-int(FA_COLD_BYTES) // per_set)))]
    kw = dict(causal=True, window=window, softcap=cap)
    ctx = TilePlan(kernel, plan) if hasattr(kernel, "tile_plan") else \
        nullcontext()
    with ctx:
        got = kernel.flash_attention(*sets[0], **kw)
        want = ref.mha(*sets[0], **kw)
        if exact:
            err = cs.attn_err(torch, got, want, dtype, f"{label} {shape}")
        else:
            err = (got.float() - want.float()).abs().max().item()
        fns = [lambda a=a: kernel.flash_attention(*a, **kw) for a in sets]
        tiles = (kernel._plan(B, S, H, KV, D)
                 if hasattr(kernel, "_plan") else None)
        return dict(kernel="flash_attention", shape=shape, variant=label,
                    plan=tiles, ms=cs.device_ms(torch, fns, cs.N_GRAPH),
                    max_abs_err=err)


def fa_turn(torch, fk, fa_ref, who, patched):
    """One turn of flash_attention: the parent's kernel, or this
    checkout's steps and other tilings."""
    rows = []
    for shape in FA_TIMED:
        if who != "this":
            rows.append(time_fa(torch, fk, fa_ref, shape, f"{who}: {PARENT}"))
            continue
        for label, switches, plan in FA_STEPS:
            lib = patched.get(("flash_attention", switches))
            with Swap(fk, lib) if switches else nullcontext():
                rows.append(time_fa(torch, fk, fa_ref, shape,
                                    f"this: {label}", plan,
                                    exact="1xTF32" not in switches))
        for tiles in FA_PLANS[shape]:
            rows.append(time_fa(torch, fk, fa_ref, shape,
                                f"this: tiles (gh, nb, ks) = {tiles}",
                                lambda *a, t=tiles: t))
    return rows


def time_fa_bwd(torch, kernel, ref, shape, label):
    """``kernel``'s flash_attention_backward at ``shape``, one input set
    (hot, as ``chip_smoke.py`` phase 16 times it), checked against
    ``ref.mha_backward`` first."""
    B, S, H, KV, D, window, cap, dtype = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(S + H + D)
    q, k, v, dout = (torch.randn((B, S, n, D), generator=g, device="cuda",
                                 dtype=dt) for n in (H, KV, KV, H))
    kw = dict(causal=True, window=window, softcap=cap)
    out, lse = kernel._forward(q, k, v, True, window, cap, True)
    got = kernel.flash_attention_backward(q, k, v, out, dout, lse, **kw)
    want = ref.mha_backward(q, k, v, dout, **kw)
    tol, err = cs.bwd_tol(dtype), 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        cs.check(bool((diff <= tol * (b.abs().max() + b.abs())).all()),
                 f"{label} {shape}: differs by {diff.max().item():.3g}")
        err = max(err, diff.max().item())

    def fn():
        return kernel.flash_attention_backward(q, k, v, out, dout, lse, **kw)
    return dict(kernel="flash_attention_backward", shape=shape,
                variant=label, ms=cs.device_ms(torch, [fn], cs.N_BWD),
                host_ms=cs.host_ms(torch, fn, cs.N_BWD), max_abs_err=err)


def time_cs(torch, kernel, ref, label, misalign=False):
    shape = cs.CS_SERVE
    g = torch.Generator(device="cuda").manual_seed(7)
    sets = []
    for _ in range(6):
        args = cs.scan_inputs(torch, *shape, g)
        if misalign:
            args = (args[0], offset(torch, args[1]), offset(torch, args[2]),
                    args[3], offset(torch, args[4]), offset(torch, args[5]))
        sets.append(args)
    got = kernel.chunk_scan(*sets[0])
    want = ref.chunk_scan(*sets[0])
    err = 0.0
    for gv, wv in zip(got, want):
        diff = (gv - wv).abs()
        cs.check(bool((diff <= cs.SCAN_TOL * (1 + wv.abs())).all()),
                 f"{label}: differs by {diff.max().item():.3g}")
        err = max(err, diff.max().item())
    fns = [lambda a=a: kernel.chunk_scan(*a) for a in sets]
    return dict(kernel="chunk_scan", shape=shape, variant=label,
                ms=cs.device_ms(torch, fns, 24), max_abs_err=err)


# other rows a block than the wrapper's selection plan
DISPATCH_PLANS = [1, 2, 4, 8]
F_MAX = 0.25  # qwen3-moe's published cap


def time_dispatch(torch, km, ref, shape, label, plan=None):
    """``km``'s dispatch kernels at ``shape`` (T, E, k, d), each checked
    against the plain version first: the two row kernels with ``plan``
    rows a block (None: the wrapper's plan), and with the wrapper's plan
    pass 2 and both passes of f_max 0.25, under a skewed load and under
    the serving path's balanced one."""
    T, E, k, d = shape
    kd = k + d
    logits, load = cs.dispatch_inputs(torch, T, E, 7, "random")
    with SelectPlan(km, plan) if plan else nullcontext():
        ids, vals = km.dispatch_candidates(logits, kd)
        want = ref.top_candidates(logits, kd)
        cs.check(torch.equal(ids, want[0])
                 and torch.equal(vals, want[1]),
                 f"{label} {shape}: candidates differ")
        got = km.dispatch_fused(logits, load, k, d)
        want = ref.midas_dispatch(logits, load, k, d, f_max=1.0)
        cs.check(torch.equal(got[0], want[0])
                 and torch.equal(got[2], want[2])
                 and (got[1] - want[1]).abs().max().item() <= cs.W_TOL,
                 f"{label} {shape}: fused dispatch differs")
        fns = {"dispatch_candidates":
               lambda: km.dispatch_candidates(logits, kd),
               "dispatch_fused":
               lambda: km.dispatch_fused(logits, load, k, d)}
        out = [dict(kernel=name, shape=shape, variant=label,
                    ms=cs.device_ms(torch, [fn], cs.N_GRAPH),
                    host_ms=cs.host_ms(torch, fn), max_abs_err=0.0)
               for name, fn in fns.items()]
    if plan is not None:
        return out
    return out + time_steer_pass2(torch, km, ref, shape, label)


def time_steer_pass2(torch, km, ref, shape, label):
    """``km``'s pass 2 at f_max 0.25 (``dispatch_steer``, or the plain
    version where the checkout has none) and both passes, at ``shape``
    under a skewed load and under the serving path's balanced one, each
    checked against the plain version first."""
    T, E, k, d = shape
    kd = k + d
    logits, load = cs.dispatch_inputs(torch, T, E, 7, "random")
    out = []
    cand, vals = km.dispatch_candidates(logits, kd)
    for tag, ld in (("skewed load", load),
                    ("balanced load", torch.ones_like(load))):
        if hasattr(km, "dispatch_steer"):
            def steer(c=cand, v=vals, ld=ld):
                return km.dispatch_steer(c, v, ld, k, f_max=F_MAX)
        else:  # the parent tree's pass 2: PyTorch ops
            def steer(c=cand, v=vals, ld=ld):
                return ref.steer_from_candidates(c, v, ld, k, f_max=F_MAX)
        got = steer()
        want = ref.steer_from_candidates(cand, vals, ld, k, f_max=F_MAX)
        err = (got[1] - want[1]).abs().max().item()
        cs.check(torch.equal(got[0], want[0])
                 and torch.equal(got[2], want[2]) and err <= cs.W_TOL,
                 f"{label} {shape} {tag}: pass 2 differs")
        for name, fn in (
                (f"pass 2 at f_max {F_MAX}, {tag}", steer),
                (f"both passes at f_max {F_MAX}, {tag}",
                 lambda steer=steer: steer(*km.dispatch_candidates(logits,
                                                                   kd)))):
            out.append(dict(kernel=name, shape=shape, variant=label,
                            ms=cs.device_ms(torch, [fn], cs.N_GRAPH),
                            host_ms=cs.host_ms(torch, fn), max_abs_err=err))
    return out


# dispatch_steer's select at these tokens (the crossover's tokens
# between 256 and 512)
STEER_SELECT_T = (32, 128, 256, 320, 384, 448, 512, 1024, 4096)
EVERY = 1 << 30  # count_max: count ranks at any T


def steer_hot(torch, T, E, k, seed):
    """Gate logits that rank experts 0, 1, ... about alike for every
    token, within the gate slack, and a load hot on the first k: most
    tokens' benefits clear the floor, so the quantile's select runs in
    most slots (``tests/test_torch_kernels_cuda.py``'s "hot")."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    e = torch.arange(E, device="cuda")
    logits = -0.05 * e[None, :] + 0.02 * torch.randn(
        (T, E), generator=g, device="cuda")
    load = torch.where(
        e < k, 6.0 + torch.randn(E, generator=g, device="cuda").abs(),
        torch.randn(E, generator=g, device="cuda").abs() * 3.0)
    return logits.contiguous(), load


def time_steer_select(torch, km, ref, T, label, plan=None):
    """``km``'s dispatch_steer at f_max 0.25 on ``steer_hot`` inputs of
    T tokens (E 128, top-8, d 2) under ``plan`` (None: the wrapper's),
    checked against the plain version first."""
    E, k, d = 128, 8, 2
    logits, load = steer_hot(torch, T, E, k, T)
    cand, vals = km.dispatch_candidates(logits, k + d)
    with SteerPlan(km, plan) if plan else nullcontext():
        got = km.dispatch_steer(cand, vals, load, k, f_max=F_MAX)
        want = ref.steer_from_candidates(cand, vals, load, k, f_max=F_MAX)
        err = (got[1] - want[1]).abs().max().item()
        cs.check(torch.equal(got[0], want[0])
                 and torch.equal(got[2], want[2]) and err <= cs.W_TOL,
                 f"{label} T={T}: dispatch_steer differs")

        def fn():
            return km.dispatch_steer(cand, vals, load, k, f_max=F_MAX)
        return dict(kernel=f"dispatch_steer select, f_max {F_MAX}, most "
                    f"benefits over the floor", shape=(T, E, k, d),
                    variant=label, ms=cs.device_ms(torch, [fn], cs.N_GRAPH),
                    host_ms=cs.host_ms(torch, fn), max_abs_err=err,
                    steered=int(got[2].sum()))


def steer_select_turn(torch, km, ref, who):
    """One turn of ``dispatch_steer``'s select paths: the other
    checkout's kernel as it plans, or this one's by each path."""
    rows = []
    for T in STEER_SELECT_T:
        if who != "this" or not hasattr(km, "steer_plan"):
            rows.append(time_steer_select(torch, km, ref, T,
                                          f"{who}: {PARENT}"))
            continue
        if km.steer_path(T) != "registers":
            rows.append(time_steer_select(
                torch, km, ref, T, "this: shared-memory kernel, radix "
                "select"))
            continue
        plans = {"counting ranks": (False, EVERY),
                 "radix select": (False, 0)}
        if T <= 32:
            plans["shuffles in one warp"] = (True, EVERY)
        plans["the wrapper's plan"] = None
        for label, plan in plans.items():
            rows.append(time_steer_select(torch, km, ref, T,
                                          f"this: {label}", plan))
    return rows


def dispatch_turn(torch, km, ref, who):
    rows = []
    for shape in cs.MR_TIMED:
        T, E = shape[:2]
        if who != "this":
            rows += time_dispatch(torch, km, ref, shape, f"{who}: {PARENT}")
            continue
        rows += time_dispatch(torch, km, ref, shape,
                              f"this: plan, {km.select_plan(T, E)} rows a "
                              f"block")
        for plan in DISPATCH_PLANS:
            if plan == km.select_plan(T, E) or plan > T:
                continue
            rows += time_dispatch(torch, km, ref, shape,
                                  f"this: {plan} rows a block", plan)
    return rows + steer_select_turn(torch, km, ref, who)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose kernels to time in turns")
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=KERNELS,
                    help="the kernels to time (default: all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_steps: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.midas_route import kernel as mr
    from repro_torch.kernels.midas_route import ref as mr_ref
    from repro_torch.kernels.ssm_scan import kernel as sc
    from repro_torch.kernels.ssm_scan import ref as sc_ref

    card = cs.card_line()
    print(card, flush=True)
    subs = {"flash_attention": "flash_attention",
            "flash_attention_backward": "flash_attention",
            "decode_attention": "decode_attention", "chunk_scan": "ssm_scan",
            "dispatch": "midas_route"}
    mods = {"this": {"flash_attention": fa, "flash_attention_backward": fa,
                     "decode_attention": da, "chunk_scan": sc,
                     "dispatch": mr}}
    if args.parent is not None:
        mods["parent"] = {name: load_parent(args.parent, subs[name])
                          for name in args.only}

    def source(mod, name):
        if name == "dispatch":
            return mod.DISPATCH_SOURCE
        if name == "flash_attention_backward":
            return mod.BWD_SOURCE
        return mod.SOURCE

    def loader(mod, name):
        if name == "dispatch":
            return mod._dispatch_lib
        if name == "flash_attention_backward":
            return mod._bwd_lib
        return mod._lib

    specs = {(who, name): (source(mods[who][name], name),
                           mods[who][name].FLAGS)
             for who in mods for name in args.only}
    built = _build.build_all(list(specs.values()))
    for (who, name), (source, flags) in specs.items():
        print(f"ptxas {who} {name}: {ptxas_summary(built[str(source)][1])}")
        print(f"sass {who} {name}: {sass_counts(source, flags)}")
        if name == "flash_attention_backward":
            mma, atomics, floats = cs.sass_ops(source, flags)
            print(f"sass {who} {name}: {mma} tensor-core instructions, "
                  f"{atomics} RED/ATOM ({floats} of a float type)")
    order = (["parent", "this", "this", "parent"] if "parent" in mods
             else ["this", "this"])
    rows = []
    for name in args.only:  # built above; the copies in parallel
        loader(mods["this"][name], name)()
    patch_mods = {"decode_attention": da, "chunk_scan": sc, "dispatch": mr}
    jobs = {key: (da if key[0] == "decode_attention" else sc, [edit])
            for key, edit in PATCHES.items() if key[0] in args.only}
    if "flash_attention" in args.only:
        for _, switches, _ in FA_STEPS:
            if switches:
                jobs["flash_attention", switches] = (
                    fa, [FA_SWITCHES[x] for x in switches])
    with ThreadPoolExecutor(max(1, len(jobs))) as pool:
        futures = {key: pool.submit(build_patched, mod, edits, f"v{i}")
                   for i, (key, (mod, edits)) in enumerate(jobs.items())}
        patched = {key: f.result() for key, f in futures.items()}
    for turn, who in enumerate(order):
        if "flash_attention" in args.only:
            rows += [dict(r, turn=turn) for r in fa_turn(
                torch, mods[who]["flash_attention"], fa_ref, who, patched)]
        if "decode_attention" not in args.only:
            continue
        for shape in DA_TIMED:
            dk = mods[who]["decode_attention"]
            variants = (da_variants(dk, shape) if who == "this"
                        else {PARENT: {}})
            for label, kw in variants.items():
                try:
                    row = time_da(torch, dk, da_ref, shape,
                                  f"{who}: {label}", **kw)
                except ValueError as e:  # a shape the kernel refuses
                    print(f"[turn {turn}] decode_attention {shape} {who}: "
                          f"{label}: refused: {e}", flush=True)
                    continue
                rows.append(dict(row, turn=turn))
            if who == "this" and shape != DA_LONG:
                for (kern, label), lib in patched.items():
                    if kern == "decode_attention":
                        with Swap(da, lib):
                            rows.append(dict(time_da(
                                torch, da, da_ref, shape,
                                f"this, patched: {label}"), turn=turn))
    for turn, who in enumerate(order):
        if "flash_attention_backward" not in args.only:
            continue
        label = f"{who}: " + ("this checkout's kernel" if who == "this"
                              else PARENT)
        for shape in FA_BWD_TIMED:
            rows.append(dict(time_fa_bwd(
                torch, mods[who]["flash_attention_backward"], fa_ref, shape,
                label), turn=turn))
    for turn, who in enumerate(order):
        if "dispatch" in args.only:
            rows += [dict(r, turn=turn) for r in dispatch_turn(
                torch, mods[who]["dispatch"], mr_ref, who)]
    for turn, who in enumerate(order):
        if "chunk_scan" not in args.only:
            continue
        sk = mods[who]["chunk_scan"]
        cs_variants = ({"16-byte cp.async": {},
                        "4-byte copies": dict(misalign=True)}
                       if who == "this" else {PARENT: {}})
        for label, kw in cs_variants.items():
            rows.append(dict(time_cs(torch, sk, sc_ref, f"{who}: {label}",
                                     **kw), turn=turn))
        if who == "this":
            for (kern, label), lib in patched.items():
                if kern == "chunk_scan":
                    with Swap(sc, lib):
                        rows.append(dict(time_cs(
                            torch, sc, sc_ref, f"this, patched: {label}"),
                            turn=turn))
    for r in rows:
        host = (f", called from Python {r['host_ms'] * 1e3:.2f} us"
                if "host_ms" in r else "")
        tiles = f" [tiles {r['plan']}]" if r.get("plan") else ""
        print(f"[turn {r['turn']}] {r['kernel']} {r['shape']} {r['variant']}"
              f"{tiles}: {r['ms'] * 1e3:.3f} us{host} (max |diff| "
              f"{r['max_abs_err']:.3g})", flush=True)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "kernel_steps.json").write_text(json.dumps(
        {"card": card, "rows": rows}, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
