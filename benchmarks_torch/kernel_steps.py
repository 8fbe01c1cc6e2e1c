#!/usr/bin/env python3
"""Time the design steps of ``decode_attention`` and ``chunk_scan`` on
the card, cold, at the serving shapes.

    python3 benchmarks_torch/kernel_steps.py [--parent DIR]

Each variant is first checked against the plain version, then timed as
``chip_smoke.py`` phase 2 times a kernel: calls over input sets that
exceed the 50 MB L2, captured in one CUDA graph and replayed; and, for
``decode_attention``, one call at a time from Python (``host_ms``).
Variants:

- ``decode_attention`` at SmolLM-360M's and Qwen3-MoE's decode shapes:
  the split plan's span, other spans (a grid of 2 x 132 blocks, and
  fewer, longer spans; the wrapper's ``split_plan`` replaced for the
  run, ``Plan``), and the plan with 4-byte loads (inputs offset by one
  element, so the 16-byte path is not taken); and the plan alone at a
  65536-row cache of Qwen3-MoE's widths;
- ``chunk_scan`` at falcon-mamba-7b's serving chunk: 16-byte ``cp.async``
  copies, and 4-byte ones (inputs offset by one element).

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
import ctypes
import importlib.util
import json
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


def build_patched(module, old, new, tag):
    """``module``'s library built from its source with ``old`` replaced
    by ``new``, with the argument types its wrapper declares."""
    from repro_torch.kernels import _build

    text = module.SOURCE.read_text()
    if old not in text:
        raise SystemExit(f"{module.SOURCE.name}: patch text not found")
    src = ROOT / "build" / f"{module.SOURCE.stem}_{tag}.cu"
    src.parent.mkdir(exist_ok=True)
    src.write_text(text.replace(old, new))
    lib = src.with_suffix(".so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *module.FLAGS, "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    patched = ctypes.CDLL(str(lib))
    name = ("decode_attention_launch" if "decode" in module.SOURCE.stem
            else "chunk_scan_launch")
    fn, ref_fn = getattr(patched, name), getattr(module._lib(), name)
    fn.argtypes, fn.restype = ref_fn.argtypes, ref_fn.restype
    return patched


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose kernels to time in turns")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_steps: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.ssm_scan import kernel as sc
    from repro_torch.kernels.ssm_scan import ref as sc_ref

    card = cs.card_line()
    print(card, flush=True)
    mods = {"this": (da, sc)}
    if args.parent is not None:
        mods["parent"] = (load_parent(args.parent, "decode_attention"),
                          load_parent(args.parent, "ssm_scan"))
    specs = {(who, m.SOURCE.stem): (m.SOURCE, m.FLAGS)
             for who, pair in mods.items() for m in pair}
    built = _build.build_all(list(specs.values()))
    for (who, name), (source, _) in specs.items():
        print(f"ptxas {who} {name}: {ptxas_summary(built[str(source)][1])}")
    order = (["parent", "this", "this", "parent"] if "parent" in mods
             else ["this", "this"])
    rows = []
    da._lib(), sc._lib()  # built above; the patched copies in parallel
    with ThreadPoolExecutor(len(PATCHES)) as pool:
        futures = {key: pool.submit(
            build_patched, da if key[0] == "decode_attention" else sc,
            old, new, f"v{i}")
            for i, (key, (old, new)) in enumerate(PATCHES.items())}
        patched = {key: f.result() for key, f in futures.items()}
    for turn, who in enumerate(order):
        dk, sk = mods[who]
        for shape in DA_TIMED:
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
        print(f"[turn {r['turn']}] {r['kernel']} {r['shape']} {r['variant']}:"
              f" {r['ms'] * 1e3:.3f} us{host} (max |diff| "
              f"{r['max_abs_err']:.3g})", flush=True)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "kernel_steps.json").write_text(json.dumps(
        {"card": card, "rows": rows}, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
