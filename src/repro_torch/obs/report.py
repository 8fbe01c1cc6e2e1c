"""``repro-report`` -- read an artifact + trace pair back as numbers.

The counterpart of ``repro/obs/report.py``, with the same output, the
same checks and the same exit codes:

    PYTHONPATH=src python -m repro_torch.obs.report build/phase/run.json
    PYTHONPATH=src python -m repro_torch.obs.report --check build/phase

Given a benchmark artifact (any JSON a runner writes) and its paired
JSONL trace (``<stem>.trace.jsonl``, found automatically next to the
artifact or named via ``--trace``), prints:

* the artifact's environment meta (torch version -- or the reference's
  jax version -- device kind, wall-clock start/end);
* the per-phase time breakdown aggregated from the trace spans
  (warmup / execute / host / bench categories);
* compile-vs-execute ratios (first-call vs steady bench spans, and
  ``compiled=True`` execute spans vs warm ones);
* every cell's windowed-vs-raw delta (the ``window`` blocks that
  ``repro_torch.obs.windows`` records).

``--check`` validates instead of printing: every trace parses and
passes the event schema (a torn FINAL line -- a run cut by a time limit
-- is tolerated, any other malformation fails), every artifact is valid
JSON, and every ``window`` block satisfies ``0 <= begin <= end <= T``.
Directories are scanned recursively (``*.json`` artifacts,
``*.trace.jsonl`` traces; ``*.trace.json`` files are Chrome exports and
only syntax-checked).  Exit code 0 = clean, 1 = problems found.  The
port's traces and the reference's share one format, so either package's
report reads either's files.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Tuple

from repro_torch.obs import trace as trace_lib


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------


def phase_table(events: List[dict]) -> List[Tuple[str, int, float]]:
    """(category, span count, total seconds) rows, longest first, over
    the complete (``ph="X"``) spans of one trace."""
    totals: dict = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "?")
        n, dur = totals.get(cat, (0, 0.0))
        totals[cat] = (n + 1, dur + float(ev.get("dur", 0.0)) / 1e6)
    return sorted(
        [(c, n, d) for c, (n, d) in totals.items()],
        key=lambda r: -r[2],
    )


def compile_vs_execute(events: List[dict]) -> Optional[dict]:
    """First-call vs steady split from the harness's bench spans plus
    the engine's ``compiled`` span tag; None when the trace has no
    execute spans at all."""
    first = steady = 0.0
    compiled = warm = 0.0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        dur_s = float(ev.get("dur", 0.0)) / 1e6
        if ev.get("name") == "bench/first_call":
            first += dur_s
        elif ev.get("name") == "bench/steady":
            steady += dur_s
        if ev.get("cat") == "execute":
            if args.get("compiled"):
                compiled += dur_s
            else:
                warm += dur_s
    if first == steady == compiled == warm == 0.0:
        return None
    out = {
        "first_call_s": round(first, 3),
        "steady_s": round(steady, 3),
        "compiling_execute_s": round(compiled, 3),
        "warm_execute_s": round(warm, 3),
    }
    if steady > 0:
        out["first_over_steady"] = round(first / steady, 2)
        out["compile_overhead_s"] = round(max(first - steady, 0.0), 3)
    return out


def window_rows(doc, path: str = "") -> List[Tuple[str, dict, dict]]:
    """Every ``window`` block in an artifact: (json-path, window,
    sibling stats) triples, found by recursive walk."""
    rows = []
    if isinstance(doc, dict):
        if isinstance(doc.get("window"), dict):
            sibs = {k: doc[k] for k in ("stable", "window_shift") if k in doc}
            rows.append((path or ".", doc["window"], sibs))
        for k, v in doc.items():
            if k != "window":
                rows.extend(window_rows(v, f"{path}.{k}" if path else k))
    elif isinstance(doc, list):
        for i, v in enumerate(doc):
            rows.extend(window_rows(v, f"{path}[{i}]"))
    return rows


def find_trace(artifact: Path) -> Optional[Path]:
    """The artifact's paired JSONL trace (``<stem>.trace.jsonl``, the
    runners' naming contract)."""
    cand = artifact.with_suffix(".trace.jsonl")
    return cand if cand.exists() else None


# ---------------------------------------------------------------------------
# Printing
# ---------------------------------------------------------------------------


def print_report(artifact: Path, trace: Optional[Path]) -> None:
    doc = json.loads(artifact.read_text())
    meta = doc.get("meta", {}) if isinstance(doc, dict) else {}
    print(f"artifact: {artifact}")
    if meta:
        env = ", ".join(
            str(meta[k])
            for k in ("torch_version", "jax_version", "device_kind")
            if k in meta
        )
        wall = " -> ".join(
            str(meta[k]) for k in ("started_at", "written_at") if k in meta
        )
        if env:
            print(f"  env:  {env}")
        if wall:
            print(f"  wall: {wall}")
    if trace is not None:
        events = trace_lib.read_trace(trace)
        spans = phase_table(events)
        total = sum(d for _, _, d in spans) or 1.0
        print(f"  trace: {trace.name} ({len(events)} events)")
        print("  phases:")
        for cat, n, dur in spans:
            print(
                f"    {cat:<10s} {n:>4d} spans  {dur:>9.3f} s  "
                f"{100.0 * dur / total:5.1f}%"
            )
        cve = compile_vs_execute(events)
        if cve:
            line = (
                f"    first-call {cve['first_call_s']}s vs steady "
                f"{cve['steady_s']}s"
            )
            if "first_over_steady" in cve:
                line += (
                    f"  ({cve['first_over_steady']}x, compile overhead "
                    f"~{cve['compile_overhead_s']}s)"
                )
            print("  compile vs execute:")
            print(line)
    rows = window_rows(doc)
    if rows:
        print("  windows (stable-only vs whole-run):")
        for path, win, sibs in rows:
            shift = (sibs.get("window_shift") or {}).get("mean_queue")
            stable = (sibs.get("stable") or {}).get("mean_queue")
            extra = ""
            if stable is not None:
                extra += f"  stable_mean_q={stable}"
            if shift is not None:
                extra += f"  shift={100.0 * shift:+.1f}%"
            print(
                f"    {path:<44s} [{win.get('begin')}, "
                f"{win.get('end')})/{win.get('T')} "
                f"{win.get('method')}{extra}"
            )
    else:
        print("  windows: none recorded")


# ---------------------------------------------------------------------------
# --check
# ---------------------------------------------------------------------------


def check_window(win: dict, where: str) -> List[str]:
    problems = []
    try:
        b, e, t = (
            int(win["begin"]),
            int(win["end"]),
            int(win["T"]),
        )
    except (KeyError, TypeError, ValueError) as exc:
        return [f"{where}: malformed window block ({exc!r})"]
    if not 0 <= b <= e <= t:
        problems.append(
            f"{where}: window invariant violated "
            f"(begin={b} end={e} T={t})"
        )
    if win.get("method") not in ("ewma_plateau", "censored"):
        problems.append(
            f"{where}: unknown window method {win.get('method')!r}"
        )
    return problems


def check_paths(paths: List[Path]) -> List[str]:
    """Validate traces + artifacts; returns problem strings (empty =
    clean).  Missing traces are fine (a runner may not have started);
    malformed ones are not."""
    problems: List[str] = []
    jsonl, chrome, artifacts = [], [], []
    for p in paths:
        if p.is_dir():
            jsonl += sorted(p.rglob("*.trace.jsonl"))
            chrome += sorted(p.rglob("*.trace.json"))
            artifacts += sorted(
                f
                for f in p.rglob("*.json")
                if not f.name.endswith(".trace.json")
            )
        elif p.name.endswith(".trace.jsonl"):
            jsonl.append(p)
        elif p.name.endswith(".trace.json"):
            chrome.append(p)
        else:
            artifacts.append(p)
    for t in jsonl:
        try:
            events = trace_lib.read_trace(t)
        except ValueError as exc:
            problems.append(str(exc))
            continue
        problems += [
            f"{t}: {msg}" for msg in trace_lib.validate_events(events)
        ]
    for c in chrome:
        try:
            doc = json.loads(c.read_text())
            if "traceEvents" not in doc:
                problems.append(f"{c}: no traceEvents key")
        except (json.JSONDecodeError, OSError) as exc:
            problems.append(f"{c}: unreadable ({exc})")
    for a in artifacts:
        try:
            doc = json.loads(a.read_text())
        except (json.JSONDecodeError, OSError) as exc:
            problems.append(f"{a}: unreadable ({exc})")
            continue
        for where, win, _ in window_rows(doc):
            problems += check_window(win, f"{a}:{where}")
    return problems


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument(
        "paths",
        nargs="+",
        type=Path,
        help="artifact JSON files and/or directories to scan",
    )
    ap.add_argument(
        "--trace",
        type=Path,
        default=None,
        help="explicit JSONL trace (default: <artifact>.trace.jsonl)",
    )
    ap.add_argument(
        "--check",
        action="store_true",
        help="validate traces + window blocks instead of printing; "
        "exit 1 on any malformation",
    )
    args = ap.parse_args(argv)
    for p in args.paths:
        if not p.exists():
            print(f"error: {p} does not exist", file=sys.stderr)
            return 1
    if args.check:
        problems = check_paths(list(args.paths))
        for msg in problems:
            print(f"CHECK FAIL: {msg}", file=sys.stderr)
        print(
            f"repro-report --check: "
            f"{'FAIL' if problems else 'ok'} "
            f"({len(problems)} problem(s))"
        )
        return 1 if problems else 0
    artifacts: List[Path] = []
    for p in args.paths:
        if p.is_dir():
            artifacts += sorted(
                f
                for f in p.rglob("*.json")
                if not f.name.endswith(".trace.json")
            )
        else:
            artifacts.append(p)
    for i, a in enumerate(artifacts):
        if i:
            print()
        print_report(a, args.trace or find_trace(a))
    return 0


if __name__ == "__main__":
    sys.exit(main())
