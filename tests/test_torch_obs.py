"""The port's observability plane against the reference's.

``repro_torch.obs.trace`` must record the events the reference's
recorder records on the same calls (timestamps, process and thread ids
aside), write the same JSONL and Chrome documents, read and validate
traces alike, and read no environment variable.  The engine's spans
(``simulate``'s and ``run_sweep``'s) carry the reference's names,
categories and arguments in the reference's order.
``repro_torch.obs.windows`` must give the reference's windows, stable
statistics and cell blocks on the same series and on rows of both
metrics modes.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import SweepSpec as JSpec  # noqa: E402
from repro.core import make_workload as jmake  # noqa: E402
from repro.core import run_sweep as jrun_sweep  # noqa: E402
from repro.core import simulate as jsimulate  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.obs import windows as jwindows  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import SimConfig, SweepSpec, run_sweep  # noqa: E402
from repro_torch.core import make_workload, simulate  # noqa: E402
from repro_torch.obs import trace, windows  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# what differs between two runs of the same calls
VOLATILE = ("ts", "dur", "pid", "tid")


def _stable(ev):
    ev = {k: v for k, v in ev.items() if k not in VOLATILE}
    args = dict(ev.get("args", {}))
    args.pop("epoch_unix", None)
    args.pop("compiled", None)  # the reference's jit tag; the port has none
    return dict(ev, args=args)


def _drive(rec, path):
    """The same calls on either package's recorder."""
    rec.configure(path=path, fresh=True)
    with rec.span("sweep/execute", cat="execute", policy="midas",
                  seeds=2) as sp:
        sp["late"] = [1, 2]
    rec.instant("flip", cat="mark", tick=130)
    with pytest.raises(ValueError):
        with rec.span("sim/run", T=4):
            raise ValueError("boom")
    with rec.span("nested"):
        with rec.span("inner", cat="host"):
            pass
    rec.configure(enabled=False)
    with rec.span("dropped"):
        pass
    rec.instant("dropped")
    rec.configure(enabled=True)
    return rec.write_chrome(Path(path).with_suffix(".chrome.json"))


def test_recorder_matches_reference(tmp_path):
    ours = trace.Recorder(enabled=True)
    ref = jtrace.Recorder(enabled=True)
    ref.profile = False
    c1 = _drive(ours, tmp_path / "port.jsonl")
    c2 = _drive(ref, tmp_path / "ref.jsonl")
    assert [_stable(e) for e in ours.events] == \
        [_stable(e) for e in ref.events]
    for a, b in ((trace.read_trace(tmp_path / "port.jsonl"),
                  jtrace.read_trace(tmp_path / "ref.jsonl")),
                 (json.loads(c1.read_text())["traceEvents"],
                  json.loads(c2.read_text())["traceEvents"])):
        assert [_stable(e) for e in a] == [_stable(e) for e in b]
    doc = json.loads(c1.read_text())
    assert doc.keys() == json.loads(c2.read_text()).keys()
    assert trace.validate_events(ours.events) == []
    names = [e["name"] for e in ours.events]
    assert "dropped" not in names and names.count("recorder") == 2
    span = next(e for e in ours.events if e["name"] == "sweep/execute")
    assert span["dur"] >= 0 and span["args"]["late"] == [1, 2]
    assert next(e for e in ours.events if e["name"] == "sim/run"
                )["args"]["error"] == "ValueError"


def test_read_trace_and_validate_match_reference(tmp_path):
    good = [{"name": "a", "cat": "c", "ph": "X", "ts": 1.0, "dur": 2.0,
             "pid": 1, "tid": 1}]
    lines = [json.dumps(e) for e in good]
    torn = tmp_path / "torn.jsonl"
    torn.write_text("\n".join(lines + ['{"name": "b", "ca']))
    assert trace.read_trace(torn) == jtrace.read_trace(torn) == good
    bad = tmp_path / "bad.jsonl"
    bad.write_text("\n".join(['{"x', ""] + lines))
    with pytest.raises(ValueError) as got:
        trace.read_trace(bad)
    with pytest.raises(ValueError) as want:
        jtrace.read_trace(bad)
    assert str(got.value) == str(want.value)
    events = good + [
        "not a dict",
        {"name": "a"},
        {"name": "a", "cat": "c", "ph": "Q", "ts": 0, "pid": 1, "tid": 1},
        {"name": "a", "cat": "c", "ph": "i", "ts": -1, "pid": 1, "tid": 1},
        {"name": "a", "cat": "c", "ph": "X", "ts": 0, "pid": 1, "tid": 1},
        {"name": "a", "cat": "c", "ph": "X", "ts": 0, "dur": -3, "pid": 1,
         "tid": 1},
    ]
    got = trace.validate_events(events)
    assert got == jtrace.validate_events(events) and len(got) == 6


def test_recorder_reads_no_environment(monkeypatch):
    """``REPRO_OBS=0`` and ``REPRO_OBS_PROFILE=1`` switch the
    reference's recorder; the port's takes both only as arguments, and
    its sweep and observability sources never touch the environment."""
    monkeypatch.setenv("REPRO_OBS", "0")
    monkeypatch.setenv("REPRO_OBS_PROFILE", "1")
    assert not jtrace.Recorder().enabled
    rec = trace.Recorder()
    assert rec.enabled and not rec.profile
    assert not trace.Recorder(enabled=False).enabled
    for path in [ROOT / "src/repro_torch/core/sweep.py",
                 *sorted((ROOT / "src/repro_torch/obs").glob("*.py"))]:
        tree = ast.parse(path.read_text())
        names = {n.attr for n in ast.walk(tree)
                 if isinstance(n, ast.Attribute)}
        names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        assert not names & {"environ", "getenv", "putenv"}, path


def test_profile_spans_open_profiler_ranges():
    rec = trace.Recorder(profile=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("sweep/execute", cat="execute"):
            torch.ones(4).sum()
    assert "sweep/execute" in {e.name for e in prof.events()}
    assert rec.events[-1]["name"] == "sweep/execute"


# ---------------------------------------------------------------------------
# The engine's spans
# ---------------------------------------------------------------------------


def _spans(events):
    return [_stable(e) for e in events if e["ph"] == "X"]


def test_engine_spans_match_reference():
    """``simulate`` (with its warmup) and a 1-policy × 2-controller ×
    2-seed sweep record the reference's spans, in its order."""
    wl = jmake("bursty", T=10, m=4, seed=0, N=64)
    pwl = convert.workload_from_numpy(
        np.asarray(wl.keys), np.asarray(wl.mask), np.asarray(wl.is_write),
        wl.N, device="cpu", name=wl.name)
    kw = dict(controllers=("hysteresis", "static"), seeds=(0, 1),
              metrics="summary", do_warmup=False)
    got, want = [], []
    trace.RECORDER.configure(enabled=True, fresh=True)
    simulate(SimConfig(m=4, N=64), pwl, device="cpu")
    got.append(_spans(trace.RECORDER.events))
    trace.RECORDER.configure(fresh=True)
    run_sweep(SweepSpec(config=SimConfig(m=4, N=64), workloads=pwl, **kw),
              device="cpu")
    got.append(_spans(trace.RECORDER.events))
    jtrace.RECORDER.configure(enabled=True, fresh=True)
    jsimulate(JConfig(m=4, N=64), wl)
    want.append(_spans(jtrace.RECORDER.events))
    jtrace.RECORDER.configure(fresh=True)
    jrun_sweep(JSpec(config=JConfig(m=4, N=64), workloads=wl, **kw))
    want.append(_spans(jtrace.RECORDER.events))
    assert [e["name"] for e in got[0]] == \
        ["sim/warmup", "sim/run", "sim/host_result"]
    assert [e["name"] for e in got[1]].count("sweep/warmup") == 1
    assert got == want


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------


def _series():
    rng = np.random.default_rng(3)
    t = np.arange(400, dtype=np.float64)
    plateau = 40.0 * (1 - np.exp(-t / 30.0)) + rng.normal(0, 0.5, t.size)
    cool = plateau.copy()
    cool[360:] = np.linspace(40, 0, 40)
    late = np.concatenate([np.linspace(0, 50, 300), np.full(100, 50.0)])
    bad = plateau.copy()
    bad[17] = np.nan
    return {
        "plateau": plateau, "cooldown": cool, "late": late,
        "constant": np.full(100, 3.0), "zeros": np.zeros(64),
        "short": plateau[:15], "nan": bad,
        "noise": rng.normal(10, 4, 300),
        "float32": plateau.astype(np.float32),
    }


@pytest.mark.parametrize("name", list(_series()))
def test_windows_match_reference(name):
    x = _series()[name]
    for kw in ({}, dict(hold=4, slope_tol=0.05), dict(max_warmup_frac=0.2)):
        got, want = windows.detect(x, **kw), jwindows.detect(x, **kw)
        assert (got.begin, got.end, got.T, got.method) == \
            (want.begin, want.end, want.T, want.method)
        assert got.to_json(50.0) == want.to_json(50.0)
        assert got.censored == want.censored
        assert got.n_stable == want.n_stable
        # NaN where the series is not finite: equal as NaN
        np.testing.assert_equal(windows.windowed_stats(x, got),
                                jwindows.windowed_stats(x, want))
    with pytest.raises(ValueError) as g:
        windows.Window(begin=5, end=3, T=9, method="x")
    with pytest.raises(ValueError) as w:
        jwindows.Window(begin=5, end=3, T=9, method="x")
    assert str(g.value) == str(w.value)


def test_cell_blocks_of_both_metrics_modes_match_reference():
    """``q_mean_series`` and ``cell_block`` on the port's rows of both
    metrics modes (rows that equal the reference's bit for bit,
    ``tests/test_torch_sweep.py``) equal the reference's functions on
    the same rows."""
    wl = make_workload("bursty", T=80, m=8, N=512, device="cpu")
    kw = dict(seeds=(0, 1), do_warmup=False)
    cfg = SimConfig(m=8, N=512, middleware=("cache",))
    rows = {mode: run_sweep(SweepSpec(config=cfg, workloads=wl,
                                      metrics=mode, **kw),
                            device="cpu").rows()
            for mode in ("full", "summary")}
    for mode, got in rows.items():
        for r in got:
            np.testing.assert_array_equal(windows.q_mean_series(r),
                                          jwindows.q_mean_series(r))
        for dk in ({}, dict(hold=4)):
            assert windows.cell_block(got, dt_ms=50.0, **dk) == \
                jwindows.cell_block(got, dt_ms=50.0, **dk)
    # the summary rows carry the mean the full rows reduce to, in float32
    for a, b in zip(rows["full"], rows["summary"]):
        np.testing.assert_allclose(windows.q_mean_series(a),
                                   windows.q_mean_series(b), rtol=1e-6)
    with pytest.raises(ValueError) as g:
        windows.q_mean_series(object())
    with pytest.raises(ValueError) as w:
        jwindows.q_mean_series(object())
    assert str(g.value) == str(w.value)
