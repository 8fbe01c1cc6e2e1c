"""The port's routing shim, theory module and report CLI against the JAX
reference on the CPU.

``repro_torch.core.routing`` exports the reference's names, and
``route_hash`` gives its assignments bit for bit.  ``theory``'s
balls-into-bins loads are bitwise the reference's for the same seed (its
threefry draws, a first-index argmin), and so are the mean and std of
the gaps; the reference's own claims (``tests/test_core_theory.py``)
hold for the port.  ``python -m repro_torch.obs.report`` prints what
``python -m repro.obs.report`` prints (its env line shows the torch
version where the reference's shows the jax version), and ``--check``
exits as it does, on traces either package wrote, on clean and on bad
windows.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import hashring as jhashring  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.core import hashring, prng, routing, theory  # noqa: E402
from repro_torch.obs import report, trace  # noqa: E402


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_")
            and n != "annotations"}


def test_routing_exports_the_reference_names():
    assert _public(routing) == _public(jrouting)


def test_route_hash_is_bitwise():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 10**6, 500).astype(np.int32)
    mask = rng.random(500) < 0.8
    for m in (4, 8, 64):
        want = jrouting.route_hash(jhashring.make_ring(m, 64),
                                   jnp.asarray(keys), jnp.asarray(mask))
        got = routing.route_hash(hashring.make_ring(m, 64, device="cpu"),
                                 torch.as_tensor(keys).long(),
                                 torch.as_tensor(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,d", [(16, 1), (16, 2), (64, 2)])
def test_balls_into_bins_is_bitwise(m, d):
    trials = 30
    keys = jax.random.split(jax.random.PRNGKey(0), trials)
    want = jax.vmap(lambda k: jtheory.balls_into_bins(k, m, m, d))(keys)
    got = theory.balls_into_bins(
        prng.split(prng.PRNGKey(0, "cpu"), trials), m, m, d)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert theory.maxload_gap_empirical(
        m, m, d, trials=trials, device="cpu") == \
        jtheory.maxload_gap_empirical(m, m, d, trials=trials)


def test_closed_forms_and_the_reference_claims():
    for f, args in ((theory.uniform_maxload_gap_theory, (64,)),
                    (theory.power_of_d_maxload_gap_theory, (64, 2)),
                    (theory.mm1_latency, (5.0, 10.0)),
                    (theory.mm1_latency, (10.0, 10.0))):
        assert f(*args) == getattr(jtheory, f.__name__)(*args)
    m = 64
    gap = {d: theory.maxload_gap_empirical(m, m, d, trials=30,
                                           device="cpu")[0] for d in (1, 2)}
    assert gap[2] < gap[1]
    assert gap[1] > theory.power_of_d_maxload_gap_theory(m, 2)
    gaps = [theory.maxload_gap_empirical(m, m, d, trials=20,
                                         device="cpu")[0]
            for d in (1, 2, 4)]
    assert gaps[0] > gaps[1] >= gaps[2]
    g256, _ = theory.maxload_gap_empirical(256, 256, 1, trials=30,
                                           device="cpu")
    pred = theory.uniform_maxload_gap_theory(256)
    assert 0.5 * pred < g256 < 2.5 * pred


def _artifact(path, window):
    doc = {"meta": {"torch_version": "2.x", "device_kind": "cpu",
                    "started_at": "2026-01-01T00:00:00",
                    "written_at": "2026-01-01T00:01:00"},
           "cells": [{"name": "a", "window": window,
                      "stable": {"mean_queue": 1.25},
                      "window_shift": {"mean_queue": -0.05}},
                     {"name": "b", "window": dict(window, begin=0)}]}
    path.write_text(json.dumps(doc))


def _trace(path, recorder_cls):
    rec = recorder_cls(enabled=True)
    rec.configure(path=path, fresh=True)
    with rec.span("sim/warmup", cat="warmup", T=10):
        pass
    with rec.span("sweep/execute", cat="execute", compiled=True):
        pass
    with rec.span("bench/first_call", cat="bench"):
        pass
    with rec.span("bench/steady", cat="bench"):
        pass
    rec.instant("mark", cat="mark")


def _both(capsys, argv):
    """(exit code, stdout) of the reference's and the port's report,
    the env line aside: the port prints the artifact's torch version
    where the reference prints its jax version (checked on its own)."""
    out = []
    for mod in (jreport, report):
        rc = mod.main(list(argv))
        text = capsys.readouterr().out
        out.append((rc, "".join(line for line in
                                text.splitlines(keepends=True)
                                if not line.startswith("  env:"))))
    return out


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_report_prints_and_checks_as_the_reference(tmp_path, capsys,
                                                   writer):
    cls = trace.Recorder if writer == "port" else jtrace.Recorder
    good = tmp_path / "good"
    good.mkdir()
    win = {"begin": 10, "end": 90, "T": 100, "method": "ewma_plateau"}
    _artifact(good / "run.json", win)
    _trace(good / "run.trace.jsonl", cls)
    (want, got) = _both(capsys, [str(good / "run.json")])
    assert want == got and want[0] == 0
    assert "phases:" in got[1] and "windows (stable-only" in got[1]
    report.main([str(good / "run.json")])
    assert "  env:  2.x, cpu\n" in capsys.readouterr().out
    meta = json.loads((good / "run.json").read_text())
    meta["meta"] = dict(meta["meta"], jax_version="0.9.0")
    del meta["meta"]["torch_version"]
    (good / "ref.json").write_text(json.dumps(meta))
    for mod in (jreport, report):  # a reference artifact: its jax version
        mod.main([str(good / "ref.json")])
        assert "  env:  0.9.0, cpu\n" in capsys.readouterr().out
    (good / "ref.json").unlink()
    assert _both(capsys, ["--check", str(good)]) == [(0, (
        "repro-report --check: ok (0 problem(s))\n"))] * 2
    # a torn FINAL line is tolerated; a torn line mid-file is not
    tr = good / "run.trace.jsonl"
    tr.write_text(tr.read_text() + '{"name": "cut')
    want, got = _both(capsys, ["--check", str(good)])
    assert want == got and got[0] == 0
    lines = tr.read_text().splitlines()
    tr.write_text("\n".join(lines[:2] + ['{"name": "cut'] + lines[2:]))
    want, got = _both(capsys, ["--check", str(good)])
    assert want == got and got[0] == 1
    # a window with begin > end, an unknown method, a malformed block
    for bad in ({"begin": 50, "end": 40, "T": 100,
                 "method": "ewma_plateau"},
                {"begin": 0, "end": 140, "T": 100, "method": "censored"},
                {"begin": 0, "end": 10, "T": 100, "method": "median"},
                {"begin": "x", "end": 10, "T": 100}):
        d = tmp_path / "bad"
        d.mkdir(exist_ok=True)
        _artifact(d / "run.json", bad)
        want, got = _both(capsys, ["--check", str(d)])
        assert want == got and got[0] == 1, bad
    assert _both(capsys, ["--check", str(tmp_path / "missing")]) == \
        [(1, "")] * 2


def test_theory_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        theory.maxload_gap_empirical(8, 8, 2, trials=2)
