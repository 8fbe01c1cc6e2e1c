"""The port's sweep engine against the live JAX ``run_sweep``.

The reference batches each (policy, controller) over its workloads and
seeds with ``vmap``; the port runs the cells one after another through
its tick loop.  Both get the reference's realized grids, and every row
is compared with the reference's row bit for bit, field by field: on a
24-cell grid (midas, power_of_d and round_robin × hysteresis and static
× ``bursty`` and ``skewed`` × seeds 0 and 1; m = 8, N = 512, T = 60)
under ``metrics="full"`` and ``"summary"``; with the warmup on (the
port's warmup fed the reference's realized ``light`` grid); with a
``faults=`` override on ``fleet_cache`` (E12's ``proxy_crash``,
retimed into the horizon); under ``chbl`` and the oscillation guard.
Every port row also equals the port's own ``simulate`` (and
``summarize`` of it).  Then the spec's validation, the result's
accessors and the ``simulate_sweep`` shim, against the reference's
behaviour and error text.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import SweepSpec as JSpec  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import make_workload as jmake  # noqa: E402
from repro.core import run_sweep as jrun_sweep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import SimConfig, SweepSpec, run_sweep  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core.faults import FaultEvent  # noqa: E402

M, N, T = 8, 512, 60
GRID = dict(policies=("midas", "power_of_d", "round_robin"),
            controllers=("hysteresis", "static"), seeds=(0, 1),
            do_warmup=False)
CFG = dict(m=M, N=N, middleware=("cache",))
# E12 (benchmarks/resilience.py): its config and its proxy_crash block
# (t0 = 300, 250 ticks, of 900), every time divided by 10
E12 = dict(m=8, N=1024, middleware=("fleet_cache",), gossip_ms=100.0)
E12_T = 90
CRASH = dict(kind="proxy_crash", t0=30, duration=25, target=0)


def _port_wl(wl):
    return convert.workload_from_numpy(
        np.asarray(wl.keys), np.asarray(wl.mask), np.asarray(wl.is_write),
        wl.N, device="cpu", name=wl.name)


def _fields(row):
    if hasattr(row, "_fields"):
        return row._fields
    return tuple(f.name for f in dataclasses.fields(row))


def assert_rows_equal(want, got, what):
    """Every field of two rows (SimResult or SummaryResult) bit for bit,
    dtype included; the final cache leaf by leaf."""
    assert type(want).__name__ == type(got).__name__, what
    for f in _fields(want):
        w, g = getattr(want, f), getattr(got, f)
        if f == "config":
            continue
        if f == "final_cache":
            if w is None:
                assert g is None, what
                continue
            wl = jax.tree_util.tree_leaves(jax.device_get(w))
            gl = jax.tree_util.tree_leaves(g)
            assert len(wl) == len(gl), what
            for i, (a, b) in enumerate(zip(wl, gl)):
                b = b.cpu().numpy() if torch.is_tensor(b) else b
                np.testing.assert_array_equal(
                    b, np.asarray(a), err_msg=f"{what}: final leaf {i}")
            continue
        if w is None or g is None:
            assert w is None and g is None, (what, f)
            continue
        w, g = np.asarray(w), np.asarray(g)
        assert w.dtype == g.dtype and w.shape == g.shape, (what, f)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


@pytest.fixture(scope="module")
def grids():
    """The reference's realized grids, made once."""
    return {name: jmake(name, T=T, m=M, seed=0, N=N)
            for name in ("bursty", "skewed")}


@pytest.fixture(scope="module")
def sweeps(grids):
    """The reference's and the port's 24-cell sweep in each metrics
    mode, made once on demand: {mode: (reference, port)}."""
    done = {}

    def get(mode):
        if mode not in done:
            wls = list(grids.values())
            want = jrun_sweep(JSpec(config=JConfig(**CFG), workloads=wls,
                                    metrics=mode, **GRID))
            got = run_sweep(SweepSpec(config=SimConfig(**CFG),
                                      workloads=[_port_wl(w) for w in wls],
                                      metrics=mode, **GRID), device="cpu")
            done[mode] = (want, got)
        return done[mode]

    return get


@pytest.mark.parametrize("policy", GRID["policies"])
@pytest.mark.parametrize("mode", ("full", "summary"))
def test_grid_matches_live_run_sweep(sweeps, mode, policy):
    want, got = sweeps(mode)
    assert list(got.spec.coords()) == list(want.spec.coords())
    assert set(got.cells) == set(want.cells)
    for coord, row in want.items():
        if coord[0] != policy:
            continue
        assert_rows_equal(row, got.cells[coord], coord)
        if mode == "summary":
            assert row.q_mean_timeline.shape == (T,)
            assert got.cells[coord].queue_hist.sum() == T * M
    if policy == "midas" and mode == "full":
        steered = sum(r.steered.sum() for c, r in got.items()
                      if c[0] == "midas")
        assert steered > 0


@pytest.mark.parametrize("policy", GRID["policies"])
def test_rows_equal_the_ports_own_simulate(sweeps, grids, policy):
    """A full row is the cell's ``simulate``; a summary row is
    ``summarize`` of it, bit for bit."""
    (_, full), (_, summ) = sweeps("full"), sweeps("summary")
    for (p, c, w, s), row in full.items():
        if p != policy:
            continue
        cfg = SimConfig(**CFG, policy=p, controller=c, seed=s)
        alone = tsim.simulate(cfg, _port_wl(grids[w]), do_warmup=False,
                              device="cpu")
        assert_rows_equal(alone, row, (p, c, w, s))
        assert_rows_equal(tsim.summarize(alone, device="cpu"),
                          summ.cells[(p, c, w, s)], (p, c, w, s))


def test_warmup_is_shared_across_controllers(grids, monkeypatch):
    """With the warmup on, midas's targets come from one warmup shared
    by both controllers; the port's warmup runs the reference's
    realized ``light`` grid.  Rows equal the reference's."""
    light = _port_wl(jmake("light", T=1200, m=M, seed=99, N=N))
    calls = []
    real = tsim.warmup

    def counted(cfg, *a, **k):
        calls.append((cfg.policy, cfg.controller))
        return real(cfg, *a, **k)

    monkeypatch.setattr(tsim, "make_workload", lambda *a, **k: light)
    monkeypatch.setattr(tsim, "warmup", counted)
    kw = dict(controllers=("hysteresis", "static"), metrics="summary")
    want = jrun_sweep(JSpec(config=JConfig(**CFG),
                            workloads=grids["bursty"], **kw))
    got = run_sweep(SweepSpec(config=SimConfig(**CFG),
                              workloads=_port_wl(grids["bursty"]), **kw),
                    device="cpu")
    assert calls == [("midas", "hysteresis")]
    for coord, row in want.items():
        assert_rows_equal(row, got.cells[coord], coord)
    # the targets reached the controller: they are not the defaults
    targets = tsim.warmup(SimConfig(**CFG), device="cpu", wl=light)
    assert targets != (0.15, 5.0 * 100.0)


def test_fault_override_on_the_fleet():
    """E12's proxy_crash (retimed) as a ``faults=`` override of a
    fault-free ``fleet_cache`` config, under hysteresis and aimd."""
    wl = jmake("bursty", T=E12_T, m=E12["m"], seed=0, N=E12["N"])
    kw = dict(policies=("midas",), controllers=("hysteresis", "aimd"),
              seeds=(0, 1), do_warmup=False)
    want = jrun_sweep(JSpec(config=JConfig(**E12), workloads=wl,
                            faults=(jfaults.FaultEvent(**CRASH),), **kw))
    spec = SweepSpec(config=SimConfig(**E12), workloads=_port_wl(wl),
                     faults=(FaultEvent(**CRASH),), **kw)
    assert spec.config.faults == (FaultEvent(**CRASH),)
    got = run_sweep(spec, device="cpu")
    for coord, row in want.items():
        assert_rows_equal(row, got.cells[coord], coord)
        cfg = dataclasses.replace(spec.config, controller=coord[1],
                                  seed=coord[3])
        alone = tsim.simulate(cfg, _port_wl(wl), do_warmup=False,
                              device="cpu")
        assert_rows_equal(alone, got.cells[coord], coord)
    # the crash bites: the dead server drains nothing while it is down
    row = got.row(controller="hysteresis", seed=0)
    q = row.queue_timeline[:, 0]
    assert (np.diff(q[30:55]) >= 0).all() and row.final_cache is not None


@pytest.mark.parametrize("mode", ("full", "summary"))
def test_chbl_and_the_guard(grids, mode):
    kw = dict(policies=("chbl", "midas"), seeds=(0, 1), metrics=mode,
              do_warmup=False)
    wls = list(grids.values())
    want = jrun_sweep(JSpec(config=JConfig(**CFG, guard=True),
                            workloads=wls, **kw))
    got = run_sweep(SweepSpec(config=SimConfig(**CFG, guard=True),
                              workloads=[_port_wl(w) for w in wls], **kw),
                    device="cpu")
    for coord, row in want.items():
        assert_rows_equal(row, got.cells[coord], coord)


# ---------------------------------------------------------------------------
# SweepSpec validation, SweepResult accessors, the shim
# ---------------------------------------------------------------------------


def _both(grids, **kw):
    """(reference spec kwargs, port spec kwargs) over the same grids."""
    wl = kw.pop("workloads", None)
    jkw, tkw = dict(kw), dict(kw)
    if wl is not None:
        jkw["workloads"] = wl
        tkw["workloads"] = (_port_wl(wl) if hasattr(wl, "keys")
                            else [_port_wl(w) for w in wl])
    return jkw, tkw


def _errors(grids):
    b = grids["bursty"]
    short = jmake("bursty", T=T - 8, m=M, seed=0, N=N)
    other = jmake("bursty", T=T, m=M, seed=1, N=N)
    return {
        "no_workload": dict(workloads=()),
        "shapes": dict(workloads=(b, short)),
        "names": dict(workloads=(b, other)),
        "no_seed": dict(workloads=b, seeds=()),
        "policy": dict(workloads=b, policies=("nope",)),
        "controller": dict(workloads=b, controllers=("nope",)),
        "metrics": dict(workloads=b, metrics="nope"),
        "devices_0": dict(workloads=b, devices=0),
        "devices_bool": dict(workloads=b, devices=True),
        "devices_float": dict(workloads=b, devices=1.5),
    }


@pytest.mark.parametrize("case", ["no_workload", "shapes", "names",
                                  "no_seed", "policy", "controller",
                                  "metrics", "devices_0", "devices_bool",
                                  "devices_float"])
def test_spec_errors_match_the_reference(grids, case):
    jkw, tkw = _both(grids, **_errors(grids)[case])
    with pytest.raises(ValueError) as want:
        JSpec(config=JConfig(m=M, N=N), **jkw)
    with pytest.raises(ValueError) as got:
        SweepSpec(config=SimConfig(m=M, N=N), **tkw)
    assert str(got.value) == str(want.value)


def test_more_than_one_device_is_not_ported(grids):
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 19"):
        SweepSpec(config=SimConfig(m=M, N=N),
                  workloads=_port_wl(grids["bursty"]), devices=2)


def test_spec_defaults_and_coercion(grids):
    jkw, tkw = _both(grids, workloads=grids["bursty"], seeds=[np.int64(1)],
                     targets=(np.float32(0.2), 300))
    want = JSpec(config=JConfig(m=M, N=N), **jkw)
    got = SweepSpec(config=SimConfig(m=M, N=N), **tkw)
    for f in ("policies", "controllers", "seeds", "metrics", "devices",
              "faults", "do_warmup", "targets", "workload_names",
              "n_cells"):
        assert getattr(got, f) == getattr(want, f), f
        if f in ("seeds", "targets"):
            assert [type(x) for x in getattr(got, f)] == \
                [type(x) for x in getattr(want, f)]
    assert list(got.coords()) == list(want.coords())
    assert got.workloads == (tkw["workloads"],)
    # () forces the zero-fault engine, None keeps the config's faults
    crash = (FaultEvent("proxy_crash", t0=5, target=0),)
    base = SimConfig(m=M, N=N, faults=crash)
    assert SweepSpec(config=base, workloads=tkw["workloads"],
                     faults=()).config.faults == ()
    assert SweepSpec(config=base, workloads=tkw["workloads"]
                     ).config.faults == crash
    with pytest.raises(ValueError) as want:
        JSpec(config=JConfig(m=M, N=N), workloads=grids["bursty"],
              faults=("nope",))
    with pytest.raises(ValueError) as got:
        SweepSpec(config=SimConfig(m=M, N=N), workloads=tkw["workloads"],
                  faults=("nope",))
    assert str(got.value) == str(want.value)


def _accessor_calls(res, names):
    """Outcomes of the accessors on a 2-policy × 2-workload × 2-seed,
    1-controller result: values as coordinates, errors as text."""
    by_id = {id(r): c for c, r in res.items()}

    def outcome(fn, *a, **k):
        try:
            out = fn(*a, **k)
        except (ValueError, TypeError) as e:
            return (type(e).__name__, str(e))
        if isinstance(out, tuple):
            return tuple(by_id[id(r)] for r in out)
        return by_id[id(out)]

    calls = [
        (res.rows, dict(policy="midas", workload=names[0])),
        (res.rows, dict(workload=names[0])),
        (res.rows, dict(policy="nope", workload=names[0])),
        (res.rows, dict(policy="midas")),
        (res.row, dict(policy="midas", workload=names[1], seed=1)),
        (res.row, dict(policy="midas", workload=names[1])),
        (res.row, dict(policy="round_robin", workload=names[0], seed=7)),
        (res.row, dict(policy="midas", controller="static",
                       workload=names[0], seed=0)),
    ]
    return [outcome(fn, **k) for fn, k in calls]


def test_result_accessors_and_legacy_shapes(sweeps, grids):
    """rows / row / items / to_legacy on one realized grid each: the
    same coordinates and the same errors as the reference's."""
    names = tuple(grids)
    kw = dict(policies=("midas", "round_robin"), seeds=(0, 1),
              metrics="summary", do_warmup=False)
    wls = list(grids.values())
    want = jrun_sweep(JSpec(config=JConfig(**CFG), workloads=wls, **kw))
    got = run_sweep(SweepSpec(config=SimConfig(**CFG),
                              workloads=[_port_wl(w) for w in wls], **kw),
                    device="cpu")
    assert _accessor_calls(got, names) == _accessor_calls(want, names)
    assert [c for c, _ in got.items()] == [c for c, _ in want.items()]
    for single in (True, False):
        lw, lg = want.to_legacy(single), got.to_legacy(single)
        assert lg.keys() == lw.keys()
        for p in lw:
            if single:
                assert len(lg[p]) == len(lw[p])
                for a, b in zip(lw[p], lg[p]):
                    assert_rows_equal(a, b, p)
            else:
                assert lg[p].keys() == lw[p].keys()
    # a two-controller result has no legacy shape
    _, full = sweeps("full")
    with pytest.raises(ValueError) as e:
        full.to_legacy(True)
    want_full, _ = sweeps("full")
    with pytest.raises(ValueError) as w:
        want_full.to_legacy(True)
    assert str(e.value) == str(w.value)


def test_simulate_sweep_shim_warns_once_and_matches(grids):
    wl = _port_wl(grids["bursty"])
    cfg = SimConfig(**CFG)
    tsim._SWEEP_DEPRECATION_WARNED[0] = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = [tsim.simulate_sweep(cfg, wl, seeds=(0, 1),
                                      do_warmup=False, metrics="summary",
                                      device="cpu")
                  for _ in range(3)]
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)
           and "SweepSpec" in str(w.message)]
    assert len(dep) == 1 and tsim._SWEEP_DEPRECATION_WARNED[0]
    res = run_sweep(SweepSpec(config=cfg, workloads=wl, seeds=(0, 1),
                              metrics="summary", do_warmup=False),
                    device="cpu")
    assert set(legacy[0]) == {"midas"}
    for got, want in zip(legacy[0]["midas"], res.rows()):
        assert_rows_equal(want, got, "shim")
    multi = tsim.simulate_sweep(cfg, [wl, _port_wl(grids["skewed"])],
                                policies=("round_robin",), seeds=(0,),
                                do_warmup=False, device="cpu")
    assert set(multi["round_robin"]) == {"bursty", "skewed"}
    assert multi["round_robin"]["skewed"][0].queue_timeline.shape == (T, M)


def test_run_sweep_without_a_device_needs_a_card(grids, monkeypatch):
    spec = SweepSpec(config=SimConfig(m=M, N=N),
                     workloads=_port_wl(grids["bursty"]), do_warmup=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep(spec)
    with pytest.raises(ValueError, match="CUDA device"):
        run_sweep(dataclasses.replace(
            spec, config=SimConfig(m=M, N=N, route_impl="cuda")),
            device="cpu")
    assert tsweep.run_sweep is run_sweep
