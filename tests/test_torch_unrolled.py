"""The port's unrolled-waves engine (``SimConfig(unroll_waves=True)``)
against the live JAX reference's unrolled engine and against the port's
own hoisted engine.

The reference keeps its pre-scan engine as the bit-for-bit oracle of the
scan engine (``tests/test_engine.py``); the port keeps it for the same
contract.  Every run gets the reference's realized grid (``storm`` at
m = 8 over 40 ticks: midas steers from tick 7 and the cache serves
hits) and starts from the same targets; every per-tick output and
every leaf
of the final ``SimState`` (the cache or ``FleetState``, the policy's
pins and history, the controller, the telemetry and the key) must be
equal bit for bit: port unrolled against reference unrolled, and port
unrolled against port hoisted.  The configurations: midas + cache,
``power_of_d``, ``chbl``, fleet routing at P = 4, a ``proxy_crash``
with remap, the warmup, and one ``run_sweep`` cell.

The steering ΔV of a wave (``policies.base.steering_dv``) is summed in
the order XLA's CPU backend takes for a reduction fused into its loop
(``xla.loop_sum``); the engine's dV is held bit for bit at 17, 33 and
66 requests a wave as well.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import make_workload as jmake  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core import SweepSpec, run_sweep  # noqa: E402
from repro_torch.core.faults import FaultEvent  # noqa: E402

T, M, N = 40, 8, 512
TARGETS = (0.15, 500.0)
FIELDS = ("queue_timeline", "arrivals", "lat_pred", "d_timeline",
          "delta_l_timeline", "f_max_timeline", "pressure", "steered",
          "eligible", "cache_hits")
CRASH = dict(kind="proxy_crash", t0=10, duration=25, target=0)
CASES = {
    "midas_cache": dict(policy="midas", middleware=("cache",)),
    "power_of_d": dict(policy="power_of_d"),
    "chbl": dict(policy="chbl", middleware=("cache",)),
    "fleet_routing": dict(policy="midas", middleware=("fleet_cache",), P=4,
                          gossip_ms=100.0, fleet_routing=True),
    "proxy_crash": dict(policy="midas", middleware=("cache",),
                        faults=(CRASH,)),
}


def _configs(case, unroll=True):
    kw = dict(CASES[case], m=M, N=N, unroll_waves=unroll)
    faults = kw.pop("faults", None)
    jkw, tkw = dict(kw), dict(kw)
    if faults:
        jkw["faults"] = tuple(jfaults.FaultEvent(**f) for f in faults)
        tkw["faults"] = tuple(FaultEvent(**f) for f in faults)
    return JConfig(**jkw), tsim.SimConfig(**tkw)


@pytest.fixture(scope="module")
def grid():
    """The reference's realized storm grid, as numpy arrays."""
    wl = jmake("storm", T=T, m=M, seed=0, N=N)
    return tuple(np.array(x) for x in (wl.keys, wl.mask, wl.is_write))


@pytest.fixture(scope="module")
def reference(grid):
    """The live JAX unrolled engine's run of each case (final state,
    per-tick outputs), made once, on demand."""
    runs = {}

    def run(case):
        if case not in runs:
            jcfg, _ = _configs(case)
            runs[case] = jsim._run_scan(
                jcfg, jsim.init_state(jcfg, *TARGETS), *grid)
        return runs[case]

    return run


def _port_run(cfg, grid):
    st = tsim.init_state(cfg, *TARGETS, device="cpu")
    return tsim.run_ticks(cfg, st, *(torch.as_tensor(x) for x in grid))


def _assert_same_tree(want, got, what):
    """Leaf by leaf, bit for bit; ``want`` a JAX or a port tree."""
    if isinstance(jax.tree_util.tree_leaves(want)[0], torch.Tensor):
        wl = [w.numpy() for w in jax.tree_util.tree_leaves(want)]
    else:
        wl = [np.asarray(w) for w in
              jax.tree_util.tree_leaves(jax.device_get(want))]
    gl = [g.numpy() for g in jax.tree_util.tree_leaves(got)]
    assert len(wl) == len(gl), what
    for i, (w, g) in enumerate(zip(wl, gl)):
        if w.dtype == np.uint32:  # threefry keys
            w = w.astype(np.int64)
        assert w.shape == g.shape and w.dtype == g.dtype, (what, i)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: leaf {i}")


@pytest.mark.parametrize("case", list(CASES))
def test_unrolled_matches_reference_and_hoisted(case, grid, reference):
    _, cfg = _configs(case)
    jfinal, jouts = reference(case)
    final, outs = _port_run(cfg, grid)
    _assert_same_tree(jouts, outs, f"{case}: outputs, reference")
    _assert_same_tree(jfinal, final, f"{case}: final state, reference")
    _, hoisted = _configs(case, unroll=False)
    hfinal, houts = _port_run(hoisted, grid)
    _assert_same_tree(houts, outs, f"{case}: outputs, hoisted")
    _assert_same_tree(hfinal, final, f"{case}: final state, hoisted")
    if case in ("midas_cache", "fleet_routing", "proxy_crash"):
        assert float(outs.steered.sum()) > 0, "midas never steered"
    if case == "proxy_crash":
        # the crash is detected and remaps: once detected dead (past the
        # pins made before), server 0 gets nothing
        fc = tsim.faults_lib.compile_faults(cfg, T)
        dead = np.flatnonzero(~fc.detected[:, 0])
        assert fc.has_remap and dead.size
        assert float(outs.arrivals[dead[0] + 6:dead[-1] + 1, 0].sum()) == 0
        assert dead[-1] + 1 < T  # and it rejoins within the run


def test_unrolled_engine_routes_one_wave_at_a_time(grid, monkeypatch):
    """No feasible set or draw is hoisted, and midas never asks for a
    whole tick: ``Policy.route`` runs once a wave."""
    _, cfg = _configs("midas_cache")
    calls = {"route": 0, "route_tick": 0}
    pol = type(tsim.policy_lib.get("midas"))
    real_route, real_tick = pol.route, pol.route_tick

    def route(self, state, ctx):
        calls["route"] += 1
        return real_route(self, state, ctx)

    def route_tick(self, state, ctx):
        calls["route_tick"] += 1
        return real_tick(self, state, ctx)

    monkeypatch.setattr(pol, "route", route)
    monkeypatch.setattr(pol, "route_tick", route_tick)
    keys, mask, is_write = (torch.as_tensor(x[:5]) for x in grid)
    policy = tsim.policy_lib.get("midas")
    ring = tsim.hashring.make_ring(M, cfg.V, device="cpu")
    hz = tsim._scan_inputs(cfg, ring, policy, torch.tensor([0, 0]), keys,
                           mask, is_write)
    assert hz.feasg is None and hz.draws is None
    st = tsim.init_state(cfg, *TARGETS, device="cpu")
    tsim.run_ticks(cfg, st, keys, mask, is_write)
    assert calls == {"route": 5 * cfg.n_groups, "route_tick": 0}


def test_warmup_under_the_unrolled_engine(grid):
    """The warmup (the bare ``hash`` policy on the ``light`` grid) gives
    the reference's targets and the hoisted engine's."""
    jcfg, cfg = _configs("midas_cache")
    light = jmake("light", T=T, m=M, seed=99, N=N)
    want = jsim.warmup(jcfg, T=T)
    wl = convert.workload_from_numpy(light.keys, light.mask, light.is_write,
                                     N, device="cpu")
    got = tsim.warmup(cfg, device="cpu", wl=wl)
    assert got == want
    assert tsim.warmup(dataclasses.replace(cfg, unroll_waves=False),
                       device="cpu", wl=wl) == got


def test_sweep_cell_under_the_unrolled_engine(grid, reference):
    """One ``run_sweep`` cell with pinned targets: the reference's
    unrolled run of its (config, grid, seed) and the port's hoisted
    sweep row, field for field, and the final cache leaf by leaf."""
    _, cfg = _configs("midas_cache")
    jfinal, jouts = reference("midas_cache")
    wl = convert.workload_from_numpy(*grid, N, device="cpu", name="storm")
    got = run_sweep(SweepSpec(config=cfg, workloads=wl, targets=TARGETS),
                    device="cpu").row()
    hoisted = run_sweep(SweepSpec(
        config=dataclasses.replace(cfg, unroll_waves=False), workloads=wl,
        targets=TARGETS), device="cpu").row()
    for f, j in zip(FIELDS, ("L", "arrivals", "lat_pred", "d", "delta_l",
                             "f_max", "pressure", "steered", "eligible",
                             "cache_hits")):
        w = np.asarray(getattr(jouts, j))
        np.testing.assert_array_equal(getattr(got, f), w, err_msg=f)
        np.testing.assert_array_equal(getattr(hoisted, f), w, err_msg=f)
    _assert_same_tree(jfinal.mw[0], got.final_cache, "sweep cache")


@pytest.mark.parametrize("m", [64, 128], ids=["rg17", "rg33"])
def test_dv_sums_waves_in_xla_order(m):
    """The hoisted engine's per-tick dV (and every other output) equals
    the live jitted engine's at 17 and 33 requests a wave: XLA sums a
    wave's terms in a vectorized loop up to 32 and in windows of 32
    above, and PyTorch's own sum order differs from both (before the
    repair 31 of 150 ticks differed at m = 64)."""
    wl = jmake("storm", T=40, m=m, seed=0, N=4096)
    grid = tuple(np.array(x) for x in (wl.keys, wl.mask, wl.is_write))
    jcfg = JConfig(m=m, N=4096, policy="midas", middleware=("cache",))
    cfg = tsim.SimConfig(m=m, N=4096, policy="midas", middleware=("cache",))
    _, jouts = jsim._run_scan(jcfg, jsim.init_state(jcfg, *TARGETS), *grid)
    _, outs = _port_run(cfg, grid)
    assert float(outs.steered.sum()) > 0
    _assert_same_tree(jouts, outs, f"m={m}: outputs")
