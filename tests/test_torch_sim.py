"""The port's engine equals the live JAX engine on the same inputs.

Both engines get the reference's realized ``bursty`` grid (the port does
not reproduce ``jax.random.poisson``), and the port draws every other
random bit with its bitwise threefry.  Integer-valued fields and the
queue timeline must match exactly.  ``pressure`` may differ by 1e-6
relative: it is computed from the imbalance std(L̂)/mean(L̂), whose
float32 sums over the m servers XLA may take in another order (and with
fused multiply-adds in the squared deviations).  The oracle is the live
reference run, never ``tests/data/control_golden.npz``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import make_workload as jmake  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro.core import simulate as jsimulate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402

FIELDS = (
    "queue_timeline",
    "arrivals",
    "lat_pred",
    "d_timeline",
    "delta_l_timeline",
    "f_max_timeline",
    "pressure",
    "steered",
    "eligible",
    "cache_hits",
)
CONFIGS = {
    "pod_bare": dict(policy="power_of_d", middleware=()),
    "midas_cache": dict(policy="midas", middleware=("cache",)),
    "midas_ttl_aggregate": dict(policy="midas", middleware=("cache",),
                                cache_mode="ttl_aggregate"),
    "midas_ttl_per_key": dict(policy="midas", middleware=("cache",),
                              cache_mode="ttl_per_key"),
}
WL = jmake("bursty", T=160, m=8, seed=3, N=512)
# 20 s always holds a burst, so MIDAS steers and pins; the T=160 grid
# above (the reference's golden horizon) holds none
WL_BURST = jmake("bursty", T=400, m=8, seed=3, N=512)
# the paper's baseline workloads beside bursty, realized by the reference
GRIDS = {160: WL, 400: WL_BURST}
GRIDS.update({name: jmake(name, T=400, m=8, seed=3, N=512)
              for name in ("periodic", "skewed")})


def _port_workload(wl):
    return convert.workload_from_numpy(
        np.asarray(wl.keys), np.asarray(wl.mask), np.asarray(wl.is_write),
        wl.N, device="cpu")


def _assert_results_match(want, got):
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert w.shape == g.shape and w.dtype == g.dtype, f
        if f == "pressure":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("name,grid", [
    ("pod_bare", 160), ("midas_cache", 160), ("midas_cache", 400),
    ("midas_ttl_aggregate", 400), ("midas_ttl_per_key", 400),
    ("midas_cache", "periodic"), ("midas_cache", "skewed")])
def test_simulate_matches_live_reference(name, grid):
    kw = CONFIGS[name]
    wl = GRIDS[grid]
    want = jsimulate(JConfig(m=8, N=512, **kw), wl, do_warmup=False)
    got = tsim.simulate(tsim.SimConfig(m=8, N=512, **kw),
                        _port_workload(wl), do_warmup=False, device="cpu")
    _assert_results_match(want, got)
    if grid == 400:
        assert got.steered.sum() > 0 and got.queue_timeline.max() > 4
    if "cache" in kw.get("middleware", ()):
        assert got.cache_hits.sum() > 0
        for f in ("hits", "misses", "stale_serves", "bypasses"):
            assert int(getattr(want.final_cache, f)) == int(
                getattr(got.final_cache, f)), f


def test_warmup_targets_match_on_the_reference_light_grid():
    cfg = JConfig(m=8, N=512, policy="midas", middleware=("cache",))
    light = jmake("light", T=1200, m=8, seed=99, N=512)
    want = jsim.warmup(cfg)
    got = tsim.warmup(tsim.SimConfig(m=8, N=512, policy="midas",
                                     middleware=("cache",)),
                      device="cpu", wl=_port_workload(light))
    assert want == got


@pytest.mark.parametrize("populated", (False, True))
def test_ticks_from_converted_state(populated):
    """One tick from the reference's ``init_state``, and five ticks from
    a state whose queues and telemetry are already populated."""
    kw = CONFIGS["midas_cache"]
    jcfg, tcfg = JConfig(m=8, N=512, **kw), tsim.SimConfig(m=8, N=512, **kw)
    st = jsim.init_state(jcfg, 0.2, 300.0)
    lo, hi = 0, 1
    if populated:
        rng = np.random.default_rng(0)
        st = st._replace(
            L=np.float32(rng.integers(0, 9, 8) * 0.5),
            L_hat=rng.random(8).astype(np.float32) * 4,
            p50_hat=rng.random(8).astype(np.float32) * 200,
            rng=jax.random.PRNGKey(17),
        )
        lo, hi = 40, 45
    st = jax.device_get(st)
    tst = convert.state_from_numpy(st, tcfg, device="cpu")
    k, m, w = (np.array(x)[lo:hi] for x in (WL.keys, WL.mask, WL.is_write))
    jfinal, jout = jsim._run_scan(jcfg, st, k, m, w)
    tfinal, tout = tsim.run_ticks(tcfg, tst, *(torch.as_tensor(x)
                                                for x in (k, m, w)))
    _assert_trees_match(jout, tout)
    _assert_trees_match(jfinal, tfinal)


def _assert_trees_match(want, got):
    """Leaf by leaf, with the pressure rule of the module docstring."""
    wl, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(want))
    gl = jax.tree_util.tree_leaves(got)
    assert len(wl) == len(gl)
    for (path, w), g in zip(wl, gl):
        name = jax.tree_util.keystr(path)
        w, g = np.asarray(w), g.numpy()
        if w.dtype == np.uint32:  # threefry keys
            w = w.astype(np.int64)
        assert w.dtype == g.dtype, name
        if "pressure" in name:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_unported_choices_raise_naming_the_roadmap_item():
    # the unrolled engine (item 7) is ported: alone, with fleet routing
    # and with faults it constructs and runs
    grid = tuple(torch.as_tensor(np.asarray(x)[:12])
                 for x in (WL.keys, WL.mask, WL.is_write))
    for kw in (dict(unroll_waves=True),
               dict(fleet_routing=True, unroll_waves=True),
               dict(faults=("proxy_crash",), unroll_waves=True)):
        cfg = tsim.SimConfig(m=8, N=512, **kw)
        assert cfg.unroll_waves
        _, outs = tsim.run_ticks(cfg, tsim.init_state(cfg, device="cpu"),
                                 *grid)
        assert outs.L.shape == (12, 8)
    # faults are ported: registered kinds construct, unknown ones list
    # the registered kinds
    for kw in (dict(faults=("proxy_crash",)),
               dict(middleware=("fleet_cache",), faults=("proxy_crash",))):
        cfg = tsim.SimConfig(**kw)
        assert cfg.fault_events[0].kind == "proxy_crash"
    for kw in (dict(faults=("crash",)),
               dict(middleware=("fleet_cache",), faults=("crash",))):
        with pytest.raises(ValueError, match="available: ckpt_storm_fleet"):
            tsim.SimConfig(**kw)
    # the fleet is ported: its choices construct
    for kw in (dict(fleet_routing=True), dict(middleware=("fleet_cache",)),
               dict(middleware=("fleet_cache",), fleet_routing=True,
                    gossip_ms=100.0),
               dict(middleware=("fleet_cache",), gossip_ms=400.0,
                    cache_mode="ttl_per_key")):
        cfg = tsim.SimConfig(**kw)
        assert cfg.fleet_routing == kw.get("fleet_routing", False)
    with pytest.raises(ValueError, match="available: chbl, hash, jsq"):
        tsim.SimConfig(policy="least_loaded")
    with pytest.raises(ValueError, match="available: no_margin"):
        tsim.SimConfig(ablate="no_cache")
    with pytest.raises(ValueError, match="available: auto, ref, cuda"):
        tsim.SimConfig(route_impl="pallas")
    with pytest.raises(ValueError, match="available: lease"):
        tsim.SimConfig(cache_mode="lru")
    assert dataclasses.replace(tsim.SimConfig(), faults=()).faults == ()
