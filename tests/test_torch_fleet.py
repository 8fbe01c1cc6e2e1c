"""The port's proxy fleet against the reference's (``repro.core.fleet``).

``lookup_fleet`` is driven step by step beside the reference on the
cases of ``tests/test_core_fleet.py`` and on random multi-proxy ticks
with colliding keys, every leaf of the state compared after every step.
The engine with the ``fleet_cache`` stage and fleet routing is held bit
for bit against the live JAX engine on the reference's realized grids
(m = 8, P ∈ {2, 4, 8}, gossip 0/100/400 ms, the three cache modes,
fleet routing on and off, and the reference's ``midas_fleet`` case),
the final ``FleetState`` leaf by leaf.  The Δ = 0 contract (a
``gossip_ms=0`` fleet is the shared ``("cache",)`` run) is held in the
port alone.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import fleet as jfleet  # noqa: E402
from repro.core import make_workload as jmake  # noqa: E402
from repro.core import simulate as jsimulate  # noqa: E402
from repro.core import telemetry as jtelemetry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core import telemetry as ttelemetry  # noqa: E402

DT = 50.0
FIELDS = ("queue_timeline", "arrivals", "lat_pred", "d_timeline",
          "delta_l_timeline", "f_max_timeline", "pressure", "steered",
          "eligible", "cache_hits")


def _assert_trees_equal(want, got, what=""):
    wl = jax.tree_util.tree_leaves(jax.device_get(want))
    gl = jax.tree_util.tree_leaves(got)
    assert len(wl) == len(gl), what
    for i, (w, g) in enumerate(zip(wl, gl)):
        w, g = np.asarray(w), g.cpu().numpy()
        assert w.dtype == g.dtype, (what, i)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


# jitted, as the engine runs it: XLA fuses the multiply-adds the port's
# ``xla.fma`` reproduces
_LOOKUP = jax.jit(jfleet.lookup_fleet, static_argnames=(
    "mode", "lease_ms", "rtt_ms", "p_star", "gossip_ms"))


class _Pair:
    """A reference fleet and a port fleet driven with the same ticks."""

    def __init__(self, N, P, gossip_ms, mode="lease", lease_ms=100_000.0):
        D = jfleet.delay_ticks(gossip_ms, DT)
        assert tfleet.delay_ticks(gossip_ms, DT) == D
        self.j = jfleet.init_fleet(N, P, D)
        self.t = tfleet.init_fleet(N, P, D, device="cpu")
        self.kw = dict(mode=mode, lease_ms=lease_ms, gossip_ms=gossip_ms)
        _assert_trees_equal(self.j, self.t, "init")

    def step(self, keys, proxy, writes, mask=None):
        keys = np.asarray(keys, np.int32)
        mask = np.ones(keys.shape, bool) if mask is None else mask
        writes = np.asarray(writes, bool)
        proxy = np.asarray(proxy, np.int32)
        now = np.float32(int(self.j.tick) * DT)
        self.j, jh = _LOOKUP(
            self.j, jnp.asarray(keys), jnp.asarray(mask),
            jnp.asarray(writes), jnp.asarray(proxy), jnp.asarray(now),
            **self.kw)
        self.t, th = tfleet.lookup_fleet(
            self.t, torch.as_tensor(keys), torch.as_tensor(mask),
            torch.as_tensor(writes), torch.as_tensor(proxy),
            torch.tensor(now), **self.kw)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        _assert_trees_equal(self.j, self.t, f"tick {int(self.j.tick)}")
        return th.numpy()


def test_remote_install_invisible_until_gossip_propagates():
    f = _Pair(16, 2, 100.0)
    assert not f.step([3], [0], [False])[0]   # p0 installs (miss)
    assert not f.step([3], [1], [False])[0]   # too fresh for p1
    f.step([9], [0], [False])                 # unrelated tick
    assert f.step([3], [0], [False])[0]
    assert int(f.t.hits) == 1 and int(f.t.misses) == 3


def test_own_events_always_visible_immediately():
    f = _Pair(16, 2, 500.0)
    assert not f.step([7], [0], [False])[0]
    assert f.step([7], [0], [False])[0]       # own install


def test_lease_mode_pays_stale_serves_under_gossip_delay():
    f = _Pair(16, 2, 100.0)
    f.step([3], [0], [False])                 # p0 installs
    f.step([3], [0], [True])                  # p0 invalidates
    assert f.step([3], [1], [False])[0]       # p1: lagged view
    assert int(f.t.stale_serves) == 1 and int(f.t.stale_p[1]) == 1
    f.step([9], [0], [False])
    assert not f.step([3], [1], [False])[0]   # propagated: gone


@pytest.mark.parametrize("mode,gossip_ms,P", [
    ("lease", 0.0, 3), ("lease", 100.0, 3), ("lease", 400.0, 5),
    ("ttl_aggregate", 100.0, 3), ("ttl_per_key", 150.0, 4),
    ("ttl_per_key", 0.0, 2)])
def test_random_ticks_with_colliding_keys(mode, gossip_ms, P):
    """Ticks of 40 requests over 12 keys: keys repeat within a tick,
    written and read by different proxies, so invalidations and
    installs collide in the gossip log."""
    rng = np.random.default_rng(P)
    f = _Pair(12, P, gossip_ms, mode=mode, lease_ms=700.0)
    served = 0
    for _ in range(30):
        served += f.step(rng.integers(0, 12, 40), rng.integers(0, P, 40),
                         rng.random(40) < 0.2,
                         mask=rng.random(40) < 0.9).sum()
    assert served > 0
    for p_, agg in (("hits_p", "hits"), ("misses_p", "misses"),
                    ("stale_p", "stale_serves"), ("bypasses_p",
                                                  "bypasses")):
        assert int(getattr(f.t, p_).sum()) == int(getattr(f.t, agg))
    if mode == "lease" and gossip_ms > 0:
        assert int(f.t.stale_serves) > 0


def test_slow_fleet_retunes_the_converged_table():
    f = _Pair(16, 2, 100.0, mode="ttl_aggregate")
    for t in range(6):
        f.step([t % 4, 5], [0, 1], [t % 2 == 0, False])
    j = jax.jit(jfleet.slow_fleet, static_argnums=(1, 2, 3))(
        f.j, 5000.0, 2.0, jnp.inf, ttl_scale=1.5)
    t = tfleet.slow_fleet(f.t, 5000.0, 2.0, float("inf"), ttl_scale=1.5)
    _assert_trees_equal(j, t, "slow")


@pytest.mark.parametrize("P,tick", [(1, 0), (3, 7), (8, 0), (8, 13)])
def test_proxy_assign_and_wave_views(P, tick):
    np.testing.assert_array_equal(
        tfleet.proxy_assign(20, P, torch.tensor(tick, dtype=torch.int32))
        .numpy(), np.asarray(jfleet.proxy_assign(20, P, tick)))
    views = np.random.default_rng(P).random((P, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tfleet.wave_views(torch.as_tensor(views), tick).numpy(),
        np.asarray(jfleet.wave_views(jnp.asarray(views), tick)))


@pytest.mark.parametrize("P,period", [(8, 5), (3, 5), (5, 5), (2, 10)])
def test_staggered_ewma_matches(P, period):
    np.testing.assert_array_equal(
        ttelemetry.staggered_phases(P, period, "cpu").numpy(),
        np.asarray(jtelemetry.staggered_phases(P, period)))
    rng = np.random.default_rng(P * period)
    jv = tv = rng.random((P, 8)).astype(np.float32)
    tv = torch.as_tensor(tv)
    step = jax.jit(jtelemetry.ewma_staggered, static_argnums=(3, 4))
    for tick in range(1, 3 * period):
        obs = (rng.random(8) * 9).astype(np.float32)
        jv = step(jv, obs, jnp.int32(tick), period, 0.2)
        tv = ttelemetry.ewma_staggered(tv, torch.as_tensor(obs), tick,
                                       period, 0.2)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_fault_layer_parts_raise_naming_the_roadmap_item():
    """The fault layer's parts are ported (they raised before): an
    unpartitioned fleet at full availability serves as one without
    them, and an empty remap changes nothing.  The fleet's own argument
    checks still raise."""
    args = (torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=bool),
            torch.zeros(2, dtype=bool), torch.zeros(2, dtype=torch.int32),
            torch.tensor(0.0))
    plain, _ = tfleet.lookup_fleet(tfleet.init_fleet(8, 2, 1, device="cpu"),
                                   *args)
    for kw in (dict(partitioned=torch.zeros(2, dtype=bool)),
               dict(avail=torch.tensor(1.0))):
        got, _ = tfleet.lookup_fleet(
            tfleet.init_fleet(8, 2, 1, device="cpu"), *args, **kw)
        for x, y in zip(jax.tree_util.tree_leaves(plain),
                        jax.tree_util.tree_leaves(got)):
            assert torch.equal(x, y)
    fl = tfleet.init_fleet(8, 2, 1, device="cpu")
    before = [x.clone() for x in jax.tree_util.tree_leaves(fl)]
    fl = tfleet.remap_invalidate(fl, torch.zeros(8, dtype=bool))
    assert all(torch.equal(x, y) for x, y in
               zip(before, jax.tree_util.tree_leaves(fl)))
    with pytest.raises(ValueError, match="P >= 1"):
        tfleet.init_fleet(8, 0, 1, device="cpu")
    with pytest.raises(ValueError, match="D >= 1"):
        tfleet.init_fleet(8, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="gossip_ms"):
        tfleet.delay_ticks(-1.0, DT)


def _port_workload(wl):
    return convert.workload_from_numpy(
        np.asarray(wl.keys), np.asarray(wl.mask), np.asarray(wl.is_write),
        wl.N, device="cpu")


GRIDS = {
    "bursty": jmake("bursty", T=400, m=8, seed=3, N=512),
    "storm": jmake("skewed", T=300, m=8, seed=2, N=512, write_frac=0.15),
    "golden": jmake("bursty", T=160, m=8, seed=3, N=512),
}
GOSSIP = (0.0, 100.0, 400.0)
MODES = tcache.MODES
# every (gossip, mode, routing) triple; P rotates over 2, 4 and 8 so
# that every (P, gossip) and (P, mode) pair appears too
ENGINE_CASES = [
    (P, g, mode, routing)
    for (gi, g), (mi, mode), routing in itertools.product(
        enumerate(GOSSIP), enumerate(MODES), (True, False))
    for P in ((2, 4, 8)[(gi + mi + routing) % 3],)
]


def _engine_pair(grid, **kw):
    wl = GRIDS[grid]
    want = jsimulate(JConfig(**kw), wl, do_warmup=False)
    got = tsim.simulate(tsim.SimConfig(**kw), _port_workload(wl),
                        do_warmup=False, device="cpu")
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert w.dtype == g.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    _assert_trees_equal(want.final_cache, got.final_cache, "FleetState")
    return got


@pytest.mark.parametrize("P,gossip_ms,mode,routing", ENGINE_CASES)
def test_fleet_engine_matches_live_reference(P, gossip_ms, mode, routing):
    grid = "bursty" if routing else "storm"
    got = _engine_pair(grid, m=8, N=512, P=P, policy="midas",
                       middleware=("fleet_cache",), cache_mode=mode,
                       gossip_ms=gossip_ms, fleet_routing=routing)
    fc = got.final_cache
    assert int(fc.hits) > 0
    assert int(fc.hits_p.sum()) == int(fc.hits)
    if routing:
        assert got.steered.sum() > 0


@pytest.mark.parametrize("policy", ("power_of_d", "chbl", "jsq", "hash"))
def test_fleet_routing_under_other_policies(policy):
    got = _engine_pair("bursty", m=8, N=512, P=4, policy=policy,
                       middleware=("fleet_cache",), gossip_ms=100.0,
                       fleet_routing=True)
    assert got.arrivals.sum() > 0


def test_midas_fleet_reference_case():
    """The reference's ``midas_fleet`` configuration
    (``tests/test_core_controllers.py``) on its golden grid."""
    _engine_pair("golden", m=8, N=512, policy="midas",
                 middleware=("fleet_cache",), fleet_routing=True,
                 gossip_ms=100.0)


@pytest.mark.parametrize("consensus", ("median", "max"))
def test_fleet_consensus_reducers(consensus):
    got = _engine_pair("bursty", m=8, N=512, P=8, policy="midas",
                       middleware=("fleet_cache",), fleet_routing=True,
                       gossip_ms=100.0, consensus=consensus)
    assert got.steered.sum() > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("P", (1, 2, 8))
def test_gossip_zero_fleet_is_the_shared_cache(mode, P):
    """The Δ = 0 contract in the port: every timeline, the counters and
    the converged table equal the shared-table run's."""
    wl = _port_workload(GRIDS["storm"])
    kw = dict(m=8, N=512, policy="midas", cache_mode=mode)
    a = tsim.simulate(tsim.SimConfig(middleware=("cache",), **kw), wl,
                      do_warmup=False, device="cpu")
    b = tsim.simulate(tsim.SimConfig(middleware=("fleet_cache",), P=P,
                                     gossip_ms=0.0, **kw), wl,
                      do_warmup=False, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for x, y in zip(a.final_cache, b.final_cache.shared):
        assert torch.equal(x, y)
    assert int(b.final_cache.stale_p.sum()) == int(a.final_cache.stale_serves)


def test_warmup_under_fleet_routing_matches_reference():
    """Warmup keeps fleet routing (the hash policy routes each proxy's
    wave): the targets equal the reference's on its realized grid."""
    from repro.core import sim as jsim

    kw = dict(m=8, N=512, P=4, policy="midas",
              middleware=("fleet_cache",), fleet_routing=True,
              gossip_ms=100.0)
    light = jmake("light", T=1200, m=8, seed=99, N=512)
    assert jsim.warmup(JConfig(**kw)) == tsim.warmup(
        tsim.SimConfig(**kw), device="cpu", wl=_port_workload(light))


def test_fleet_run_resumes_from_a_returned_state():
    """Two runs of 150 and 250 ticks from the first's final state equal
    one run of 400: the wave rotation follows the tick clock ``t0`` and
    the fleet's own counter carries on."""
    cfg = tsim.SimConfig(m=8, N=512, P=8, policy="midas",
                         middleware=("fleet_cache",), fleet_routing=True,
                         gossip_ms=100.0)
    wl = _port_workload(GRIDS["bursty"])
    grid = (wl.keys, wl.mask, wl.is_write)
    whole, wout = tsim.run_ticks(cfg, tsim.init_state(cfg, device="cpu"),
                                 *grid)
    st, a = tsim.run_ticks(cfg, tsim.init_state(cfg, device="cpu"),
                           *(x[:150] for x in grid))
    st, b = tsim.run_ticks(cfg, st, *(x[150:] for x in grid), t0=150)
    for f in wout._fields:
        assert torch.equal(getattr(wout, f),
                           torch.cat([getattr(a, f), getattr(b, f)])), f
    for x, y in zip(jax.tree_util.tree_leaves(whole),
                    jax.tree_util.tree_leaves(st)):
        assert torch.equal(x, y)
    assert int(st.mw[0].tick) == 400
