"""The paper's baseline policies in the port equal the live JAX engine.

``round_robin``, ``rr_request``, ``uniform``, ``jsq`` and ``chbl`` run
on the reference-realized grids (``convert.workload_from_numpy``; the
port does not reproduce ``jax.random.poisson``): bursty at T=160 and
T=400, periodic, skewed and storm at T=400, m=8, N=512.  Every
``SimResult`` field must be bit for bit the reference's, ``pressure``
included (its 1e-6 allowance in ``test_torch_sim.py`` is not needed
since the imbalance takes XLA's sum orders).  chbl's load cap is
checked on loads that sit exactly on it, and the round-robin phases
and every ``randint`` draw against ``jax.random.randint``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import make_workload as jmake  # noqa: E402
from repro.core import simulate as jsimulate  # noqa: E402
from repro.core.policies import bounded_load as jbl  # noqa: E402
from repro.core.policies import round_robin as jrr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core.policies import bounded_load as tbl  # noqa: E402
from repro_torch.core.policies import round_robin as trr  # noqa: E402

FIELDS = ("queue_timeline", "arrivals", "lat_pred", "d_timeline",
          "delta_l_timeline", "f_max_timeline", "pressure", "steered",
          "eligible", "cache_hits")
POLICIES = ("round_robin", "rr_request", "uniform", "jsq", "chbl")
GRIDS = {
    "bursty160": jmake("bursty", T=160, m=8, seed=3, N=512),
    "bursty400": jmake("bursty", T=400, m=8, seed=3, N=512),
    **{name: jmake(name, T=400, m=8, seed=3, N=512)
       for name in ("periodic", "skewed", "storm")},
}


def _port_workload(wl):
    return convert.workload_from_numpy(
        np.asarray(wl.keys), np.asarray(wl.mask), np.asarray(wl.is_write),
        wl.N, device="cpu")


@pytest.mark.parametrize("grid", tuple(GRIDS))
@pytest.mark.parametrize("middleware", ((), ("cache",)), ids=("bare",
                                                             "cache"))
@pytest.mark.parametrize("policy", POLICIES)
def test_baseline_matches_live_reference(policy, middleware, grid):
    wl = GRIDS[grid]
    kw = dict(m=8, N=512, policy=policy, middleware=middleware)
    want = jsimulate(JConfig(**kw), wl, do_warmup=False)
    got = tsim.simulate(tsim.SimConfig(**kw), _port_workload(wl),
                        do_warmup=False, device="cpu")
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert w.dtype == g.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    if middleware:
        assert got.cache_hits.sum() > 0
    if policy == "chbl" and grid == "bursty400" and not middleware:
        assert got.steered.sum() > 0  # the cap binds and chbl steers


def _cap_ref(m):
    return jax.jit(lambda L: jbl.C_LOAD * (jnp.mean(L) + 1.0))


@pytest.mark.parametrize("m", (5, 8, 12, 40, 64))
def test_load_cap_rounds_as_the_jitted_reference(m):
    rng = np.random.default_rng(m)
    cap = _cap_ref(m)
    for _ in range(300):
        L = (rng.random(m) * rng.choice([1, 10, 1000])).astype(np.float32)
        got = tbl.load_cap(torch.as_tensor(L)).numpy()
        assert got == np.asarray(cap(L))


def _loads_on_the_cap(m, seed):
    """Float32 loads two of which equal the reference's cap exactly (a
    fixed point of L[i] <- cap(L)), where a float32 mean summed in two
    halves gives another cap, so a cap summed in another order
    misroutes."""
    rng = np.random.default_rng(seed)
    cap = _cap_ref(m)
    for _ in range(200):
        L = (rng.random(m) * 7).astype(np.float32)
        for _ in range(60):
            c = np.float32(cap(L))
            if L[0] == c and L[3] == c:
                break
            L[0] = L[3] = c
        h = m // 2
        halves = (L[:h].sum(dtype=np.float32) + L[h:].sum(dtype=np.float32))
        other = (halves / np.float32(m) + np.float32(1)) * np.float32(1.25)
        if L[0] == np.float32(cap(L)) and other != c:
            return L, c
    raise AssertionError("no load vector on the cap found")


@pytest.mark.parametrize("m", (8, 64))
def test_bounded_load_with_loads_on_the_cap(m):
    L, c = _loads_on_the_cap(m, seed=m)
    rng = np.random.default_rng(1)
    R, d_max = 64, 4
    feas = rng.integers(0, m, (R, d_max)).astype(np.int32)
    feas[::2, 0] = 0  # primary sits on the cap: under it (<=)
    feas[1::4, 1] = 3  # a successor on the cap
    mask = rng.random(R) < 0.9
    want = jax.jit(jbl.route_bounded_load)(jnp.asarray(feas), L,
                                           jnp.asarray(mask))
    got = tbl.route_bounded_load(torch.as_tensor(feas), torch.as_tensor(L),
                                 torch.as_tensor(mask))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert tbl.load_cap(torch.as_tensor(L)).numpy() == c
    on_cap = np.asarray(want)[::2][mask[::2]]
    assert (on_cap == 0).all()  # load == cap counts as under the cap


@pytest.mark.parametrize("P,seed", [(1, 0), (8, 0), (8, 7), (32, 123456)])
def test_init_rr_matches(P, seed):
    want = jrr.init_rr(P, seed)
    got = trr.init_rr(P, seed, device="cpu")
    for f in jrr.RRState._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("shape,lo,hi", [
    ((64,), 0, 8), ((7, 5), 0, 3), ((100,), 0, 1_000_000),
    ((3, 4, 5), 2, 2**20 + 7), ((33,), 0, 1)])
def test_randint_matches_jax(shape, lo, hi):
    for seed in (0, 11, 2**31 - 1):
        want = jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi,
                                  dtype=jnp.int32)
        got = prng.randint(prng.PRNGKey(seed, "cpu"), shape, lo, hi)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_rr_per_request_wave_matches():
    rng = np.random.default_rng(4)
    P, m, R = 8, 8, 64
    js, ts = jrr.init_rr(P, 3), trr.init_rr(P, 3, device="cpu")
    route = jax.jit(functools.partial(jrr.route_rr_per_request, m=m))
    for _ in range(5):
        proxy = rng.integers(0, P, R).astype(np.int32)
        mask = rng.random(R) < 0.7
        js, ja = route(js, jnp.asarray(proxy), jnp.asarray(mask))
        ts, ta = trr.route_rr_per_request(ts, torch.as_tensor(proxy),
                                          torch.as_tensor(mask), m)
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        np.testing.assert_array_equal(np.asarray(js.rr_count),
                                      ts.rr_count.numpy())


def test_baselines_launch_no_kernel_and_draw_their_shapes():
    from repro_torch.core import policies

    cfg = tsim.SimConfig(m=8, N=512, P=5)
    keys = prng.split(prng.PRNGKey(1, "cpu"), 6).reshape(2, 3, 2)
    shapes = {"uniform": (2, 3, 7), "jsq": (2, 3, 7, 8),
              "rr_request": (2, 3, 7)}
    for name, shape in shapes.items():
        (draw,) = policies.get(name).wave_draws(keys, cfg, 7)
        assert tuple(draw.shape) == shape, name
    for name in ("round_robin", "chbl"):
        assert policies.get(name).wave_draws(keys, cfg, 7) is None
