"""A tick of routing: the port's plain wave loop equals the live JAX
engine's ``_route_waves_scan`` under midas, power_of_d and chbl, on one
view and on fleet routing's per-wave views, and the CUDA
``route_tick``'s wrapper checks its inputs and refuses CPU tensors and
unknown modes.

The plain loop (``core/sim.py:_route_waves`` with the plain impl) is
``route_tick``'s plain version: it is what runs on the CPU, and what the
kernel is held against on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py`` phase 2).  The inputs are made with numpy and hold keys
repeated within a wave and across waves, live and expired pins, a budget
that binds and a history ring shorter than the tick, so it wraps; for
chbl also loads that sit exactly on its cap.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import hashring as jring  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro.core.controllers.base import Knobs as JKnobs  # noqa: E402
from repro.core.policies import bounded_load as jbl  # noqa: E402
from repro.core.policies import midas as jmidas  # noqa: E402
from repro.core.policies import power_of_d as jpod  # noqa: E402
from repro_torch.core import policies as tpol  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core.controllers.base import Knobs  # noqa: E402
from repro_torch.core.policies import midas as tmidas  # noqa: E402
from repro_torch.core.policies.base import (  # noqa: E402
    RouteContext,
    WaveDraws,
    steering_dv_waves,
)
from repro_torch.kernels.midas_route import kernel, ops  # noqa: E402

M, N, D_MAX, G, RG, W = 16, 2048, 4, 4, 24, 3
NOW, PIN_MS = 1000.0, 300.0


def _recording(cls):
    """The reference's policy ``cls``, logging each wave's assignment in
    its carried state (the scan returns no per-wave output)."""

    class Recording(cls):
        def route(self, state, ctx):
            ms, log, g = state
            ms, assign, st = super().route(ms, ctx)
            return (ms, log.at[g].set(assign), g + 1), assign, st

    return Recording


_Recording = _recording(jmidas.Midas)
JPOLICIES = {"midas": jmidas.Midas, "power_of_d": jpod.PowerOfD,
             "chbl": jbl.BoundedLoadHash}


def _tick_inputs(seed, f_max, pool):
    rng = np.random.default_rng(seed)
    keypool = rng.choice(N, pool, replace=False)
    keys = keypool[rng.integers(0, pool, (G, RG))].astype(np.int32)
    mask = rng.random((G, RG)) < 0.85
    feas = np.asarray(jring.feasible_set(jring.make_ring(M, 16),
                                         jnp.asarray(keys), D_MAX))
    pin_server = np.full(N, -1, np.int32)
    pin_expiry = np.zeros(N, np.float32)
    pin_server[keypool] = rng.integers(-1, M, pool)
    # expiry before, at and after the tick clock: live and expired pins
    pin_expiry[keypool] = NOW + rng.integers(-2, 3, pool) * 100.0
    steer = rng.integers(0, 4, W).astype(np.float32)
    state = dict(
        pin_server=pin_server,
        pin_expiry=pin_expiry,
        steer_hist=steer,
        elig_hist=steer + rng.integers(0, 3, W).astype(np.float32),
        hist_idx=np.int32(rng.integers(0, 2 * W)),
    )
    L_hat = np.round(rng.random(M) * 6, 1).astype(np.float32)
    L_hat[rng.integers(0, M, 3)] += 25.0  # hot servers: many steers
    p50 = (rng.random(M) * 300).astype(np.float32)
    knobs = dict(d=np.int32(3), delta_l=np.float32(1.0),
                 delta_t=np.float32(-1e9), f_max=np.float32(f_max),
                 pin_ms=np.float32(PIN_MS), ttl_scale=np.float32(1.0))
    return keys, mask, feas, state, L_hat, p50, knobs


def _port_tick(seed, f_max, pool, r_route, name="midas", inputs=None,
               views=None):
    keys, mask, feas, state, L_hat, p50, knobs = inputs or _tick_inputs(
        seed, f_max, pool)
    cfg = tsim.SimConfig(m=M, N=N, d_max=D_MAX, n_groups=G, policy=name)
    policy = tpol.get(name)
    t = torch.as_tensor
    waves = prng.fold_in(t(np.array(r_route)).long()[None, :],
                         torch.arange(G))
    st = tsim.init_state(cfg, device="cpu")._replace(
        L_hat=t(L_hat), p50_hat=t(p50),
        policy=tmidas.MidasState(**{k: t(v) for k, v in state.items()})
        if name == "midas" else ())
    consts = tsim._Consts(torch.zeros(()), torch.ones(()), torch.ones(M))
    ps, tick = tsim._route_waves(
        cfg, policy, st, Knobs(**{k: t(v) for k, v in knobs.items()}),
        torch.tensor(NOW), t(keys).long(), t(mask), t(feas),
        policy.wave_draws(waves, cfg, RG), "ref", consts,
        None if views is None else t(views))
    return ps, tick, (t(keys).long(), t(mask), t(feas), t(L_hat))


@pytest.mark.parametrize("f_max,pool", [(0.3, 6), (0.3, 60), (1.0, 60)])
def test_plain_tick_matches_reference_scan(f_max, pool):
    seed = 3 + pool
    keys, mask, feas, state, L_hat, p50, knobs = _tick_inputs(
        seed, f_max, pool)
    r_route = jax.random.PRNGKey(seed)
    jcfg = JConfig(m=M, N=N, d_max=D_MAX, n_groups=G)
    jst = jsim.init_state(jcfg, 0.15, 500.0)._replace(
        L_hat=jnp.asarray(L_hat), p50_hat=jnp.asarray(p50),
        policy=(jmidas.MidasState(**{k: jnp.asarray(v)
                                     for k, v in state.items()}),
                jnp.zeros((G, RG), jnp.int32), 0))
    (jms, jlog, _), jarr, jstats = jsim._route_waves_scan(
        jcfg, jring.make_ring(M, 16), _Recording(), jst,
        JKnobs(**{k: jnp.asarray(v) for k, v in knobs.items()}), 0,
        jnp.float32(NOW), r_route, jnp.asarray(keys), jnp.asarray(mask),
        jnp.asarray(feas))
    ps, tick, _ = _port_tick(seed, f_max, pool, r_route)

    np.testing.assert_array_equal(np.asarray(jlog), tick.assign.numpy())
    np.testing.assert_array_equal(np.asarray(jarr), tick.arrivals.numpy())
    for f in ("steered", "eligible", "dV"):
        w, g = np.asarray(getattr(jstats, f)), getattr(tick.stats, f)
        assert w.dtype == g.numpy().dtype and w == g.numpy(), f
    for f in jmidas.MidasState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jms, f)),
                                      getattr(ps, f).numpy(), err_msg=f)
    steered, eligible = int(tick.stats.steered), int(tick.stats.eligible)
    assert 0 < steered <= eligible
    if f_max < 1.0:
        assert steered < eligible  # the budget binds
    moved = tick.assign.numpy() != feas[..., 0]
    if pool == 6:  # a key steered twice in a wave: the last steer pins
        assert any(np.unique(keys[g][moved[g] & mask[g]]).size
                   < (moved[g] & mask[g]).sum() for g in range(G))


def _on_the_cap(L, idx, cap):
    """``L`` with the servers ``idx`` on the reference's cap ``cap(L)``
    (a fixed point of L[i] <- cap(L), as ``test_torch_baselines.py``
    builds it)."""
    L = L.copy()
    for _ in range(200):
        c = np.float32(cap(L))
        if (L[list(idx)] == c).all():
            return L
        L[list(idx)] = c
    raise AssertionError("no load vector on the cap found")


# (policy, views): the baselines on one view (the stale view plus the
# tick's earlier sends), every policy on fleet routing's per-wave views,
# and chbl with loads on its cap (the first wave's view, and every
# proxy's own view)
BASELINE_TICKS = [("power_of_d", "one"), ("chbl", "one"),
                  ("power_of_d", "fleet"), ("chbl", "fleet"),
                  ("midas", "fleet"), ("chbl", "on_cap"),
                  ("chbl", "on_cap_fleet")]


@pytest.mark.parametrize("name,views", BASELINE_TICKS)
def test_plain_tick_policies_match_reference_scan(name, views):
    """One tick of power_of_d, chbl and midas through the port's plain
    wave loop against the reference's wave scan: assign, arrivals,
    steered, eligible and dV bit for bit (and midas's state)."""
    seed, f_max, pool = 11 + len(views), 0.3, 60
    keys, mask, feas, state, L_hat, p50, knobs = _tick_inputs(
        seed, f_max, pool)
    rng = np.random.default_rng(seed)
    fleet = views.endswith("fleet")
    L_hat_p = np.round(rng.random((G, M)) * 6, 1).astype(np.float32)
    for g in range(G):  # each proxy sees its own hot servers
        L_hat_p[g, rng.integers(0, M, 3)] += 25.0
    if views.startswith("on_cap"):
        feas = feas.copy()
        cap = jax.jit(lambda L: jbl.C_LOAD * (jnp.mean(L) + 1.0))
        L_hat = _on_the_cap(L_hat, (0, 3), cap)
        L_hat_p = np.stack([_on_the_cap(v, (g, g + 3), cap)
                            for g, v in enumerate(L_hat_p)])
        feas[0, ::2, 0] = 0  # primaries on the cap: under it (<=)
        feas[1:, ::2, 0] = np.arange(1, G)[:, None]
        feas[0, 1::4, 1] = 3  # a successor on the cap
    tick_t = 1  # the proxy of wave g is (g + 1) % G
    r_route = jax.random.PRNGKey(seed)
    jcfg = JConfig(m=M, N=N, d_max=D_MAX, n_groups=G, P=G, policy=name,
                   fleet_routing=fleet)
    jms = (jmidas.MidasState(**{k: jnp.asarray(v) for k, v in state.items()})
           if name == "midas" else ())
    jst = jsim.init_state(jcfg, 0.15, 500.0)._replace(
        L_hat=jnp.asarray(L_hat), p50_hat=jnp.asarray(p50),
        L_hat_p=jnp.asarray(L_hat_p),
        policy=(jms, jnp.zeros((G, RG), jnp.int32), 0))
    (jps, jlog, _), jarr, jstats = jsim._route_waves_scan(
        jcfg, jring.make_ring(M, 16), _recording(JPOLICIES[name])(), jst,
        JKnobs(**{k: jnp.asarray(v) for k, v in knobs.items()}), tick_t,
        jnp.float32(NOW), r_route, jnp.asarray(keys), jnp.asarray(mask),
        jnp.asarray(feas))
    wave_views = L_hat_p[(np.arange(G) + tick_t) % G] if fleet else None
    ps, tick, _ = _port_tick(seed, f_max, pool, r_route, name,
                             (keys, mask, feas, state, L_hat, p50, knobs),
                             wave_views)

    np.testing.assert_array_equal(np.asarray(jlog), tick.assign.numpy())
    np.testing.assert_array_equal(np.asarray(jarr), tick.arrivals.numpy())
    for f in ("steered", "eligible", "dV"):
        w, g = np.asarray(getattr(jstats, f)), getattr(tick.stats, f)
        assert w.dtype == g.numpy().dtype, f
        assert w.tobytes() == g.numpy().tobytes(), f
    for f in getattr(jps, "_fields", ()):
        np.testing.assert_array_equal(np.asarray(getattr(jps, f)),
                                      getattr(ps, f).numpy(), err_msg=f)
    assert float(tick.stats.dV) != 0.0
    assert (float(tick.stats.steered) > 0) == (name != "power_of_d")
    if views.startswith("on_cap"):
        assign, m0 = tick.assign.numpy(), mask
        assert L_hat[0] == L_hat[3] == np.float32(cap(L_hat))
        # wave 0 routes on L_hat (no earlier sends), fleet wave g on its
        # proxy's view: a primary on the cap keeps its requests
        for g in range(G if fleet else 1):
            kept = assign[g, ::2][m0[g, ::2]]
            assert (kept == feas[g, ::2, 0][m0[g, ::2]]).all(), g


@pytest.mark.parametrize("f_max,pool", [(0.3, 6), (1.0, 60)])
def test_tick_dv_from_views_equals_the_waves(f_max, pool):
    """``steering_dv_waves`` on the per-wave views and assignments (the
    plain expression that ``route_tick``'s dV is held against on the
    card) equals the plain loop's dV, bit for bit."""
    ps, tick, (keys, mask, feas, L_hat) = _port_tick(
        5, f_max, pool, jax.random.PRNGKey(5))
    counts = torch.zeros((G, M))
    for g in range(G):
        counts[g] = tsim._wave_counts(M, mask[g], tick.assign[g])
    views = L_hat + (torch.cumsum(counts, 0) - counts)
    ctx = RouteContext(keys=keys, mask=mask, feas=feas, L_view=L_hat,
                       p50_view=None, knobs=None, now_ms=None, draws=None,
                       m=M, fixed_d=2)
    dv = steering_dv_waves(ctx, views, tick.assign)
    assert float(tick.stats.dV) != 0.0
    assert dv.dtype == tick.stats.dV.dtype and torch.equal(dv,
                                                           tick.stats.dV)


def _cpu_args(G_=2, Rg=8, m=8, d_max=4, n=64, w=3):
    rng = np.random.default_rng(0)
    t = torch.as_tensor
    args = [
        t(rng.integers(0, n, (G_, Rg))).long(),
        t(rng.random((G_, Rg)) < 0.9),
        t(rng.integers(0, m, (G_, Rg, d_max))).int(),
        t(rng.integers(0, d_max, (G_, Rg, d_max))).to(torch.int8),
        t(rng.random((G_, Rg, d_max))).float(),
        torch.zeros(m), torch.zeros(m),
        torch.full((n,), -1, dtype=torch.int32), torch.zeros(n),
        torch.zeros(w), torch.zeros(w),
        torch.zeros((), dtype=torch.int32),
    ]
    knobs = dict(d=torch.tensor(2, dtype=torch.int32),
                 delta_l=torch.tensor(1.0), delta_t=torch.tensor(0.0),
                 f_max=torch.tensor(0.3), pin_ms=torch.tensor(300.0),
                 now_ms=torch.tensor(50.0))
    return args, knobs


def test_route_tick_on_cpu_tensors_raises():
    args, knobs = _cpu_args()
    fleet = list(args)  # fleet routing's (G, m) per-wave views
    fleet[5] = args[5].expand(args[0].shape[0], -1).contiguous()
    before = kernel.route_tick.launches
    for fn in (kernel.route_tick, ops.route_tick):
        for a in (args, fleet):
            with pytest.raises(ValueError, match="CUDA device"):
                fn(*a, **knobs)
            # the baselines read the waves, the view and (power_of_d) d
            with pytest.raises(ValueError, match="CUDA device"):
                fn(*a[:6], d=knobs["d"], mode="power_of_d")
            with pytest.raises(ValueError, match="CUDA device"):
                fn(None, a[1], a[2], None, None, a[5], mode="chbl")
    assert kernel.route_tick.launches == before


def _bad(name):
    """Arguments with one fault, named by ``name``."""
    if name == "m":
        args, knobs = _cpu_args(m=kernel.MAX_M + 1)
    elif name == "d_max":
        args, knobs = _cpu_args(d_max=kernel.MAX_D + 1)
    elif name == "Rg":
        args, knobs = _cpu_args(G_=1, Rg=kernel.MAX_RG + 1)
    else:
        args, knobs = _cpu_args()
    if name == "keys dtype":
        args[0] = args[0].int()
    elif name == "mask shape":
        args[1] = args[1][:, :-1]
    elif name == "tie contiguous":
        args[4] = args[4].transpose(0, 1).contiguous().transpose(0, 1)
    elif name == "feas rank":
        args[2] = args[2][0]
    elif name == "knob shape":
        knobs["f_max"] = knobs["f_max"].reshape(1)
    elif name == "d dtype":
        knobs["d"] = knobs["d"].float()
    elif name == "window":
        args[9], args[10] = torch.zeros(0), torch.zeros(0)
    elif name == "fleet views shape":  # (G, m) views, one row short
        args[5] = args[5].expand(args[0].shape[0] - 1, -1).contiguous()
    elif name == "mode":
        knobs["mode"] = "jsq"
    elif name == "power_of_d without d":
        args, knobs = args[:6], dict(mode="power_of_d")
    return args, knobs


@pytest.mark.parametrize("name,match", [
    ("m", "m must be"), ("d_max", "d_max must be"), ("Rg", "Rg must be"),
    ("keys dtype", "keys has dtype"), ("mask shape", "mask has shape"),
    ("tie contiguous", "tie must be contiguous"), ("feas rank", "feas must"),
    ("knob shape", "f_max has shape"), ("d dtype", "d has dtype"),
    ("window", "window"), ("fleet views shape", "L_hat has shape"),
    ("mode", "unknown route mode"), ("power_of_d without d", "needs d"),
])
def test_route_tick_checks_its_inputs_before_any_launch(name, match):
    args, knobs = _bad(name)
    before = kernel.route_tick.launches
    with pytest.raises(ValueError, match=match):
        kernel.route_tick(*args, **knobs)
    assert kernel.route_tick.launches == before


def test_only_midas_has_a_tick_kernel():
    """midas, power_of_d and chbl route a tick through the route_tick
    kernel (so on CPU tensors they refuse, and the engine runs their
    waves one at a time); the policies without a kernel have none."""
    args, _ = _cpu_args()
    ctx = RouteContext(keys=args[0], mask=args[1], feas=args[2],
                       L_view=args[5], p50_view=args[6], knobs=None,
                       now_ms=None, draws=WaveDraws(args[3], args[4]),
                       m=8, fixed_d=torch.tensor(2, dtype=torch.int32))
    for name in ("power_of_d", "chbl"):
        with pytest.raises(ValueError, match="CUDA device"):
            tpol.get(name).route_tick((), ctx)
    for name in ("hash", "round_robin", "jsq", "uniform"):
        assert tpol.get(name).route_tick((), ctx) is None
