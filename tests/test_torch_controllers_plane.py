"""The port's other control laws equal the live JAX engine.

``aimd``, ``deadband_pid`` and ``static`` drive midas + cache on the
reference-realized ``bursty`` grid (m=8, N=512): at T=400, and at T=700
across the slow loop (T_slow = 600 ticks) in the ``lease`` and
``ttl_per_key`` cache modes on a write-heavy grid, so ``deadband_pid``'s
slow hook halves ``ttl_scale`` and the TTL cache sees a new knob.
Every ``SimResult`` field, every per-tick output and every leaf of the
final state must be bit for bit the reference's.  The host-side
helpers (``trajectory_stats``, ``make_signals``, the Lyapunov
functions) and the ``control.py`` shim are held against theirs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import control as jcontrol  # noqa: E402
from repro.core import controllers as jctrl  # noqa: E402
from repro.core import make_workload as jmake  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro.core import simulate as jsimulate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import control as tcontrol  # noqa: E402
from repro_torch.core import controllers as tctrl  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402

FIELDS = ("queue_timeline", "arrivals", "lat_pred", "d_timeline",
          "delta_l_timeline", "f_max_timeline", "pressure", "steered",
          "eligible", "cache_hits")
LAWS = ("aimd", "deadband_pid", "static")
WL = jmake("bursty", T=400, m=8, seed=3, N=512)
# writes at half the offered load: the slow loop's write mix is > 0.3
WL_WRITES = jmake("bursty", T=700, m=8, seed=3, N=512, write_frac=0.5)


def _port_workload(wl):
    return convert.workload_from_numpy(
        np.asarray(wl.keys), np.asarray(wl.mask), np.asarray(wl.is_write),
        wl.N, device="cpu")


def assert_results_match(want, got):
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert w.dtype == g.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def assert_trees_match(want, got):
    wl, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(want))
    gl = jax.tree_util.tree_leaves(got)
    assert len(wl) == len(gl)
    for (path, w), g in zip(wl, gl):
        name = jax.tree_util.keystr(path)
        w, g = np.asarray(w), g.numpy()
        if w.dtype == np.uint32:  # threefry keys
            w = w.astype(np.int64)
        assert w.dtype == g.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("law", LAWS)
def test_control_law_matches_live_reference(law):
    kw = dict(m=8, N=512, policy="midas", middleware=("cache",),
              controller=law)
    want = jsimulate(JConfig(**kw), WL, do_warmup=False)
    got = tsim.simulate(tsim.SimConfig(**kw), _port_workload(WL),
                        do_warmup=False, device="cpu")
    assert_results_match(want, got)
    d = set(got.d_timeline.tolist())
    assert d == {2} if law == "static" else len(d) > 1  # knobs move


@pytest.mark.parametrize("mode", ("lease", "ttl_per_key"))
@pytest.mark.parametrize("law", LAWS)
def test_control_law_across_the_slow_loop(law, mode):
    kw = dict(m=8, N=512, policy="midas", middleware=("cache",),
              controller=law, cache_mode=mode)
    jcfg, tcfg = JConfig(**kw), tsim.SimConfig(**kw)
    k, m, w = (np.array(x) for x in (WL_WRITES.keys, WL_WRITES.mask,
                                     WL_WRITES.is_write))
    jfinal, jout = jsim._run_scan(jcfg, jsim.init_state(jcfg, 0.15, 500.0),
                                  k, m, w)
    tfinal, tout = tsim.run_ticks(
        tcfg, tsim.init_state(tcfg, 0.15, 500.0, device="cpu"),
        *(torch.as_tensor(x) for x in (k, m, w)))
    assert_trees_match(jout, tout)
    assert_trees_match(jfinal, tfinal)
    scale = float(tfinal.ctrl.knobs.ttl_scale)
    assert scale == (0.5 if law == "deadband_pid" else 1.0)


def test_trajectory_stats_match():
    rng = np.random.default_rng(0)
    for T in (1, 2, 50, 400):
        d = rng.integers(1, 5, T)
        dl = rng.choice([2.0, 3.0, 4.0], T).astype(np.float32)
        fm = rng.choice([0.1, 0.2, 0.4], T).astype(np.float32)
        pr = np.maximum(rng.normal(0, 1, T), 0).astype(np.float32)
        for args in ((d, dl, fm, pr), (np.full(T, 2), dl * 0 + 4,
                                       fm * 0 + 0.1, pr * 0)):
            want = jctrl.trajectory_stats(*args, 50.0)
            got = tctrl.trajectory_stats(*args, 50.0)
            assert want == got


def test_make_signals_and_lyapunov_helpers():
    rng = np.random.default_rng(1)
    for m in (1, 8, 64):
        L = (rng.random(m) * 20).astype(np.float32)
        js = jctrl.make_signals(B=0.3, p99=120.0, L_hat=jnp.asarray(L),
                                write_mix=0.25, jitter=-0.5, rtt_ms=3.0)
        ts = tctrl.make_signals(B=0.3, p99=120.0, L_hat=torch.as_tensor(L),
                                write_mix=0.25, jitter=-0.5, rtt_ms=3.0)
        for f in jctrl.Signals._fields:
            w, g = getattr(js, f), getattr(ts, f)
            if f == "rtt_ms":
                assert w == g
                continue
            w, g = np.asarray(w), g.numpy()
            assert w.dtype == g.dtype and w.shape == g.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        want = jax.jit(jctrl.lyapunov_potential)(L)
        assert tctrl.lyapunov_potential(torch.as_tensor(L)).numpy() == want
        p, j = 0, m - 1
        assert tctrl.lyapunov_delta_v(torch.as_tensor(L), p, j).numpy() \
            == np.asarray(jctrl.lyapunov_delta_v(L, p, j))
    sig = tctrl.make_signals(device="cpu")
    assert sig.L_hat.shape == (1,) and float(sig.avail) == 1.0


@pytest.mark.parametrize("reducer", ("mean", "median", "max"))
def test_consensus_view_matches(reducer):
    rng = np.random.default_rng(2)
    for P in (1, 4, 7, 8):
        v = (rng.random((P, 8)) * 9).astype(np.float32)
        np.testing.assert_array_equal(
            tcontrol.consensus_view(torch.as_tensor(v), reducer).numpy(),
            np.asarray(jcontrol.consensus_view(jnp.asarray(v), reducer)))
    with pytest.raises(ValueError, match="available: mean, median, max"):
        tctrl.consensus_view(torch.zeros(2, 3), "min")


def test_control_shim_fast_update_matches():
    rng = np.random.default_rng(3)
    js = jcontrol.init_control(2.0, b_tgt=0.12, p99_tgt=300.0)
    ts = tcontrol.init_control(2.0, b_tgt=0.12, p99_tgt=300.0,
                               device="cpu")
    step = jax.jit(jcontrol.fast_update, static_argnums=3)
    moves = 0
    for i in range(200):
        B = np.float32(rng.random() * 0.5)
        p99 = np.float32(rng.random() * 700)
        jit = np.float32(rng.uniform(-1, 1))
        d0 = int(ts.d)
        js = step(js, B, p99, 2.0, jit)
        ts = tcontrol.fast_update(ts, B, p99, 2.0, jit)
        for f in jcontrol.ControlState._fields:
            w, g = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
            assert w.dtype == g.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f"step {i} {f}")
        moves += int(ts.d) != d0
        assert float(tcontrol.pressure_score(torch.tensor(B),
                                             torch.tensor(p99), ts)) \
            == float(jcontrol.pressure_score(B, p99, js))
    assert moves > 0
    assert (tcontrol.H_UP, tcontrol.K_UP, tcontrol.D_INIT) == (
        jcontrol.H_UP, jcontrol.K_UP, jcontrol.D_INIT)
