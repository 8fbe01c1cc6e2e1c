"""The §IV-E ablations and the oscillation guard in the port equal the
live JAX engine.

Each ablation alone and ``"no_margin,no_pin,no_bucket"`` together run
midas + cache on the reference-realized ``bursty`` grid (T=400, m=8,
N=512): they drive the routing with knob values the hysteresis path
never sends (Δ_L = 0 and Δ_t = −1e9, a pin of 0 ms, f_max = 1).  The
guard runs on and off on the red-team trace (``trace_replay`` of
``tests/data/redteam_worst.npz``, T=1200, m=8, N=1024, with the warmup
targets, as ``tests/test_redteam.py`` runs it).  That trace no longer
makes the hysteresis controller flip 8 times in a slow window under
the installed jax (7 flips a minute, the reason its budget test fails
in the reference too), so the guard does not trip there and on equals
off; the trip is exercised on the ``adversarial`` grid, realized by the
reference and by the port, where both packages freeze the knobs.  Every
``SimResult`` field is held bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import make_workload as jmake  # noqa: E402
from repro.core import simulate as jsimulate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import controllers as tctrl  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core import workloads as tworkloads  # noqa: E402

FIELDS = ("queue_timeline", "arrivals", "lat_pred", "d_timeline",
          "delta_l_timeline", "f_max_timeline", "pressure", "steered",
          "eligible", "cache_hits")
WL = jmake("bursty", T=400, m=8, seed=3, N=512)
T, M, N = 1200, 8, 1024


def _port_workload(wl):
    return convert.workload_from_numpy(
        np.asarray(wl.keys), np.asarray(wl.mask), np.asarray(wl.is_write),
        wl.N, device="cpu")


def _assert_results_match(want, got):
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert w.dtype == g.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("ablate", ("no_margin", "no_pin", "no_bucket",
                                    "no_fault_signal",
                                    "no_margin,no_pin,no_bucket"))
def test_ablation_matches_live_reference(ablate):
    kw = dict(m=8, N=512, policy="midas", middleware=("cache",),
              ablate=ablate)
    want = jsimulate(JConfig(**kw), WL, do_warmup=False)
    got = tsim.simulate(tsim.SimConfig(**kw), _port_workload(WL),
                        do_warmup=False, device="cpu")
    _assert_results_match(want, got)
    base = tsim.simulate(tsim.SimConfig(m=8, N=512, policy="midas",
                                        middleware=("cache",)),
                         _port_workload(WL), do_warmup=False, device="cpu")
    if ablate == "no_fault_signal":  # no fault, so nothing to hide
        _assert_results_match(base, got)
    elif ablate == "no_bucket":  # the bucket does not bind on this grid
        assert got.steered.sum() >= base.steered.sum()
    else:  # the mechanism's removal shows in what is steered
        assert got.steered.sum() > base.steered.sum()


def test_ablated_view_masks_only_the_view():
    cfg = tsim.SimConfig(m=8, N=512)
    ctrl = tctrl.wrap_ablations(tctrl.get("hysteresis"),
                                "no_margin,no_pin,no_bucket")
    assert ctrl.name == "hysteresis[no_margin,no_pin,no_bucket]"
    st = ctrl.init(cfg, (0.15, 500.0), "cpu")
    v = ctrl.view(st)
    assert (float(v.delta_l), float(v.delta_t), float(v.pin_ms),
            float(v.f_max)) == (0.0, -1e9, 0.0, 1.0)
    assert float(st.knobs.delta_l) == tctrl.DELTA_L_INIT  # stored: intact
    static = tctrl.get("static")
    assert tctrl.wrap_ablations(static, "") is static


def _guarded_run(grid, guard, light):
    """The reference's run with warmup against the port's, the port's
    warmup on the reference's realized ``light`` grid and its horizon in
    slow windows, counting the guard's trips (a window that ends frozen
    for HOLD_WINDOWS tripped)."""
    kw = dict(m=M, N=N, policy="midas", controller="hysteresis",
              guard=guard)
    want = jsimulate(JConfig(**kw), grid, do_warmup=True)
    cfg = tsim.SimConfig(**kw)
    st = tsim.init_state(cfg, *tsim.warmup(cfg, device="cpu", wl=light),
                         device="cpu")
    wl, S = _port_workload(grid), cfg.t_slow_ticks
    outs, trips = [], 0
    for lo in range(0, T, S):
        st, out = tsim.run_ticks(cfg, st, wl.keys[lo:lo + S],
                                 wl.mask[lo:lo + S],
                                 wl.is_write[lo:lo + S], t0=lo)
        outs.append(out)
        trips += guard and int(st.ctrl.inner.frozen) == tctrl.HOLD_WINDOWS
    outs = tsim.TickOut(*(torch.cat(f) for f in zip(*outs)))
    got = tsim._to_result(cfg, outs, None)
    _assert_results_match(want, got)
    return want, got, trips


def _reference_workload(wl):
    """A port-realized grid as the reference's ``Workload``."""
    from repro.core.workloads import Workload as JWorkload

    return JWorkload(keys=jnp.asarray(wl.keys.numpy()),
                     mask=jnp.asarray(wl.mask.numpy()),
                     is_write=jnp.asarray(wl.is_write.numpy()),
                     name=wl.name, N=wl.N)


@pytest.mark.parametrize("grid", ("redteam", "adversarial",
                                  "adversarial_port"))
def test_guard_on_and_off_match_live_reference(grid):
    light = _port_workload(jmake("light", T=1200, m=M, seed=99, N=N))
    if grid == "redteam":
        wl = jmake("trace_replay", T=T, m=M, seed=0, N=N,
                   trace="tests/data/redteam_worst.npz", loop=False)
    elif grid == "adversarial":
        wl = jmake("adversarial", T=T, m=M, seed=0, N=N)
    else:  # the same spec realized by the port (its own Poisson counts)
        wl = _reference_workload(tworkloads.make_workload(
            "adversarial", T=T, m=M, seed=0, N=N, device="cpu"))
    won, on, trips = _guarded_run(wl, True, light)
    woff, off, _ = _guarded_run(wl, False, light)
    tripped = not np.array_equal(won.d_timeline, woff.d_timeline)
    assert tripped == (trips > 0)  # the port trips where the reference does
    if grid != "redteam":
        assert trips > 0
        stats = [tctrl.trajectory_stats(r.d_timeline, r.delta_l_timeline,
                                        r.f_max_timeline, r.pressure, 50.0)
                 for r in (on, off)]
        assert stats[0]["oscillation_per_min"] < \
            stats[1]["oscillation_per_min"]
    else:
        assert trips == 0  # this trace lost its bite (module docstring)


def test_guard_name_and_identity():
    ctrl = tctrl.get("hysteresis")
    assert tctrl.wrap_guard(ctrl, False) is ctrl
    g = tctrl.wrap_guard(ctrl, True)
    assert g.name == "hysteresis+guard"
    st = g.init(tsim.SimConfig(m=M, N=N), (0.15, 500.0), "cpu")
    assert int(g.view(st).d) == tctrl.D_INIT
    assert int(st.inner.frozen) == 0 and int(st.inner.hold_d) == 2
    with pytest.raises(ValueError, match="guard"):
        tsim.SimConfig(guard="yes")
