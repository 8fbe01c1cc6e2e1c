"""The port's faulted engine against the live JAX engine.

Both engines get the reference's realized grids; every ``SimResult``
field (``pressure`` included) and the final cache or fleet state are
compared bit for bit, leaf by leaf.  The configurations: each of the
five fault kinds alone at ``tests/test_core_faults.py``'s sizes (m = 8,
N = 512, T = 160); a gossip partition under ``fleet_cache`` with fleet
routing on and off; E13's three compound programs retimed to a 300-tick
burst, alone and together; a crash under ``power_of_d``,
``round_robin``, ``chbl``, the ``static`` controller and the
``no_fault_signal`` ablation; a crash at m = 64 and at m = 72 (the
survivors-only imbalance above 32 servers).  Each reference run is
made once per module.  Zero cost when off (``()`` and a benign event
equal ``None``) and the flip-only remap invalidation (equal to one
made every tick, as the reference makes it) are held in the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import make_workload as jmake  # noqa: E402
from repro.core import simulate as jsimulate  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core.faults import FaultEvent  # noqa: E402

FIELDS = ("queue_timeline", "arrivals", "lat_pred", "d_timeline",
          "delta_l_timeline", "f_max_timeline", "pressure", "steered",
          "eligible", "cache_hits")

GRIDS = {
    "golden": dict(T=160, m=8, N=512),
    "burst": dict(T=300, m=8, N=512),
    "m64": dict(T=160, m=64, N=4096),
    "m72": dict(T=160, m=72, N=4096),
}

CRASH = (FaultEvent("proxy_crash", t0=40, duration=60, target=0),)
# benchmarks/redteam.py's three programs, retimed as chip_smoke.py's
# phase 12 runs them (every window ends before tick 280)
E13 = {
    "crash_during_storm": faults.overlap(
        FaultEvent("ckpt_storm_fleet", t0=100, duration=150,
                   magnitude=0.6),
        FaultEvent("proxy_crash", t0=120, duration=120, target=0),
    ),
    "rolling_brownout": faults.rolling(
        "server_brownout", targets=(1, 2, 3), t0=100, duration=80,
        stagger=50, magnitude=0.3),
    "cascade_partition": (faults.CascadeEvent(
        trigger=FaultEvent("proxy_crash", t0=120, duration=120, target=0),
        effect=FaultEvent("gossip_partition", t0=0, duration=100,
                          target=-1),
        offset=10),),
}
FLEET = dict(middleware=("fleet_cache",), P=4, gossip_ms=100.0)

CASES = {
    # each kind alone
    "proxy_crash": ("golden", dict(middleware=("cache",), faults=CRASH)),
    "proxy_join": ("golden", dict(middleware=("cache",), faults=(
        FaultEvent("proxy_join", t0=50, target=3),))),
    "server_brownout": ("golden", dict(faults=(
        FaultEvent("server_brownout", t0=40, duration=80, target=1,
                   magnitude=0.25),))),
    "ckpt_storm_fleet": ("golden", dict(middleware=("cache",), faults=(
        FaultEvent("ckpt_storm_fleet", t0=40, duration=40,
                   magnitude=0.5),))),
    "gossip_partition": ("golden", dict(FLEET, faults=(
        FaultEvent("gossip_partition", t0=20, duration=120, target=1),))),
    # the partition with fleet routing, on the burst
    "partition_routing": ("burst", dict(FLEET, fleet_routing=True, faults=(
        FaultEvent("gossip_partition", t0=100, duration=150,
                   target=-1),))),
    # E13's programs, alone and together, under fleet routing
    **{name: ("burst", dict(FLEET, fleet_routing=True, faults=prog))
       for name, prog in E13.items()},
    "e13_together": ("burst", dict(
        FLEET, fleet_routing=True,
        faults=sum(E13.values(), ()))),
    # a crash under the other policies, the static controller, the
    # no_fault_signal ablation, the per-key TTL cache
    "crash_power_of_d": ("burst", dict(policy="power_of_d",
                                       middleware=("cache",),
                                       faults=E13["crash_during_storm"])),
    "crash_round_robin": ("golden", dict(policy="round_robin",
                                         faults=CRASH)),
    "crash_chbl": ("burst", dict(policy="chbl", faults=(
        FaultEvent("proxy_crash", t0=120, duration=120, target=2),))),
    "crash_static": ("burst", dict(controller="static",
                                   middleware=("cache",), faults=(
        FaultEvent("proxy_crash", t0=120, duration=120, target=0),))),
    "crash_no_fault_signal": ("burst", dict(
        ablate="no_fault_signal", middleware=("cache",),
        cache_mode="ttl_per_key", faults=(
            FaultEvent("proxy_crash", t0=120, duration=120, target=0),))),
    # the survivors-only imbalance above 32 servers
    "crash_m64": ("m64", dict(middleware=("cache",), faults=CRASH)),
    "crash_m72": ("m72", dict(middleware=("fleet_cache",), P=8,
                              gossip_ms=100.0, fleet_routing=True,
                              faults=CRASH)),
}


def to_ref(ev):
    if isinstance(ev, faults.CascadeEvent):
        return jfaults.CascadeEvent(trigger=to_ref(ev.trigger),
                                    effect=to_ref(ev.effect),
                                    offset=ev.offset)
    return jfaults.FaultEvent(**dataclasses.asdict(ev))


def _kw(case):
    grid, kw = CASES[case]
    g = GRIDS[grid]
    return grid, dict(dict(m=g["m"], N=g["N"], policy="midas"), **kw)


@pytest.fixture(scope="module")
def grids():
    """The reference's realized grids, made once."""
    out = {}
    for name, g in GRIDS.items():
        out[name] = jmake("bursty", T=g["T"], m=g["m"], seed=3, N=g["N"])
    return out


@pytest.fixture(scope="module")
def reference(grids):
    """The live JAX engine's run of each case, made once, on demand."""
    runs = {}

    def run(case):
        if case not in runs:
            grid, kw = _kw(case)
            jkw = dict(kw, faults=tuple(map(to_ref, kw["faults"])))
            runs[case] = jsimulate(JConfig(**jkw), grids[grid],
                                   do_warmup=False)
        return runs[case]

    return run


def _port_workload(wl):
    return convert.workload_from_numpy(
        np.asarray(wl.keys), np.asarray(wl.mask), np.asarray(wl.is_write),
        wl.N, device="cpu")


def _port(case, grids, **over):
    grid, kw = _kw(case)
    cfg = tsim.SimConfig(**dict(kw, **over))
    return tsim.simulate(cfg, _port_workload(grids[grid]), do_warmup=False,
                         device="cpu")


def _assert_results_equal(want, got, what):
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert w.shape == g.shape and w.dtype == g.dtype, (what, f)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")
    if want.final_cache is None:
        assert got.final_cache is None
        return
    wl = jax.tree_util.tree_leaves(jax.device_get(want.final_cache))
    gl = jax.tree_util.tree_leaves(got.final_cache)
    assert len(wl) == len(gl), what
    for i, (w, g) in enumerate(zip(wl, gl)):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype, (what, i)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: leaf {i}")


@pytest.mark.parametrize("case", list(CASES))
def test_faulted_engine_matches_live_reference(case, grids, reference):
    got = _port(case, grids)
    _assert_results_equal(reference(case), got, case)
    _, kw = _kw(case)
    fc = faults.compile_faults(tsim.SimConfig(**kw),
                               got.queue_timeline.shape[0])
    assert fc is not None and fc.active.any()
    if fc.has_downtime and fc.has_remap and kw["policy"] != "round_robin":
        # once detected, a dead server gets no arrivals from a policy
        # that routes within the feasible sets; its queue is frozen, as
        # nothing drains it
        dead = ~fc.detected & ~fc.member
        t, s = np.nonzero(dead)
        assert (got.arrivals[t, s] == 0).all()
        nxt = t + 1 < len(got.queue_timeline)
        t, s = t[nxt], s[nxt]
        still = ~fc.member[t + 1, s]
        np.testing.assert_array_equal(got.queue_timeline[t + 1, s][still],
                                      got.queue_timeline[t, s][still])
    if kw.get("middleware") == ("fleet_cache",):
        fl = got.final_cache
        for per, agg in (("hits_p", "hits"), ("misses_p", "misses"),
                         ("stale_p", "stale_serves"),
                         ("bypasses_p", "bypasses")):
            assert int(getattr(fl, per).sum()) == int(getattr(fl, agg))


def test_fault_programs_steer_and_degrade(grids, reference):
    """The burst cases exercise the paths they are meant to: midas steers
    under the compound programs, the install guard bypasses while
    membership is degraded, the storm adds write traffic."""
    got = reference("e13_together")  # the port's run equals it
    assert got.steered.sum() > 0
    assert int(got.final_cache.bypasses) > 0
    base = tsim.simulate(
        tsim.SimConfig(**dict(_kw("e13_together")[1], faults=None)),
        _port_workload(grids["burst"]), do_warmup=False, device="cpu")
    assert got.arrivals.sum() + got.cache_hits.sum() > \
        base.arrivals.sum() + base.cache_hits.sum()


@pytest.mark.parametrize("case", ["gossip_partition"])
def test_zero_cost_when_off(case, grids):
    """``faults=()`` and a benign event (one past the horizon, one a
    brownout at magnitude 1) equal ``faults=None`` bit for bit, final
    state included."""
    base = _port(case, grids, faults=None)
    for off in ((), (FaultEvent("proxy_crash", t0=10_000, target=0),),
                (FaultEvent("server_brownout", t0=40, duration=60,
                            target=1, magnitude=1.0),)):
        got = _port(case, grids, faults=off)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(base, f), err_msg=f)
        for x, y in zip(jax.tree_util.tree_leaves(base.final_cache),
                        jax.tree_util.tree_leaves(got.final_cache)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["proxy_crash", "crash_m72"])
def test_flip_only_invalidation_equals_every_tick_diff(case, grids,
                                                       monkeypatch):
    """The engine diffs the epoch owner tables only on the host-known
    flip ticks; the reference diffs them every tick.  Invalidating on
    every tick (all-False masks off a flip) gives the same run."""
    flip_only = _port(case, grids)
    moved_at = []
    real_moved = faults.moved_mask

    def spy(fc, fx, t):
        mv = real_moved(fc, fx, t)
        moved_at.append((t, int(mv.sum())))
        return mv

    real_inputs = tsim._scan_inputs

    def every_tick(*a, **k):
        hz = real_inputs(*a, **k)
        return hz._replace(flips=frozenset(range(hz.keys.shape[0])))

    monkeypatch.setattr(faults, "moved_mask", spy)
    monkeypatch.setattr(tsim, "_scan_inputs", every_tick)
    every = _port(case, grids)
    T = flip_only.queue_timeline.shape[0]
    assert len(moved_at) == T
    fc = faults.compile_faults(tsim.SimConfig(**_kw(case)[1]), T)
    assert [t for t, n in moved_at if n] == list(fc.flips)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(every, f),
                                      getattr(flip_only, f), err_msg=f)
    for x, y in zip(jax.tree_util.tree_leaves(every.final_cache),
                    jax.tree_util.tree_leaves(flip_only.final_cache)):
        assert torch.equal(x, y)


def test_faulted_runs_do_not_resume_and_warmup_strips_faults(grids):
    _, kw = _kw("proxy_crash")
    cfg = tsim.SimConfig(**kw)
    wl = _port_workload(grids["golden"])
    st = tsim.init_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="t0=20"):
        tsim.run_ticks(cfg, st, wl.keys[20:], wl.mask[20:],
                       wl.is_write[20:], t0=20)
    light = tsim.make_workload("light", T=200, m=8, N=512, seed=5,
                               device="cpu")
    assert tsim.warmup(cfg, device="cpu", wl=light) == tsim.warmup(
        dataclasses.replace(cfg, faults=None), device="cpu", wl=light)
    # the unrolled engine (item 7) runs the faulted config, bitwise
    unrolled = tsim.simulate(dataclasses.replace(cfg, unroll_waves=True),
                             wl, do_warmup=False, device="cpu")
    hoisted = tsim.simulate(cfg, wl, do_warmup=False, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(unrolled, f),
                                      getattr(hoisted, f), err_msg=f)
