"""The port's fault layer against the reference's (``repro.core.faults``).

Unit by unit: the registry, validation and ``parse_fault`` case for case
as ``tests/test_core_faults.py``; the compiled schedules array for array
against the reference's for every kind, E13's three compound programs,
a sequence and a cascade; detection against the reference's and the
host failure detector; the member-aware feasible sets and the subring
helpers bitwise; ``imbalance_masked`` and the storm overlay bitwise the
jitted reference; the cache's and the fleet's remap invalidation, the
availability install guard and gossip partitions step by step beside
the jitted reference.  Random inputs come from seeded numpy generators.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import fleet as jfleet  # noqa: E402
from repro.core import hashring as jring  # noqa: E402
from repro.core import telemetry as jtelemetry  # noqa: E402
from repro.ft.failures import FailureDetector  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core import hashring as tring  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core import telemetry as ttelemetry  # noqa: E402
from repro_torch.core.faults import FaultEvent  # noqa: E402

KINDS = ("proxy_crash", "proxy_join", "server_brownout", "gossip_partition",
         "ckpt_storm_fleet")


def _cfg(**kw):
    kw.setdefault("m", 8)
    kw.setdefault("N", 512)
    kw.setdefault("policy", "midas")
    return tsim.SimConfig(**kw)


def to_ref(ev):
    """The reference's event for a port event (plain or cascade)."""
    if isinstance(ev, faults.CascadeEvent):
        return jfaults.CascadeEvent(trigger=to_ref(ev.trigger),
                                    effect=to_ref(ev.effect),
                                    offset=ev.offset)
    return jfaults.FaultEvent(**dataclasses.asdict(ev))


# ---------------------------------------------------------------------------
# Registry and validation, case for case as the reference's tests
# ---------------------------------------------------------------------------


def test_registry_lists_builtin_kinds():
    assert faults.available() == jfaults.available()
    for kind in KINDS:
        assert kind in faults.available()


def test_unknown_kind_lists_alternatives():
    with pytest.raises(ValueError, match="proxy_crash"):
        faults.get_class("power_cut")
    with pytest.raises(ValueError, match="available"):
        _cfg(faults=("power_cut",))


def test_config_validation_errors():
    with pytest.raises(ValueError, match="tuple"):
        _cfg(faults="proxy_crash")  # a bare string is a bug, not a list
    with pytest.raises(ValueError, match="target"):
        _cfg(faults=(FaultEvent("proxy_crash", target=8),))
    with pytest.raises(ValueError, match="magnitude"):
        _cfg(faults=(FaultEvent("server_brownout", magnitude=0.0),))
    with pytest.raises(ValueError, match="proxy"):
        _cfg(faults=(FaultEvent("gossip_partition", target=99),))
    with pytest.raises(ValueError, match="t0"):
        _cfg(faults=(FaultEvent("proxy_crash", t0=-5),))
    with pytest.raises(ValueError, match="m >= 2"):
        _cfg(m=1, faults=("proxy_join",))
    with pytest.raises(ValueError, match="offset"):
        _cfg(faults=(faults.CascadeEvent(
            FaultEvent("proxy_crash"), FaultEvent("gossip_partition"),
            offset=-1),))
    with pytest.raises(ValueError, match="CascadeEvent"):
        _cfg(faults=(3,))


def test_names_normalize_to_default_events():
    cfg = _cfg(faults=["server_brownout"])
    assert cfg.faults == (FaultEvent("server_brownout"),)
    assert cfg.fault_events == cfg.faults
    assert _cfg().fault_events == ()
    assert dataclasses.asdict(FaultEvent("x")) == dataclasses.asdict(
        jfaults.FaultEvent("x"))


def test_parse_fault_cli_specs():
    for spec in ("proxy_crash:t0=200,duration=300,target=2",
                 "ckpt_storm_fleet:magnitude=0.25", "gossip_partition",
                 " server_brownout:t0=5, magnitude=0.5 "):
        got = faults.parse_fault(spec)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jfaults.parse_fault(spec))
    with pytest.raises(ValueError, match="available"):
        faults.parse_fault("nope:t0=1")
    with pytest.raises(ValueError, match="parameter"):
        faults.parse_fault("proxy_crash:frequency=3")
    with pytest.raises(ValueError, match="parameter"):
        faults.parse_fault("proxy_crash:kind=proxy_join")


def test_all_dead_schedule_rejected():
    cfg = _cfg(m=2, faults=(
        FaultEvent("proxy_crash", t0=10, duration=50, target=0),
        FaultEvent("proxy_crash", t0=10, duration=50, target=1),
    ))
    with pytest.raises(ValueError, match="live"):
        faults.compile_faults(cfg, 160)
    wl = tsim.make_workload("bursty", T=80, m=2, N=512, device="cpu")
    with pytest.raises(ValueError, match="live"):
        tsim.simulate(cfg, wl, do_warmup=False, device="cpu")


def test_compile_none_for_empty():
    assert faults.compile_faults(_cfg(), 160) is None
    assert faults.compile_faults(_cfg(faults=()), 160) is None
    assert faults.sequence() == ()


def test_registering_a_kind_and_removing_it():
    @faults.register("test_noop_fault")
    class Noop(faults.FaultSpec):
        def apply(self, ev, sched):
            sched.active[ev.t0] = True

    try:
        fc = faults.compile_faults(_cfg(faults=("test_noop_fault",)), 160)
        assert fc.active.sum() == 1 and not fc.has_remap
    finally:
        faults.unregister("test_noop_fault")
    assert "test_noop_fault" not in faults.available()


# ---------------------------------------------------------------------------
# The compiled schedule, array for array
# ---------------------------------------------------------------------------

E13 = {  # benchmarks/redteam.py's three programs, retimed to T = 160
    "crash_during_storm": faults.overlap(
        FaultEvent("ckpt_storm_fleet", t0=40, duration=80, magnitude=0.6),
        FaultEvent("proxy_crash", t0=50, duration=60, target=0),
    ),
    "rolling_brownout": faults.rolling(
        "server_brownout", targets=(1, 2, 3), t0=40, duration=40,
        stagger=25, magnitude=0.3),
    "cascade_partition": (faults.CascadeEvent(
        trigger=FaultEvent("proxy_crash", t0=40, duration=70, target=0),
        effect=FaultEvent("gossip_partition", t0=0, duration=50,
                          target=-1),
        offset=5),),
}
SCHEDULES = {
    **{kind: (FaultEvent(kind, t0=40, duration=60, target=1,
                         magnitude=0.4),) for kind in KINDS},
    "crash_open_ended": (FaultEvent("proxy_crash", t0=30, duration=0,
                                    target=-1),),
    "benign": (FaultEvent("server_brownout", t0=40, duration=60, target=1,
                          magnitude=1.0),),
    "past_horizon": (FaultEvent("proxy_crash", t0=500, target=2),),
    "sequence": faults.sequence(
        FaultEvent("proxy_crash", duration=20, target=0),
        FaultEvent("proxy_crash", duration=20, target=3),
        FaultEvent("gossip_partition", duration=30, target=2),
        t0=30, stagger=15),
    "two_dead": (FaultEvent("proxy_crash", t0=20, duration=90, target=0),
                 FaultEvent("proxy_crash", t0=30, duration=60, target=5)),
    "names": ("proxy_crash", "ckpt_storm_fleet"),
    **E13,
}


def _both(events, T=160, **kw):
    kw = dict(dict(m=8, N=512, P=4), **kw)
    cfg = tsim.SimConfig(faults=tuple(events), **kw)
    jevents = tuple(e if isinstance(e, str) else to_ref(e) for e in events)
    jcfg = JConfig(faults=jevents, **kw)
    return faults.compile_faults(cfg, T), jfaults.compile_faults(jcfg, T)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_compile_faults_equals_reference(name):
    got, want = _both(SCHEDULES[name])
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        if isinstance(w, np.ndarray):
            assert w.dtype == g.dtype and w.shape == g.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f
    # cached on the fields a schedule depends on: another policy or
    # route impl shares the compile
    assert faults.compile_faults(_cfg(faults=tuple(SCHEDULES[name]), P=4,
                                      policy="chbl", route_impl="ref"),
                                 160) is got
    np.testing.assert_array_equal(
        got.flips, np.flatnonzero(want.epoch != want.epoch_prev))


@pytest.mark.parametrize("m,dt_ms", [(8, 50.0), (64, 50.0), (5, 130.0)])
def test_compile_at_other_sizes(m, dt_ms):
    events = (FaultEvent("proxy_crash", t0=10, duration=40, target=0),
              FaultEvent("proxy_join", t0=25, target=m - 1))
    got, want = _both(events, T=90, m=m, N=3000, dt_ms=dt_ms)
    for f in ("detected", "epoch", "epoch_masks", "owner_by_epoch",
              "avail"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.scan_width == want.scan_width
    assert got.timeout_ticks == want.timeout_ticks


def test_detection_lags_ground_truth():
    cfg = _cfg(faults=(FaultEvent("proxy_crash", t0=40, duration=60,
                                  target=0),))
    fc = faults.compile_faults(cfg, 160)
    K = fc.timeout_ticks
    assert K == faults.detect_ticks(cfg.dt_ms) == 10  # 500ms / 50ms
    assert not fc.member[40:100, 0].any()
    assert fc.detected[40:40 + K, 0].all()
    assert not fc.detected[40 + K:100, 0].any()
    assert fc.detected[100:, 0].all()
    assert fc.has_downtime and fc.has_remap
    assert not (fc.has_brownout or fc.has_partition or fc.has_storm)
    assert fc.epoch_masks.shape[0] == 3
    assert list(fc.flips) == [50, 100]


@pytest.mark.parametrize("K", [1, 3, 10])
def test_detect_available_equals_reference_and_detector(K):
    rng = np.random.default_rng(K)
    for T, m in ((60, 5), (25, 1), (40, 9)):
        member = rng.random((T, m)) > 0.3
        got = faults.detect_available(member, K)
        np.testing.assert_array_equal(
            got, jfaults.detect_available(member, K))
        det = FailureDetector(m, timeout_s=float(K), now=-1.0)
        for t in range(T):
            for h in np.flatnonzero(member[t]):
                det.heartbeat(int(h), now=float(t))
            dead = det.failed(now=float(t))
            assert list(got[t]) == [h not in dead for h in range(m)]
    for dt in (1.0, 49.0, 50.0, 130.0, 600.0):
        assert faults.detect_ticks(dt) == jfaults.detect_ticks(dt)


def test_program_schedule_is_elementwise_composition():
    """Membership ANDs, service scales multiply, partitions OR, storm
    intensities max, active ORs."""
    events = faults.overlap(
        FaultEvent("ckpt_storm_fleet", t0=30, duration=60, magnitude=0.5),
        FaultEvent("proxy_crash", t0=40, duration=40, target=0),
        FaultEvent("server_brownout", t0=35, duration=50, target=2,
                   magnitude=0.3),
        FaultEvent("server_brownout", t0=45, duration=50, target=2,
                   magnitude=0.7),
        FaultEvent("gossip_partition", t0=30, duration=30, target=0),
        FaultEvent("ckpt_storm_fleet", t0=50, duration=10, magnitude=0.8),
    )
    prog, _ = _both(events)
    singles = [_both((e,))[0] for e in events]
    np.testing.assert_array_equal(
        prog.member, np.logical_and.reduce([s.member for s in singles]))
    scale = singles[0].service_scale
    for s in singles[1:]:
        scale = scale * s.service_scale
    np.testing.assert_array_equal(prog.service_scale, scale)
    np.testing.assert_array_equal(
        prog.partition,
        np.logical_or.reduce([s.partition for s in singles]))
    np.testing.assert_array_equal(
        prog.storm, np.max([s.storm for s in singles], axis=0))
    np.testing.assert_array_equal(
        prog.active, np.logical_or.reduce([s.active for s in singles]))


def test_overlap_sequence_and_cascade_resolution():
    a = FaultEvent("proxy_crash", t0=20, duration=30, target=0)
    b = FaultEvent("ckpt_storm_fleet", t0=40, duration=40, magnitude=0.5)
    assert faults.overlap(a, b) == (a, b)
    c = FaultEvent("server_brownout", t0=100, duration=20, target=1,
                   magnitude=0.5)
    with pytest.raises(ValueError, match="sequence"):
        faults.overlap(a, c)
    with pytest.raises(ValueError, match="stagger"):
        faults.sequence(a, t0=0, stagger=-1)
    assert faults.sequence(a, b) == (a, b)
    assert [e.t0 for e in faults.sequence(a, b, stagger=7)] == [20, 27]
    roll = faults.rolling("server_brownout", targets=(1, 2, 3), t0=20,
                          duration=30, stagger=25, magnitude=0.3)
    jroll = jfaults.rolling("server_brownout", targets=(1, 2, 3), t0=20,
                            duration=30, stagger=25, magnitude=0.3)
    assert [dataclasses.asdict(e) for e in roll] == \
        [dataclasses.asdict(e) for e in jroll]
    casc = E13["cascade_partition"]
    for kw in (dict(dt_ms=50.0, T=160, m=8, P=4),
               dict(dt_ms=50.0, T=45, m=8, P=4),
               dict(dt_ms=20.0, T=300, m=4, P=2)):
        got = faults.resolve(casc, **kw)
        want = jfaults.resolve(tuple(map(to_ref, casc)), **kw)
        assert [dataclasses.asdict(e) for e in got] == \
            [dataclasses.asdict(e) for e in want]
    for ev in (a, b, c, FaultEvent("proxy_crash", t0=500)):
        assert faults.detection_tick(ev, dt_ms=50.0, T=160, m=8, P=4) == \
            jfaults.detection_tick(to_ref(ev), dt_ms=50.0, T=160, m=8, P=4)


def test_storm_from_pool_calibration():
    class _Pool:
        def __init__(self, b):
            self.b = b

        def backlogs(self):
            return self.b

    for b in ([0, 30, 10, 0], [], [0, 0], [5]):
        ev = faults.storm_from_pool(_Pool(b), t0=5, duration=9)
        want = jfaults.storm_from_pool(_Pool(b), t0=5, duration=9)
        assert dataclasses.asdict(ev) == dataclasses.asdict(want)
    ev = faults.storm_from_pool(_Pool([0, 30, 10, 0]), t0=5, duration=9)
    assert ev.kind == "ckpt_storm_fleet" and ev.magnitude == 0.75


# ---------------------------------------------------------------------------
# Member-aware feasible sets and the subring helpers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_gather(m, d_max, W):
    ring = jring.make_ring(m, 64)
    return jax.jit(lambda k, mk: jring.feasible_set(ring, k, d_max, W, mk))


def _ref_feasible(m, d_max, W, keys, member):
    """The reference's member-aware gather, jitted as the engine runs
    it (the ring a constant)."""
    fn = _ref_gather(m, d_max, W)
    return np.asarray(fn(jnp.asarray(keys, jnp.int32), jnp.asarray(member)))


def _members(rng, m, n):
    """Random live masks: one all-live, one with a single live server,
    then random fractions (at least one live each)."""
    out = [np.ones(m, bool), np.eye(m, dtype=bool)[rng.integers(m)]]
    for _ in range(n):
        mk = rng.random(m) < rng.choice([0.25, 0.5, 0.9])
        mk[rng.integers(m)] = True
        out.append(mk)
    return out


@pytest.mark.parametrize("m", [4, 8, 64])
def test_member_feasible_set_equals_reference(m):
    rng = np.random.default_rng(m)
    tr = tring.make_ring(m, 64, device="cpu")
    keys = rng.integers(0, 1 << 20, (3, 500))
    repeats = 0
    for d_max in (2, 4):
        base = tring.feasible_set(tr, torch.as_tensor(keys), d_max)
        for mk in _members(rng, m, 6):
            live = int(mk.sum())
            W = faults.base._scan_width(m, 64, mk[None])
            want = _ref_feasible(m, d_max, W, keys, mk)
            got = tring.feasible_set(
                tr, torch.as_tensor(keys), d_max, scan_width=W,
                member=torch.as_tensor(mk)).numpy()
            np.testing.assert_array_equal(got, want)
            assert mk[got].all()  # only live servers
            if live < d_max:
                # every row repeats its first live fallback
                assert (np.sort(got, -1)[..., 1:]
                        == np.sort(got, -1)[..., :-1]).any(-1).all()
                repeats += 1
            np.testing.assert_array_equal(
                got[..., 0],
                tring.np_member_primary(m, 64, mk, keys))
            if mk.all():
                np.testing.assert_array_equal(
                    tring.feasible_set(tr, torch.as_tensor(keys), d_max,
                                       member=torch.as_tensor(mk)).numpy(),
                    base.numpy())
    assert repeats > 0


@pytest.mark.parametrize("m", [4, 8, 64])
def test_member_primary_moves_only_remapped_keys(m):
    rng = np.random.default_rng(100 + m)
    keys = np.arange(5000)
    full = tring.np_member_primary(m, 64, np.ones(m, bool), keys)
    np.testing.assert_array_equal(
        full, tring.primary(tring.make_ring(m, 64, device="cpu"),
                            torch.as_tensor(keys)).numpy())
    for mk in _members(rng, m, 5):
        got = tring.np_member_primary(m, 64, mk, keys)
        np.testing.assert_array_equal(
            got, jring.np_member_primary(m, 64, mk, keys))
        # a key moves only when its owner died
        moved = got != full
        assert (~mk[full[moved]]).all()
        assert (got[mk[full]] == full[mk[full]]).all()
    with pytest.raises(ValueError, match="no live"):
        tring.np_member_primary(m, 64, np.zeros(m, bool), keys)
    with pytest.raises(ValueError, match="shape"):
        tring.np_member_primary(m, 64, np.ones(m + 1, bool), keys)


@pytest.mark.parametrize("m,n_shards", [(8, 4), (64, 16), (5, 3)])
def test_subring_family_equals_reference(m, n_shards):
    keys = np.random.default_rng(m).integers(0, 1 << 30, 4000)
    np.testing.assert_array_equal(tring.np_key_position(keys),
                                  jring.np_key_position(keys))
    shard = tring.np_key_shard(keys, n_shards)
    np.testing.assert_array_equal(shard,
                                  jring.np_key_shard(keys, n_shards))
    full = tring.feasible_set(tring.make_ring(m, 64, device="cpu"),
                              torch.as_tensor(keys), 4).numpy()
    for s in range(n_shards):
        sub = tring.np_subring(m, 64, s, n_shards)
        jsub = jring.np_subring(m, 64, s, n_shards)
        for f in sub._fields:
            np.testing.assert_array_equal(getattr(sub, f),
                                          getattr(jsub, f))
        ks = keys[shard == s]
        np.testing.assert_array_equal(tring.np_subring_primary(sub, ks),
                                      jring.np_subring_primary(jsub, ks))
        np.testing.assert_array_equal(tring.np_subring_primary(sub, ks),
                                      full[shard == s, 0])
        for d_max, W in ((4, 16), (2, 9)):
            got = tring.np_subring_feasible(sub, ks, d_max, W)
            np.testing.assert_array_equal(
                got, jring.np_subring_feasible(jsub, ks, d_max, W))
        np.testing.assert_array_equal(
            tring.np_subring_feasible(sub, ks, 4), full[shard == s])
    with pytest.raises(ValueError, match="arc"):
        tring.np_subring_primary(tring.np_subring(m, 64, 0, n_shards),
                                 keys[shard != 0][:3])
    with pytest.raises(ValueError, match="tail"):
        tring.np_subring_feasible(
            tring.np_subring(m, 64, 0, n_shards, tail=4), keys[:0], 4)
    with pytest.raises(ValueError, match="shard"):
        tring.np_subring(m, 64, n_shards, n_shards)


# ---------------------------------------------------------------------------
# imbalance_masked and the storm overlay, bitwise the jitted reference
# ---------------------------------------------------------------------------

_IMB = jax.jit(jtelemetry.imbalance_masked)


@pytest.mark.parametrize("lo,hi", [(1, 13), (13, 33), (33, 49), (49, 73)])
def test_imbalance_masked_equals_jitted_reference(lo, hi):
    rng = np.random.default_rng(lo)
    for m in range(lo, hi):
        for trial in range(12):
            L = (rng.random(m) * rng.choice([1.0, 10.0, 300.0])).astype(
                np.float32)
            if trial % 3 == 0:
                L = np.round(L, 1).astype(np.float32)
            live = rng.random(m) < rng.choice([1.0, 0.9, 0.5, 0.1])
            if trial == 0:
                live[:] = True
            if trial == 1:
                live[:] = False
            want = np.asarray(_IMB(jnp.asarray(L), jnp.asarray(live)))
            got = ttelemetry.imbalance_masked(torch.as_tensor(L),
                                              torch.as_tensor(live))
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"m={m} trial {trial}")


@pytest.mark.parametrize("R", [37, 100, 512])
def test_apply_traffic_equals_jitted_reference(R):
    T = 30
    events = (FaultEvent("ckpt_storm_fleet", t0=5, duration=10,
                         magnitude=0.3),
              FaultEvent("ckpt_storm_fleet", t0=12, duration=10,
                         magnitude=0.77))
    fc, jfc = _both(events, T=T)
    rng = np.random.default_rng(R)
    keys = rng.integers(0, 512, (T, R)).astype(np.int32)
    mask = np.arange(R)[None, :] < rng.integers(0, R, (T, 1))
    is_write = rng.random((T, R)) < 0.2
    step = jax.jit(lambda k, m, w: jfaults.apply_traffic(jfc, k, m, w))
    want = step(jnp.asarray(keys), jnp.asarray(mask), jnp.asarray(is_write))
    got = faults.apply_traffic(fc, torch.as_tensor(keys).long(),
                               torch.as_tensor(mask),
                               torch.as_tensor(is_write))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].numpy() != mask).any()
    quiet, _ = _both((FaultEvent("proxy_crash", t0=5),), T=T)
    same = faults.apply_traffic(quiet, *got)
    assert all(a is b for a, b in zip(same, got))


# ---------------------------------------------------------------------------
# Remap invalidation, the install guard and partitions, step by step
# ---------------------------------------------------------------------------


def _assert_trees_equal(want, got, what=""):
    wl = jax.tree_util.tree_leaves(jax.device_get(want))
    gl = jax.tree_util.tree_leaves(got)
    assert len(wl) == len(gl), what
    for i, (w, g) in enumerate(zip(wl, gl)):
        w, g = np.asarray(w), g.cpu().numpy()
        assert w.dtype == g.dtype, (what, i)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")


def _tensors(tree):
    return jax.tree_util.tree_map(
        lambda x: torch.as_tensor(np.array(x)), jax.device_get(tree))


_LOOKUP_BATCH = jax.jit(jcache.lookup_batch, static_argnames=(
    "mode", "lease_ms", "rtt_ms", "p_star"))
_LOOKUP_FLEET = jax.jit(jfleet.lookup_fleet, static_argnames=(
    "mode", "lease_ms", "rtt_ms", "p_star", "gossip_ms"))


def test_remap_invalidate_shared_cache():
    N = 64
    j = jcache.init_cache(N)._replace(
        expiry_ms=jnp.full((N,), 1e9, jnp.float32),
        cached_version=jnp.zeros((N,), jnp.int32))
    t = _tensors(j)
    moved = np.arange(N) % 3 == 0
    j = jax.jit(jcache.remap_invalidate)(j, jnp.asarray(moved))
    t2 = tcache.remap_invalidate(t, torch.as_tensor(moved))
    assert t2.expiry_ms is t.expiry_ms  # in place
    _assert_trees_equal(j, t2, "remap")
    keys = np.arange(N, dtype=np.int32)
    ones = np.ones(N, bool)
    jn, jh = _LOOKUP_BATCH(j, jnp.asarray(keys), jnp.asarray(ones),
                           jnp.asarray(~ones), jnp.asarray(50.0))
    tn, th = tcache.lookup_batch(t2, torch.as_tensor(keys).long(),
                                 torch.as_tensor(ones),
                                 torch.as_tensor(~ones), torch.tensor(50.0))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    _assert_trees_equal(jn, tn, "after lookup")
    assert not th.numpy()[moved].any() and th.numpy()[~moved].all()


@pytest.mark.parametrize("P", [1, 2, 8])
def test_remap_invalidate_fleet_no_stale_owner(P):
    """No proxy, whatever lagged snapshot its gossip view selects,
    serves an owner-changed entry without revalidation."""
    N, D = 32, 4
    rng = np.random.default_rng(P)
    for trial in range(8):
        j = jfleet.init_fleet(N, P, D)
        j = j._replace(
            shared=j.shared._replace(
                expiry_ms=jnp.full((N,), 1e9, jnp.float32),
                cached_version=jnp.zeros((N,), jnp.int32)),
            lag_expiry=jnp.full((D, N), 1e9, jnp.float32),
            tick=jnp.asarray(int(rng.integers(0, 11)), jnp.int32))
        t = _tensors(j)
        moved = rng.random(N) < 0.4
        j = jax.jit(jfleet.remap_invalidate)(j, jnp.asarray(moved))
        t = tfleet.remap_invalidate(t, torch.as_tensor(moved))
        _assert_trees_equal(j, t, f"remap {trial}")
        keys = np.arange(N, dtype=np.int32)
        ones = np.ones(N, bool)
        proxy = np.array(jfleet.proxy_assign(N, P, j.tick))
        jn, jh = _LOOKUP_FLEET(j, jnp.asarray(keys), jnp.asarray(ones),
                               jnp.asarray(~ones), jnp.asarray(proxy),
                               jnp.asarray(50.0), gossip_ms=100.0)
        tn, th = tfleet.lookup_fleet(
            t, torch.as_tensor(keys), torch.as_tensor(ones),
            torch.as_tensor(~ones), torch.as_tensor(proxy),
            torch.tensor(50.0), gossip_ms=100.0)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        _assert_trees_equal(jn, tn, f"lookup {trial}")
        assert not th.numpy()[moved].any() and th.numpy()[~moved].all()


@pytest.mark.parametrize("avail", [0.875, 1.0, 0.999999])
def test_install_guard_under_degraded_avail(avail):
    N = 16
    keys = np.arange(N, dtype=np.int32)
    ones = np.ones(N, bool)
    a = np.float32(avail)
    j, jh = _LOOKUP_BATCH(jcache.init_cache(N), jnp.asarray(keys),
                          jnp.asarray(ones), jnp.asarray(~ones),
                          jnp.asarray(10.0), avail=jnp.asarray(a))
    t, th = tcache.lookup_batch(
        tcache.init_cache(N, device="cpu"), torch.as_tensor(keys).long(),
        torch.as_tensor(ones), torch.as_tensor(~ones), torch.tensor(10.0),
        avail=torch.tensor(a))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    _assert_trees_equal(j, t, "guard")
    degraded = a < np.float32(faults.AVAIL_FULL)
    assert int(t.bypasses) == (N if degraded else 0)


class _FleetPair:
    """A reference fleet and a port fleet driven with the same ticks."""

    def __init__(self, N, P, gossip_ms, mode="lease"):
        D = jfleet.delay_ticks(gossip_ms, 50.0)
        self.j = jfleet.init_fleet(N, P, D)
        self.t = tfleet.init_fleet(N, P, D, device="cpu")
        self.kw = dict(mode=mode, lease_ms=700.0, gossip_ms=gossip_ms)

    def step(self, keys, proxy, writes, mask, part=None, avail=None,
             moved=None):
        if moved is not None:
            self.j = jax.jit(jfleet.remap_invalidate)(
                self.j, jnp.asarray(moved))
            self.t = tfleet.remap_invalidate(self.t, torch.as_tensor(moved))
        now = np.float32(int(self.j.tick) * 50.0)
        jx = dict(partitioned=None if part is None else jnp.asarray(part),
                  avail=None if avail is None else jnp.asarray(avail))
        tx = dict(partitioned=None if part is None else
                  torch.as_tensor(part),
                  avail=None if avail is None else torch.tensor(avail))
        self.j, jh = _LOOKUP_FLEET(
            self.j, jnp.asarray(keys, jnp.int32), jnp.asarray(mask),
            jnp.asarray(writes), jnp.asarray(proxy, jnp.int32),
            jnp.asarray(now), **jx, **self.kw)
        self.t, th = tfleet.lookup_fleet(
            self.t, torch.as_tensor(keys), torch.as_tensor(mask),
            torch.as_tensor(writes), torch.as_tensor(proxy, dtype=torch.int32),
            torch.tensor(now), **tx, **self.kw)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        _assert_trees_equal(self.j, self.t, f"tick {int(self.j.tick)}")
        return th.numpy()


@pytest.mark.parametrize("mode,gossip_ms,P", [
    ("lease", 100.0, 4), ("lease", 400.0, 3), ("ttl_per_key", 150.0, 2),
    ("ttl_aggregate", 100.0, 5)])
def test_fleet_partition_avail_and_remap_step_by_step(mode, gossip_ms, P):
    """Random ticks over few keys with partitions, degraded
    availability and remap invalidations in some ticks: every leaf of
    the state after every step."""
    N = 12
    rng = np.random.default_rng(P)
    f = _FleetPair(N, P, gossip_ms, mode)
    stale = 0
    for t in range(40):
        R = 30
        part = rng.random(P) < 0.5 if t % 3 else None
        avail = (np.float32(rng.choice([1.0, 0.75])) if t % 4 == 1
                 else None)
        moved = rng.random(N) < 0.3 if t % 7 == 3 else None
        f.step(rng.integers(0, N, R), rng.integers(0, P, R),
               rng.random(R) < 0.2, rng.random(R) < 0.9, part, avail,
               moved)
        stale = int(f.t.stale_serves)
    assert int(f.t.bypasses) > 0
    if mode == "lease":
        assert stale > 0


def test_partitioned_proxy_reads_its_lagged_view():
    """A partitioned proxy never takes the fresh entry for a remote
    event: with a lag ring that disagrees with the converged table
    (entries live there, dropped in every snapshot), the partitioned
    proxy misses where the others hit, in the port as in the
    reference."""
    N, P, D = 8, 2, 2
    j = jfleet.init_fleet(N, P, D)
    j = j._replace(
        shared=j.shared._replace(
            expiry_ms=jnp.full((N,), 1e9, jnp.float32),
            cached_version=jnp.zeros((N,), jnp.int32)),
        last_event_ms=jnp.zeros((N,), jnp.float32),
        last_origin=jnp.zeros((N,), jnp.int32),
        tick=jnp.asarray(5, jnp.int32))
    t = _tensors(j)
    keys = np.arange(N, dtype=np.int32)
    proxy = (np.arange(N) % P).astype(np.int32)
    ones = np.ones(N, bool)
    cut = np.array([False, True])
    args = (jnp.asarray(keys), jnp.asarray(ones), jnp.asarray(~ones),
            jnp.asarray(proxy), jnp.asarray(np.float32(250.0)))
    targs = (torch.as_tensor(keys), torch.as_tensor(ones),
             torch.as_tensor(~ones), torch.as_tensor(proxy),
             torch.tensor(250.0))
    for part in (None, cut):
        jn, jh = _LOOKUP_FLEET(
            j, *args, gossip_ms=100.0,
            partitioned=None if part is None else jnp.asarray(part))
        tn, th = tfleet.lookup_fleet(
            _tensors(j), *targs, gossip_ms=100.0,
            partitioned=None if part is None else torch.as_tensor(part))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        _assert_trees_equal(jn, tn, f"partition {part}")
        want = proxy == 0 if part is not None else np.ones(N, bool)
        np.testing.assert_array_equal(th.numpy(), want)
    assert t.tick.item() == 5
