"""The port's combinators, scenarios, adversary and trace replay against
the reference's.

* The combinators are bit for bit on the reference's realized grids:
  ``mix`` and ``scale_rate`` draw ``uniform(PRNGKey(seed))``, which the
  port's threefry reproduces.
* A scenario is its combinators over registered components.  Built from
  the reference's realized components (``WorkloadParams.make`` patched
  to convert them), the port's scenario is the reference's bit for bit.
  Realized by the port alone, its arrival counts are ``torch.poisson``
  draws: they are held statistically (the mean count a tick within 5
  standard errors plus 2% of the reference's, over several seeds), and
  ``multi_tenant``, which boosts nothing, has the reference's keys
  wherever both grids fill a slot.
* ``adversary`` and ``trace`` are host-side numpy and bit for bit:
  ``random_params``, ``perturb``, ``to_events``, the ``save_trace`` →
  ``load_trace`` round trip, ``rebucket`` and ``trace_replay`` against
  the checked-in ``.npz``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import make_workload as jmake  # noqa: E402
from repro.core import workloads as jw  # noqa: E402
from repro.core.workloads import adversary as jadv  # noqa: E402
from repro.core.workloads import trace as jtrace  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import workloads as tw  # noqa: E402
from repro_torch.core.workloads import adversary as tadv  # noqa: E402
from repro_torch.core.workloads import base as tbase  # noqa: E402
from repro_torch.core.workloads import trace as ttrace  # noqa: E402

SCENARIOS = ("job_startup", "rename_storm", "flash_crowd", "multi_tenant")


def _port(wl):
    return convert.workload_from_numpy(
        np.asarray(wl.keys), np.asarray(wl.mask), np.asarray(wl.is_write),
        wl.N, device="cpu", name=wl.name)


def _assert_same(want, got):
    for f in ("keys", "mask", "is_write"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.shape == g.shape, f
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f)
    assert want.N == got.N


A = jmake("bursty", T=300, m=8, seed=3, N=512)
B = jmake("skewed", T=300, m=8, seed=4, N=512, write_frac=0.3)


@pytest.mark.parametrize("p,seed", [(0.0, 0), (0.3, 1), (0.7, 9), (1.0, 2)])
def test_mix_bitwise(p, seed):
    _assert_same(jw.mix(A, B, p, seed=seed),
                 tw.mix(_port(A), _port(B), p, seed=seed))
    # the selection partitions the slots: both orders carry a + b
    ab = tw.mix(_port(A), _port(B), p, seed=seed)
    ba = tw.mix(_port(B), _port(A), p, seed=seed)
    total = np.asarray(A.mask).sum() + np.asarray(B.mask).sum()
    assert int(ab.mask.sum() + ba.mask.sum()) == total
    assert ab.name == jw.mix(A, B, p, seed=seed).name


@pytest.mark.parametrize("factor", (0.0, 0.35, 1.0, 1.3, 2.8, 3.0, 40.0))
def test_scale_rate_bitwise(factor):
    want = jw.scale_rate(A, factor, seed=5)
    got = tw.scale_rate(_port(A), factor, seed=5)
    _assert_same(want, got)
    assert got.name == want.name


def test_concat_and_shift_hotset_bitwise():
    _assert_same(jw.concat(A, B), tw.concat(_port(A), _port(B)))
    for off in (0, 1, 171, 511, 1025):
        _assert_same(jw.shift_hotset(A, off), tw.shift_hotset(_port(A), off))


def test_combinators_refuse_mismatched_grids():
    narrow = jmake("light", T=300, m=4, seed=0, N=512)
    with pytest.raises(ValueError, match="slot widths differ"):
        tw.mix(_port(A), _port(narrow), 0.5)
    other_n = jmake("bursty", T=300, m=8, seed=3, N=256)
    with pytest.raises(ValueError, match="namespace sizes differ"):
        tw.concat(_port(A), _port(other_n))
    with pytest.raises(ValueError, match="factor must be >= 0"):
        tw.scale_rate(_port(A), -1.0)


def _from_reference_components(monkeypatch):
    """Patch the port's ``WorkloadParams.make`` to hand the scenario the
    reference's realized component (same params, same seed)."""
    def make(self, name, **over):
        kw = dict(T=self.T, m=self.m, seed=self.seed, dt_ms=self.dt_ms,
                  service_ms=self.service_ms, N=self.N, R=self.R,
                  write_frac=self.write_frac)
        kw.update(over)
        return _port(jmake(name, **kw))
    monkeypatch.setattr(tbase.WorkloadParams, "make", make)


@pytest.mark.parametrize("T,seed,N", [(400, 3, 512), (97, 0, 4096),
                                      (3, 1, 512), (1200, 2, 10**6)])
@pytest.mark.parametrize("name", SCENARIOS + ("adversarial",))
def test_scenario_from_reference_components_bitwise(monkeypatch, name, T,
                                                    seed, N):
    kw = dict(T=T, m=8, seed=seed, N=N)
    want = jmake(name, **kw)
    _from_reference_components(monkeypatch)
    got = tw.make_workload(name, device="cpu", **kw)
    _assert_same(want, got)
    assert got.name == name and got.keys.shape[0] == T


@pytest.mark.parametrize("name", SCENARIOS + ("adversarial",))
def test_scenario_counts_match_statistically(name):
    for seed in (0, 1, 2):
        kw = dict(T=1200, m=8, seed=seed, N=4096)
        jc = np.asarray(jmake(name, **kw).mask).sum(1).astype(np.float64)
        got = tw.make_workload(name, device="cpu", **kw)
        tc = got.mask.numpy().sum(1).astype(np.float64)
        assert got.keys.shape == (1200, 24)
        # both are samples of one law: compare their means
        se = np.sqrt((jc.var() + tc.var()) / jc.size)
        assert abs(jc.mean() - tc.mean()) < 5 * se + 0.02 * jc.mean(), \
            (name, seed, jc.mean(), tc.mean())
        keys = got.keys.numpy()
        assert keys.min() >= 0 and keys.max() < 4096


def test_multi_tenant_keys_where_both_grids_fill():
    kw = dict(T=600, m=8, seed=4, N=4096)
    want = jmake("multi_tenant", **kw)
    got = tw.make_workload("multi_tenant", device="cpu", **kw)
    both = np.asarray(want.mask) & got.mask.numpy()
    assert both.sum() > 1000
    np.testing.assert_array_equal(got.keys.numpy()[both],
                                  np.asarray(want.keys)[both])
    np.testing.assert_array_equal(got.is_write.numpy()[both],
                                  np.asarray(want.is_write)[both])


def test_adversary_params_draws_bitwise():
    assert tadv.BOUNDS == jadv.BOUNDS
    for seed in range(5):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        p, q = tadv.random_params(r1), jadv.random_params(r2)
        assert dataclasses.asdict(p) == dataclasses.asdict(q)
        for scale in (0.05, 0.2, 3.0):  # 3.0 clips at the box
            p, q = tadv.perturb(p, r1, scale), jadv.perturb(q, r2, scale)
            assert dataclasses.asdict(p) == dataclasses.asdict(q)
            np.testing.assert_array_equal(p.to_vector(), q.to_vector())
    assert dataclasses.asdict(tadv.AdversaryParams(period=1e4).clipped()) \
        == dataclasses.asdict(jadv.AdversaryParams(period=1e4).clipped())
    with pytest.raises(ValueError, match="available: period"):
        tw.make_workload("adversarial", T=4, m=8, device="cpu", width=3)


@pytest.mark.parametrize("dt_ms", (50.0, 20.0))
def test_to_events_and_save_load_round_trip(tmp_path, dt_ms):
    wl = jmake("adversarial", T=400, m=8, seed=1, N=512, period=40.0)
    want = jadv.to_events(wl, dt_ms)
    got = tadv.to_events(_port(wl), dt_ms)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    path = tmp_path / "worst.npz"
    tadv.save_trace(path, _port(wl), dt_ms)
    for w, g in zip(jtrace.load_trace(path), ttrace.load_trace(path)):
        np.testing.assert_array_equal(g, w)
    # the replay reproduces each tick's event multiset
    keys, mask, _ = ttrace.rebucket(*ttrace.load_trace(path), T=400, R=24,
                                    N=512, dt_ms=dt_ms, loop=False)
    src = np.asarray(wl.keys)
    for t in range(0, 400, 37):
        np.testing.assert_array_equal(
            np.sort(keys[t][mask[t]]),
            np.sort(src[t][np.asarray(wl.mask)[t]]))


def test_synthetic_events_are_the_checked_in_trace():
    want = jtrace.synthetic_events()
    for w, g, f in zip(want, ttrace.synthetic_events(),
                       ttrace.load_trace(ttrace.DEFAULT_TRACE)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(f, w)
    assert ttrace.DEFAULT_TRACE == jtrace.DEFAULT_TRACE


@pytest.mark.parametrize("T,R,N,dt_ms,loop", [
    (400, 24, 512, 50.0, True), (400, 24, 512, 50.0, False),
    (1500, 8, 97, 20.0, True), (50, 300, 4096, 100.0, True)])
def test_rebucket_bitwise(T, R, N, dt_ms, loop):
    ev = jtrace.load_trace(jtrace.DEFAULT_TRACE)
    want = jtrace.rebucket(*ev, T=T, R=R, N=N, dt_ms=dt_ms, loop=loop)
    got = ttrace.rebucket(*ev, T=T, R=R, N=N, dt_ms=dt_ms, loop=loop)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    empty = ttrace.rebucket(np.zeros(0), np.zeros(0, np.int64),
                            np.zeros(0, bool), T=4, R=3, N=8, dt_ms=dt_ms)
    assert not empty[1].any()


@pytest.mark.parametrize("trace", (None, "tests/data/redteam_worst.npz"))
def test_trace_replay_bitwise(trace):
    kw = dict(T=900, m=8, seed=0, N=1024)
    if trace is not None:
        kw.update(trace=trace, loop=False)
    want = jmake("trace_replay", **kw)
    got = tw.make_workload("trace_replay", device="cpu", **kw)
    _assert_same(want, got)
    assert got.name == "trace_replay" and got.mask.any()


def test_trace_replay_falls_back_to_synthetic_events(monkeypatch, tmp_path):
    kw = dict(T=500, m=8, seed=0, N=512)
    want = tw.make_workload("trace_replay", device="cpu", **kw)
    monkeypatch.setattr(ttrace, "DEFAULT_TRACE", tmp_path / "absent.npz")
    got = tw.make_workload("trace_replay", device="cpu", **kw)
    _assert_same(_port(jmake("trace_replay", **kw)), got)
    _assert_same(want, got)
    with pytest.raises(FileNotFoundError, match="not found"):
        tw.make_workload("trace_replay", device="cpu",
                         trace=tmp_path / "nope.npz", **kw)
