"""The summary metrics (``metrics="summary"``) against the live JAX
reference: the histogram sketch, the per-tick fold and ``summarize``.

``HistSketch``'s edges, bins and counts are held bit for bit against
the reference's, on zeros, values on an edge and beside it, below
``HIST_LO`` and at or above ``HIST_HI``; its quantiles too.  The fold
(``_summary_update``) is held tick by tick against the reference's,
jitted inside a scan as its engine runs it, at m = 4, 8, 33, 64 and 100
(both sides of XLA's 32-element sum windows): every accumulator after
every tick, and each tick's CV alone.  ``summarize`` and the
``SummaryResult``/``SimResult`` metric API are held on the same
timelines.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import registry as jregistry  # noqa: E402
from repro.core import sim as jsim  # noqa: E402
from repro.core import telemetry as jtel  # noqa: E402
from repro_torch.core import SimConfig, make_workload  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402

MS = (4, 8, 33, 64, 100)
T = 120
_HIST_ADD = jax.jit(jtel.hist_add)


def _edges32():
    return np.asarray(jnp.asarray(jtel._hist_edges()))


def _hist_values(case):
    e = _edges32()
    rng = np.random.default_rng(7)
    if case == "edges":
        v = np.concatenate([e, np.nextafter(e, np.float32(np.inf)),
                            np.nextafter(e, np.float32(0))])
    elif case == "out_of_range":
        v = np.array([0.0, -0.0, 1e-9, 1e-3, 9.99e-3, 1e-2, 1e6, 1.5e6,
                      1e9, np.inf, 3.0e38], np.float64)
    elif case == "queues":  # queue lengths: zeros and half-steps
        v = rng.integers(0, 400, 3000) * 0.5 * (rng.random(3000) < 0.7)
    else:  # latencies in ms, over the whole range
        v = rng.gamma(0.4, 2000.0, 5000)
    v = np.asarray(v, np.float32)
    w = rng.integers(0, 9, v.shape).astype(np.float32)
    return v, w


@pytest.mark.parametrize("case", ["edges", "out_of_range", "queues",
                                  "latencies"])
def test_hist_add_matches_reference(case):
    v, w = _hist_values(case)
    want = _HIST_ADD(jtel.make_hist(), jnp.asarray(v), jnp.asarray(w))
    got = ttel.hist_add(ttel.make_hist("cpu"), torch.from_numpy(v),
                        torch.from_numpy(w))
    assert got.counts.dtype == torch.float32
    assert got.counts.shape == (ttel.HIST_BINS + 2,)
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    # ones, as the queue sketch adds them
    ones = np.ones_like(w)
    want = _HIST_ADD(jtel.make_hist(), jnp.asarray(v), jnp.asarray(ones))
    got = ttel.hist_add(ttel.make_hist("cpu"), torch.from_numpy(v),
                        torch.from_numpy(ones))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))


def test_hist_edges_and_bins_take_jnps_steps():
    """The device edges are the float64 grid rounded to float32, strictly
    increasing; the upper bound ``torch.searchsorted(right=True)`` finds
    the bin jnp's fixed-step bisection (side "right") finds, at every
    edge and beside it."""
    e = _edges32()
    assert ttel._edges_on(torch.device("cpu")).numpy().tobytes() == \
        e.tobytes()
    np.testing.assert_array_equal(ttel._hist_edges(), jtel._hist_edges())
    assert (np.diff(e) > 0).all()
    v = np.concatenate([_hist_values("edges")[0],
                        _hist_values("out_of_range")[0]])
    n = e.size
    low, high = np.zeros(v.shape, np.int64), np.full(v.shape, n, np.int64)
    for _ in range(int(np.ceil(np.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = v < e[np.minimum(mid, n - 1)]
        low, high = np.where(go_left, low, mid), np.where(go_left, mid,
                                                          high)
    got = torch.searchsorted(torch.from_numpy(e.copy()),
                             torch.from_numpy(v), right=True).numpy()
    np.testing.assert_array_equal(got, high)
    np.testing.assert_array_equal(
        got, np.asarray(jnp.searchsorted(jnp.asarray(e), jnp.asarray(v),
                                         side="right")))


def test_hist_scatter_is_exact_in_any_order():
    """Integer weights below 2**24 sum exactly in any order, so the
    card's atomic adds give the counts a sequential scatter gives."""
    v, w = _hist_values("latencies")
    base = ttel.hist_add(ttel.make_hist("cpu"), torch.from_numpy(v),
                         torch.from_numpy(w)).counts
    for seed in range(3):
        p = np.random.default_rng(seed).permutation(v.size)
        got = ttel.hist_add(ttel.make_hist("cpu"), torch.from_numpy(v[p]),
                            torch.from_numpy(w[p])).counts
        assert torch.equal(got, base)
    exact = np.zeros(ttel.HIST_BINS + 2, np.float64)
    np.add.at(exact, np.searchsorted(_edges32(), v, side="right"), w)
    np.testing.assert_array_equal(base.numpy(), exact)


@pytest.mark.parametrize("q", [0.0, 1.0, 50.0, 99.0, 99.9, 100.0])
def test_hist_quantile_matches_reference(q):
    for case in ("queues", "latencies", "out_of_range"):
        v, w = _hist_values(case)
        counts = ttel.hist_add(ttel.make_hist("cpu"), torch.from_numpy(v),
                               torch.from_numpy(w)).counts.numpy()
        assert ttel.hist_quantile(counts, q) == jtel.hist_quantile(counts,
                                                                   q)
    zero = np.zeros(ttel.HIST_BINS + 2, np.float32)
    assert ttel.hist_quantile(zero, q) == jtel.hist_quantile(zero, q) == 0.0


def _timelines(m, seed=0):
    """(T, m) queue, arrival and latency timelines with the cases the CV
    meets: all-zero ticks, one busy server, half-steps, large queues."""
    rng = np.random.default_rng(seed + m)
    L = (rng.integers(0, 2000, (T, m)) * 0.5
         * (rng.random((T, m)) < 0.8)).astype(np.float32)
    L[:6] = 0.0
    L[6] = 0.0
    L[6, m // 2] = 3.5
    L[7:9] = rng.random((2, m)).astype(np.float32) * 1e-3
    arr = rng.integers(0, 40, (T, m)).astype(np.float32)
    lat = ((L + arr) * 100.0).astype(np.float32)
    sc = rng.integers(0, 50, (3, T)).astype(np.float32)
    return L, arr, lat, sc


def _tickouts(m, seed=0):
    L, arr, lat, (steered, eligible, hits) = _timelines(m, seed)
    z = np.zeros((T,), np.float32)
    return dict(L=L, arrivals=arr, lat_pred=lat,
                d=np.zeros((T,), np.int32), delta_l=z, f_max=z,
                pressure=z, steered=steered, eligible=eligible,
                cache_hits=hits, dV=z)


@functools.partial(jax.jit, static_argnums=0)
def _ref_fold(m, outs):
    """The reference's fold in a scan, as its engine runs it: the
    accumulators after every tick, and each tick's CV alone (the update
    of an empty accumulator)."""
    init = jsim._summary_init(m)

    def step(acc, out):
        new = jsim._summary_update(acc, out)
        return new, (new, jsim._summary_update(init, out).cv_sum)

    return jax.lax.scan(step, init, outs)[1]


def _leaves(acc):
    return [x.counts if hasattr(x, "counts") else x for x in acc]


@pytest.mark.parametrize("m", MS)
def test_summary_update_tick_by_tick(m):
    arrays = _tickouts(m)
    jouts = jsim.TickOut(**{k: jnp.asarray(v) for k, v in arrays.items()})
    running, cvs = jax.device_get(_ref_fold(m, jouts))
    acc = tsim._summary_init(m, "cpu")
    zero = tsim._summary_init(m, "cpu")
    names = tsim.SummaryAcc._fields
    for t in range(T):
        out = tsim.TickOut(**{k: torch.from_numpy(np.array(v[t]))
                              for k, v in arrays.items()})
        acc = tsim._summary_update(acc, out)
        one = tsim._summary_update(zero, out)
        assert one.cv_sum.numpy().tobytes() == \
            np.asarray(cvs[t]).tobytes(), (m, t)
        for f, w, g in zip(names, _leaves(running), _leaves(acc)):
            w = np.asarray(w)[t]
            assert g.dtype == torch.from_numpy(np.array(w)).dtype, f
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"m={m} t={t} {f}")
    assert float(acc.cv_count) > 0 and float(acc.cv_count) < T


def _results(m, f_max=True):
    L, arr, lat, (steered, eligible, hits) = _timelines(m, seed=1)
    rng = np.random.default_rng(m)
    common = dict(
        queue_timeline=L, arrivals=arr, lat_pred=lat,
        d_timeline=rng.integers(1, 5, T).astype(np.int32),
        delta_l_timeline=rng.random(T).astype(np.float32),
        pressure=rng.random(T).astype(np.float32),
        steered=steered, eligible=eligible, cache_hits=hits,
        final_cache=None,
        f_max_timeline=rng.random(T).astype(np.float32) if f_max else None)
    return (jsim.SimResult(config=JConfig(m=m), **common),
            tsim.SimResult(config=SimConfig(m=m), **common))


SUMMARY_FIELDS = [f for f in tsim.SummaryResult.__dataclass_fields__
                  if f != "config"]
METRICS = (("mean_queue", ()), ("max_queue", ()),
           ("worst_case_queue", ()), ("worst_case_queue", (50.0,)),
           ("dispersion", ()), ("dispersion_t", ()),
           ("latency_quantiles", ()), ("latency_quantiles", ((10, 90),)))


@pytest.mark.parametrize("m", MS)
def test_summarize_matches_reference(m):
    for f_max in (True, False):
        jres, tres = _results(m, f_max)
        want, got = jsim.summarize(jres), tsim.summarize(tres, device="cpu")
        assert got.config is tres.config
        for f in SUMMARY_FIELDS:
            w, g = getattr(want, f), getattr(got, f)
            assert type(w) is type(g), f
            if isinstance(w, np.ndarray):
                assert w.dtype == g.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f"m={m} {f}")
        for name, args in METRICS:
            assert getattr(got, name)(*args) == getattr(want, name)(*args)
            assert getattr(tres, name)(*args) == getattr(jres, name)(*args)


def test_summary_run_keeps_no_timeline():
    """``run_ticks(metrics="summary")`` returns O(m) accumulators and the
    (T,) knob trace, equal to ``summarize`` of the full run."""
    cfg = SimConfig(m=8, N=256, middleware=("cache",))
    wl = make_workload("bursty", T=40, m=8, N=256, device="cpu")
    runs = {}
    for mode in ("full", "summary"):
        st = tsim.init_state(cfg, device="cpu")
        runs[mode] = tsim.run_ticks(cfg, st, wl.keys, wl.mask,
                                    wl.is_write, metrics=mode)[1]
    acc, trace = runs["summary"]
    assert isinstance(acc, tsim.SummaryAcc)
    assert isinstance(trace, tsim.KnobTrace)
    assert all(x.shape == (40,) for x in trace)
    assert trace.d.dtype == torch.int32
    assert max(x.counts.numel() if hasattr(x, "counts") else x.numel()
               for x in acc) == ttel.HIST_BINS + 2
    got = tsim._to_summary(cfg, acc, trace)
    want = tsim.summarize(tsim._to_result(cfg, runs["full"], None),
                          device="cpu")
    for f in SUMMARY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError) as e:
        tsim.run_ticks(cfg, tsim.init_state(cfg, device="cpu"), wl.keys,
                       wl.mask, wl.is_write, metrics="nope")
    with pytest.raises(ValueError) as w:
        jregistry.validate_choice("nope", "metrics mode",
                                  jsim.METRICS_MODES)
    assert str(e.value) == str(w.value)
    assert tsim.METRICS_MODES == jsim.METRICS_MODES
