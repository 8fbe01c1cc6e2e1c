"""The port's Fig. 2 generators against the reference's.

Everything but the per-tick arrival counts is the reference's bit for
bit: the rate curves (float32 in the reference's order, the C
library's ``sinf`` as XLA calls it on the CPU), storm's timeline and
hot keys, the Zipf tables (``powf``, XLA's cumulative-sum and sum
orders) and so every key at a slot both grids fill.  The counts are
``torch.poisson`` draws where the reference uses ``jax.random.poisson``,
so they are held statistically: each run's mean count within 5
standard errors of the mean rate (plus 2% of it), and the Zipf(0.9)
key ranks of ``skewed`` within a total-variation distance of 0.05 of
the law (about 3000 samples over 4096 ranks, of which the top 64 are
compared, the rest pooled).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.workloads.fig2 as jfig2  # noqa: E402
from repro.core import make_workload as jmake  # noqa: E402
from repro.core.workloads import base as jbase  # noqa: E402
from repro_torch.core import prng, workloads, xla  # noqa: E402
from repro_torch.core.hashring import hash2  # noqa: E402
from repro_torch.core.workloads import base as tbase  # noqa: E402
from repro_torch.core.workloads import fig2 as tfig2  # noqa: E402

NEW = ("uniform_heavy", "periodic", "diurnal", "skewed", "storm")


def _rates(monkeypatch, name, **kw):
    """Build ``name`` in both packages and return (reference grid, port
    grid, reference rate, port rate), the rates as each generator hands
    them to its ``assemble``."""
    seen = {}

    def spy(mod, tag):
        orig = mod.assemble

        def assemble(key, rate, *a, **k):
            seen[tag] = np.asarray(rate)
            return orig(key, rate, *a, **k)
        monkeypatch.setattr(mod, "assemble", assemble)

    spy(jfig2, "ref")
    spy(tfig2, "port")
    jw = jmake(name, **kw)
    tw = workloads.make_workload(name, device="cpu", **kw)
    return jw, tw, seen["ref"], seen["port"]


@pytest.mark.parametrize("T,m,seed", [(400, 8, 3), (3000, 8, 0),
                                      (1201, 12, 5)])
@pytest.mark.parametrize("name", NEW + ("light", "bursty"))
def test_rates_and_keys_match_bit_for_bit(monkeypatch, name, T, m, seed):
    jw, tw, jr, tr = _rates(monkeypatch, name, T=T, m=m, seed=seed, N=512)
    assert jr.dtype == tr.dtype == np.float32
    np.testing.assert_array_equal(tr, jr)
    both = np.asarray(jw.mask) & tw.mask.numpy()
    assert both.sum() > 0
    np.testing.assert_array_equal(tw.keys.numpy()[both],
                                  np.asarray(jw.keys)[both])
    np.testing.assert_array_equal(tw.is_write.numpy()[both],
                                  np.asarray(jw.is_write)[both])
    assert tw.keys.dtype == torch.int32 and tw.keys.shape == jw.keys.shape


@pytest.mark.parametrize("seed", (0, 4))
def test_storm_timeline_and_hot_keys_exact(seed):
    T, N = 2600, 4096
    p = jbase.WorkloadParams(T=T, m=8, seed=seed, N=N)
    storm = (p.sec % 60.0) < 5.0
    idx = (p.sec // 60.0).astype(jnp.int32)
    tp = tbase.WorkloadParams(T=T, m=8, seed=seed, N=N, R=p.R or 24)
    t_storm, t_idx = tfig2.storm_timeline(tp)
    np.testing.assert_array_equal(np.asarray(storm), t_storm.numpy())
    np.testing.assert_array_equal(np.asarray(idx), t_idx.numpy())
    # 130 s: storms in minutes 0, 1 and 2, 100 ticks each
    assert int(t_idx.max()) == 2 and int(t_storm.sum()) == 300
    # the hot keys of every storm, drawn from the same threefry key
    _, k2 = jax.random.split(p.rng)
    want = jbase.hot_subset_keys(k2, (T, 24), idx, N, subset=16,
                                 alpha=1.0, salt=17)
    _, tk2 = prng.split(tp.rng).unbind(0)
    got = tbase.hot_subset_keys(tk2, (T, 24), t_idx, N, subset=16,
                                alpha=1.0, salt=17)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("alpha", (0.5, 0.6, 0.9, 1.0, 1.1))
@pytest.mark.parametrize("N", (16, 32, 512, 4096))
def test_zipf_tables_and_keys_match(alpha, N):
    np.testing.assert_array_equal(
        tbase.zipf_cdf(N, alpha, "cpu").numpy(),
        np.asarray(jbase.zipf_cdf(N, alpha)))
    key = jax.random.PRNGKey(N)
    want = jbase.sample_keys(key, (200, 24), N, alpha)
    got = tbase.sample_keys(prng.PRNGKey(N, "cpu"), (200, 24), N, alpha)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n", (1, 5, 16, 17, 31, 32, 33, 40, 64, 96, 512,
                               4096))
def test_xla_sum_orders(n):
    rng = np.random.default_rng(n)
    sum_ = jax.jit(jnp.sum)
    for _ in range(20):
        x = (rng.random(n) * rng.choice([1, 10, 1000])).astype(np.float32)
        t = torch.as_tensor(x)
        np.testing.assert_array_equal(xla.cumsum(t).numpy(),
                                      np.asarray(jnp.cumsum(x)))
        assert xla.reduce_sum(t).numpy() == np.asarray(sum_(x))


def test_libm_matches_the_reference_sin_and_pow():
    x = np.arange(6000, dtype=np.float32) * np.float32(0.0172)
    np.testing.assert_array_equal(
        xla.libm("sinf", torch.as_tensor(x)).numpy(),
        np.asarray(jnp.sin(x)))
    r = np.arange(1, 5000, dtype=np.float32)
    np.testing.assert_array_equal(
        xla.libm("powf", torch.as_tensor(r), -0.9).numpy(),
        np.asarray(jnp.asarray(r) ** (-0.9)))


@pytest.mark.parametrize("name", NEW)
def test_counts_match_the_rate_statistically(monkeypatch, name):
    for seed in (0, 1, 2):
        jw, tw, jr, tr = _rates(monkeypatch, name, T=1200, m=8,
                                seed=seed, N=4096)
        R = tw.mask.shape[1]
        lam = np.minimum(tr.astype(np.float64), R)  # counts clip at R
        se = np.sqrt(lam.sum()) / lam.size
        for mask in (np.asarray(jw.mask), tw.mask.numpy()):
            gap = abs(mask.sum(1).mean() - lam.mean())
            assert gap < 5 * se + 0.02 * lam.mean(), (name, seed)


def test_skewed_key_ranks_follow_zipf():
    N = 4096
    wl = workloads.make_workload("skewed", T=1200, m=8, seed=2, N=N,
                                 device="cpu")
    keys = wl.keys.numpy()[wl.mask.numpy()]
    table = (hash2(torch.arange(N), 3) % N).numpy()
    rank_of = np.full(N, -1)
    rank_of[table[::-1]] = np.arange(N)[::-1]  # first rank for each key
    ranks = rank_of[keys]
    assert (ranks >= 0).all() and keys.size > 2500
    w = np.arange(1, N + 1, dtype=np.float64) ** -0.9
    pmf = w / w.sum()
    top = 64
    hist = np.bincount(np.minimum(ranks, top), minlength=top + 1)
    want = np.append(pmf[:top], pmf[top:].sum())
    # ranks that hash to the same key are merged: compare the key mass
    tv = 0.5 * np.abs(hist / hist.sum() - want).sum()
    assert tv < 0.05, tv


def test_registry_lists_the_seven_generators():
    # the seven, and beside them the scenarios, trace replay and the
    # adversary: the reference's thirteen names
    assert set(tfig2.WORKLOADS) < set(workloads.available())
    assert len(workloads.available()) == 13
    assert workloads.available() == jbase.available()
    assert tfig2.WORKLOADS == jfig2.WORKLOADS
    from repro_torch.core import WORKLOADS

    assert WORKLOADS == tfig2.WORKLOADS
