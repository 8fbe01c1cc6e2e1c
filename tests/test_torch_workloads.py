"""The port's workloads against the reference.

Everything but the per-tick arrival counts goes through the port's
threefry, so the ``bursty`` burst timeline (phase, in-burst ticks, burst
epochs) and the uniform background keys equal the reference bit for
bit.  The counts come from ``torch.poisson`` where the reference uses
``jax.random.poisson``, so counts, and the hot-set key frequencies the
counts select, are compared statistically: per-tick count means within
5 standard errors of the Poisson rate, and the hot-key rank histogram
within a total-variation distance of 0.1 of the Zipf(1.1) law (the
expected distance at ~1500 samples over 32 ranks is about 0.05).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_workload as jmake  # noqa: E402
from repro.core.workloads import WorkloadParams as JParams  # noqa: E402
from repro_torch.core import prng, workloads  # noqa: E402
from repro_torch.core.hashring import hash2  # noqa: E402
from repro_torch.core.workloads.fig2 import burst_timeline  # noqa: E402

T, M, N = 1200, 8, 4096


def _reference_timeline(seed):
    """fig2.Bursty's rate timeline, computed with the reference's ops."""
    p = JParams(T=T, m=M, seed=seed, N=N)
    _, _, k3 = jax.random.split(p.rng, 3)
    phase = jax.random.uniform(k3, ()) * 20.0
    in_burst = ((p.sec + phase) % 20.0) < 2.0
    burst_idx = ((p.sec + phase) // 20.0).astype(jnp.int32)
    rate = jnp.full((T,), 0.30 * p.cap) + jnp.where(in_burst, 3.0 * p.cap,
                                                    0.0)
    return np.asarray(in_burst), np.asarray(burst_idx), np.asarray(rate)


@pytest.mark.parametrize("seed", (0, 3))
def test_bursty_timeline_and_background_keys_exact(seed):
    in_b, idx, rate = _reference_timeline(seed)
    p = workloads.WorkloadParams(T=T, m=M, seed=seed, N=N, R=24)
    t_in, t_idx = burst_timeline(p, prng.split(p.rng, 3)[2])
    np.testing.assert_array_equal(in_b, t_in.numpy())
    np.testing.assert_array_equal(idx, t_idx.numpy())
    t_rate = torch.full((T,), 0.30 * p.cap) + torch.where(
        t_in, 3.0 * p.cap, 0.0)
    np.testing.assert_array_equal(rate, t_rate.numpy())
    assert in_b.any() and not in_b.all()

    jw = jmake("bursty", T=T, m=M, seed=seed, N=N)
    tw = workloads.make_workload("bursty", T=T, m=M, seed=seed, N=N,
                                 device="cpu")
    np.testing.assert_array_equal(np.asarray(jw.keys)[~in_b],
                                  tw.keys.numpy()[~in_b])
    both = np.asarray(jw.mask) & tw.mask.numpy()
    np.testing.assert_array_equal(np.asarray(jw.is_write)[both],
                                  tw.is_write.numpy()[both])


def _hot_rank_tv(keys, mask, in_b, idx):
    r = np.arange(1, 33, dtype=np.float64)
    pmf = r ** -1.1 / np.sum(r ** -1.1)
    hist = np.zeros(32)
    for e in np.unique(idx[in_b]):
        ranks = torch.arange(32)
        table = (hash2(ranks + 32 * int(e), 11) % N).numpy()
        ticks = in_b & (idx == e)
        sel = keys[ticks][mask[ticks]]
        for k in sel:
            hist[np.flatnonzero(table == k)[0]] += 1
    return 0.5 * np.abs(hist / hist.sum() - pmf).sum(), hist.sum()


@pytest.mark.parametrize("seed", (0, 1))
def test_bursty_counts_and_hot_keys_statistically(seed):
    in_b, idx, rate = _reference_timeline(seed)
    cap = M * 50.0 / 100.0
    for wl in (jmake("bursty", T=T, m=M, seed=seed, N=N),
               workloads.make_workload("bursty", T=T, m=M, seed=seed, N=N,
                                       device="cpu")):
        keys, mask = np.asarray(wl.keys), np.asarray(wl.mask)
        counts = mask.sum(1)
        for sel, lam in ((~in_b, 0.3 * cap), (in_b, 3.3 * cap)):
            se = np.sqrt(lam / sel.sum())
            assert abs(counts[sel].mean() - lam) < 5 * se + 0.05 * lam
        tv, n = _hot_rank_tv(keys, mask, in_b, idx)
        assert n > 1000 and tv < 0.1, (tv, n)


def test_light_workload_and_registry():
    wl = workloads.make_workload("light", T=400, m=M, seed=99, N=N,
                                 device="cpu")
    assert wl.keys.dtype == torch.int32 and wl.keys.shape == (400, 24)
    assert 0 <= int(wl.keys.min()) and int(wl.keys.max()) < N
    lam = 0.4 * M * 0.5
    assert abs(wl.mask.sum(1).float().mean().item() - lam) < 5 * np.sqrt(
        lam / 400)
    jl = jmake("light", T=400, m=M, seed=99, N=N)
    np.testing.assert_array_equal(np.asarray(jl.keys), wl.keys.numpy())
    assert workloads.available() == (
        "adversarial", "bursty", "diurnal", "flash_crowd", "job_startup",
        "light", "multi_tenant", "periodic", "rename_storm", "skewed",
        "storm", "trace_replay", "uniform_heavy")
    with pytest.raises(ValueError, match="available: adversarial, bursty"):
        workloads.make_workload("checkpoint_storm", T=4, m=M, device="cpu")
