"""XLA's CPU sum orders at the sizes the paper runs, against the live
JAX reference.

``xla.reduce_sum`` must be ``jax.jit(jnp.sum)`` bit for bit at every
length, and ``telemetry.imbalance`` the reference's jitted
``imbalance`` at every m: above 32 elements XLA sums in windows of 32
with the padding split across both ends, rounds ``jnp.std``'s squares
before their sum and fuses the imbalance's denominator into one FMA.
What rides on them is held too: the engine's ``pressure`` and the knob
timelines ``deadband_pid`` integrates from it at m = 48, 72 and 100
(outside the m = 8 of the other parity tests), and the Zipf tables and
keys at the paper's N = 10**6.

Torch runs on one intra-op thread here (the engine cases' small ops; the
test workers' other processes take the cores, and torch's threads then
contend, ~3x slower), and the reference's workload grid is made once for
both controllers of an (m, T).
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
from repro.core import telemetry as jtelemetry  # noqa: E402
from repro.core.workloads import base as jbase  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import prng, telemetry, workloads, xla  # noqa: E402
from repro_torch.core import sim as tsim  # noqa: E402
from repro_torch.core.workloads import base as tbase  # noqa: E402

FIELDS = ("queue_timeline", "arrivals", "lat_pred", "d_timeline",
          "delta_l_timeline", "f_max_timeline", "pressure", "steered",
          "eligible", "cache_hits")
LONG = (1000, 4097, 10_000, 65_537, 10**6)
_SUM = jax.jit(jnp.sum)
_IMBALANCE = jax.jit(jtelemetry.imbalance)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _bursty(m, T):
    """The reference's ``bursty`` grid at (m, T), seed 1, N = 4096."""
    return jmake("bursty", T=T, m=m, seed=1, N=4096)


def _vectors(n, seed, k):
    """k float32 vectors of length n: uniform at three scales, a grid of
    tenths (many equal values) and normals of both signs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        kind = i % 3
        if kind == 0:
            x = rng.random(n) * rng.choice([1.0, 1e3, 1e-3])
        elif kind == 1:
            x = np.round(rng.random(n) * 8, 1)
        else:
            x = rng.standard_normal(n) * 5
        out.append(x.astype(np.float32))
    return out


@pytest.mark.parametrize("n", list(range(1, 301)) + list(LONG))
def test_reduce_sum_is_jnp_sum_bit_for_bit(n):
    for x in _vectors(n, n, 3 if n <= 300 else 1):
        got = xla.reduce_sum(torch.as_tensor(x)).numpy()
        assert got.tobytes() == np.asarray(_SUM(x)).tobytes(), n


@pytest.mark.parametrize("m", range(1, 260))
def test_imbalance_is_the_jitted_reference_bit_for_bit(m):
    for i, x in enumerate(_vectors(m, 1000 + m, 25)):
        if i % 3 == 2:
            x = np.abs(x)  # queue views are non-negative
        got = telemetry.imbalance(torch.as_tensor(x)).numpy()
        assert got.tobytes() == np.asarray(_IMBALANCE(x)).tobytes(), (m, i)


@pytest.mark.parametrize("m,T", [(48, 700), (72, 700), (100, 1300)])
@pytest.mark.parametrize("controller", ("hysteresis", "deadband_pid"))
def test_engine_pressure_and_knobs_bitwise_at_wide_m(m, T, controller):
    """Every timeline, pressure and the knobs included, bit for bit."""
    wl = _bursty(m, T)
    kw = dict(m=m, N=4096, policy="midas", middleware=("cache",),
              controller=controller)
    want = jsimulate(JConfig(**kw), wl, do_warmup=False)
    got = tsim.simulate(
        tsim.SimConfig(**kw),
        convert.workload_from_numpy(np.asarray(wl.keys),
                                    np.asarray(wl.mask),
                                    np.asarray(wl.is_write), wl.N,
                                    device="cpu"),
        do_warmup=False, device="cpu")
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert w.dtype == g.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.steered.sum() > 0
    assert len(np.unique(got.pressure)) > 10  # the loop saw real signal


@pytest.mark.parametrize("alpha", (0.9, 1.1, 1.4))
@pytest.mark.parametrize("N", (1000, 10**6))
def test_zipf_tables_and_keys_at_the_paper_size(alpha, N):
    np.testing.assert_array_equal(
        tbase.zipf_cdf(N, alpha, "cpu").numpy(),
        np.asarray(jbase.zipf_cdf(N, alpha)))
    want = jbase.sample_keys(jax.random.PRNGKey(7), (300, 24), N, alpha)
    got = tbase.sample_keys(prng.PRNGKey(7, "cpu"), (300, 24), N, alpha)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("name", ("skewed", "diurnal"))
@pytest.mark.parametrize("N", (1000, 10**6))
def test_zipf_workload_keys_at_the_paper_size(name, N):
    kw = dict(T=300, m=8, seed=1, N=N)
    jw = jmake(name, **kw)
    tw = workloads.make_workload(name, device="cpu", **kw)
    # the whole key grid is drawn before the mask is applied
    np.testing.assert_array_equal(tw.keys.numpy(), np.asarray(jw.keys))
    both = np.asarray(jw.mask) & tw.mask.numpy()
    assert both.sum() > 300
    np.testing.assert_array_equal(tw.is_write.numpy()[both],
                                  np.asarray(jw.is_write)[both])
