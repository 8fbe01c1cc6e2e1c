"""The port's telemetry and hysteresis controller equal the reference.

The knob trajectory is driven by the recorded ``fast_update/B, p99,
jitter`` input series of ``tests/data/control_golden.npz`` and compared
with the LIVE reference controller on the same inputs; the recorded
outputs in that file are not the oracle.  The reference step runs under
``jax.jit``, as it does inside the engine's tick, because XLA fuses the
jitter's multiply-add there and the port reproduces that fusion.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import SimConfig as JConfig  # noqa: E402
from repro.core import controllers as jctrl  # noqa: E402
from repro.core import telemetry as jtel  # noqa: E402
from repro_torch.core import controllers as tctrl  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.sim import SimConfig  # noqa: E402

GOLDEN = np.load(Path(__file__).parent / "data" / "control_golden.npz")
KNOBS = ("d", "delta_l", "delta_t", "f_max")


def _port_signals(B, p99, jitter):
    one = torch.ones(())
    return tctrl.Signals(
        B=torch.tensor(B), p99=torch.tensor(p99), L_hat=torch.zeros(1),
        views_p=torch.zeros(1, 1), write_mix=torch.zeros(()),
        jitter=torch.tensor(jitter), rtt_ms=2.0, avail=one,
        member=torch.ones(1))


def test_hysteresis_trajectory_matches_live_reference():
    B = GOLDEN["fast_update/B"]
    p99 = GOLDEN["fast_update/p99"]
    jit = GOLDEN["fast_update/jitter"]
    jc = jctrl.get("hysteresis")
    js = jc.init(JConfig(), (0.15, 500.0))
    step = jax.jit(lambda s, b, p, j: jc.fast(s, jctrl.make_signals(
        B=b, p99=p, jitter=j, rtt_ms=2.0))[0])
    tc = tctrl.get("hysteresis")
    ts = tc.init(SimConfig(), (0.15, 500.0), "cpu")
    moved = 0
    for i in range(B.shape[0]):
        js = step(js, B[i], p99[i], jit[i])
        ts, _ = tc.fast(ts, _port_signals(B[i], p99[i], jit[i]))
        for k in KNOBS:
            want = np.asarray(getattr(js.knobs, k))
            got = getattr(ts.knobs, k).numpy()
            assert want.dtype == got.dtype and want == got, (i, k)
        assert np.asarray(js.pressure) == ts.pressure.numpy(), i
        moved += int(np.asarray(js.inner.above_cnt) == 0)
    assert moved > 0  # the series does cross the hysteresis band


def test_registry_and_knob_schema():
    assert tctrl.available() == ("aimd", "deadband_pid", "hysteresis",
                                 "static")
    with pytest.raises(ValueError, match="available: aimd, deadband_pid"):
        tctrl.get("bang_bang")
    k = tctrl.init_knobs(2.0, "cpu")
    assert k.d.dtype == torch.int32 and int(k.d) == tctrl.D_INIT
    assert float(k.delta_t) == 2.0
    clipped = tctrl.clip_knobs(k._replace(d=torch.tensor(9, dtype=torch.int32),
                                          f_max=torch.tensor(5.0)))
    assert int(clipped.d) == tctrl.D_MAX and float(clipped.f_max) == 1.0


def _sketch_pair(m, K, n_obs, seed):
    rng = np.random.default_rng(seed)
    js, ts = jtel.make_sketch(m, K), ttel.make_sketch(m, K, "cpu")
    for _ in range(n_obs):
        obs = (rng.random(m) * 400).astype(np.float32)
        js = jtel.sketch_add(js, jnp.asarray(obs))
        ts = ttel.sketch_add(ts, torch.as_tensor(obs))
    return js, ts


@pytest.mark.parametrize("n_obs", (0, 1, 2, 5, 64, 150))
def test_sketch_quantiles_exact(n_obs):
    js, ts = _sketch_pair(8, 64, n_obs, n_obs)
    np.testing.assert_array_equal(np.asarray(js.buf), ts.buf.numpy())
    for w, g in zip(jax.jit(jtel.sketch_quantiles)(js),
                    ttel.sketch_quantiles(ts)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_ewma_and_imbalance_match_jitted_reference():
    rng = np.random.default_rng(3)
    for m in (8, 64):
        prev = (rng.random(m) * 9).astype(np.float32)
        x = (rng.random(m) * 30).astype(np.float32)
        want = jax.jit(lambda p, v: jtel.ewma(p, v, 0.2))(prev, x)
        got = ttel.ewma(torch.as_tensor(prev), torch.as_tensor(x), 0.2)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        # std/mean with XLA's sum orders and fused squares: bit for bit
        want = np.asarray(jax.jit(jtel.imbalance)(got.numpy()))
        got_b = ttel.imbalance(got).numpy()
        np.testing.assert_array_equal(got_b, want)


def test_ewma_series_and_weighted_quantiles_are_the_reference():
    rng = np.random.default_rng(5)
    x = rng.random((700, 8))
    np.testing.assert_array_equal(jtel.ewma_series(x, 0.2),
                                  ttel.ewma_series(x, 0.2))
    v, w = rng.random(300), rng.random(300)
    assert jtel.weighted_quantiles(v, w, (50, 99)) == \
        ttel.weighted_quantiles(v, w, (50, 99))
