"""The port's routing policies equal the reference, wave by wave.

The waves use a tiny key space and a strongly skewed load view, so the
same key is steered more than once in one wave: the reference's scatter
keeps the last steer (XLA on the CPU), and so must the port.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import hashring as jring  # noqa: E402
from repro.core.policies import midas as jmidas  # noqa: E402
from repro.core.policies import power_of_d as jpod  # noqa: E402
from repro.core.policies import static_hash as jhash  # noqa: E402
from repro_torch.core import hashring as tring  # noqa: E402
from repro_torch.core import policies as tpol  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.policies import midas as tmidas  # noqa: E402
from repro_torch.core.policies import power_of_d as tpod  # noqa: E402

M, D_MAX, R = 8, 4, 24


def _waves(n, seed, n_keys):
    rng = np.random.default_rng(seed)
    jr = jring.make_ring(M, 64)
    for g in range(n):
        keys = rng.integers(0, n_keys, R).astype(np.int32)
        mask = rng.random(R) < 0.9
        load = (rng.random(M) * 12).astype(np.float32)
        load[rng.integers(0, M)] += 30.0  # one hot server
        p50 = (rng.random(M) * 300).astype(np.float32)
        feas = np.asarray(jring.feasible_set(jr, jnp.asarray(keys), D_MAX))
        key = jax.random.fold_in(jax.random.PRNGKey(seed), g)
        yield g, keys, mask, load, p50, feas, key


def _t(x):
    return torch.as_tensor(np.array(x))


def test_sample_candidates_match():
    from repro.core.policies.base import sample_candidates as jsc

    feas = np.zeros((50, D_MAX), np.int32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        for d in (1, 2, 3, 4):
            want = np.asarray(jsc(key, jnp.asarray(feas), d))
            got = tpol.sample_candidates(_t(key).long(), _t(feas), d)
            np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("n_keys", (6, 512))
def test_midas_waves_match_with_repeated_steers(n_keys):
    w_ticks = 20
    route = jax.jit(functools.partial(jmidas.route_midas, pin_c_ms=300.0,
                                      w_ticks=w_ticks))
    js = jmidas.init_midas(n_keys, w_ticks)
    ts = tmidas.init_midas(n_keys, w_ticks, "cpu")
    policy = tpol.get("midas")
    repeats = steered = 0
    for g, keys, mask, load, p50, feas, key in _waves(60, 2, n_keys):
        d, dl, dt = [2, 3, 4][g % 3], [0.0, 2.0][g % 2], -1e9
        f_max, now = [1.0, 0.2][g % 2], np.float32(50.0 * (g // 2))
        js, ja, jst = route(js, key, jnp.asarray(keys), jnp.asarray(feas),
                            load, p50, jnp.asarray(mask), d, dl, dt, f_max,
                            now)
        draws = policy.draws(_t(key).long(), (R, D_MAX))
        ts, ta, tst = tmidas.route_midas(
            ts, draws, _t(keys).long(), _t(feas), _t(load), _t(p50),
            _t(mask), torch.tensor(d, dtype=torch.int32), torch.tensor(dl),
            torch.tensor(dt), torch.tensor(f_max), torch.tensor(now),
            torch.tensor(300.0), w_ticks)
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        assert np.asarray(jst.steered) == tst.steered.numpy()
        assert np.asarray(jst.eligible) == tst.eligible.numpy()
        for f in jmidas.MidasState._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(js, f)), getattr(ts, f).numpy(),
                err_msg=f"wave {g} {f}")
        moved = (ta.numpy() != feas[:, 0]) & mask
        steered += int(moved.sum())
        ks = keys[moved]
        repeats += int(ks.size - np.unique(ks).size)
    assert steered > 0
    if n_keys == 6:
        assert repeats > 0  # the scatter really saw repeated keys


def test_power_of_d_and_hash_waves_match():
    policy = tpol.get("power_of_d")
    jr, tr = jring.make_ring(M, 64), tring.make_ring(M, 64, device="cpu")
    for g, keys, mask, load, p50, feas, key in _waves(20, 5, 512):
        d = 1 + g % 4
        want = jpod.route_power_of_d(key, jnp.asarray(feas), load,
                                     jnp.asarray(mask), d)
        draws = policy.draws(_t(key).long(), (R, D_MAX))
        got = tpod.route_power_of_d(draws, _t(feas), _t(load), _t(mask), d)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        want = jhash.route_hash(jr, jnp.asarray(keys), jnp.asarray(mask))
        got = torch.where(_t(mask), tring.primary(tr, _t(keys)), -1)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_draws_batch_over_waves():
    policy = tpol.get("midas")
    keys = prng.split(prng.PRNGKey(9, device="cpu"), 6).reshape(2, 3, 2)
    both = policy.draws(keys, (5, D_MAX))
    for i in range(2):
        for j in range(3):
            one = policy.draws(keys[i, j], (5, D_MAX))
            assert torch.equal(both.rank[i, j], one.rank)
            assert torch.equal(both.tie[i, j], one.tie)


def test_registry_lists_the_ported_policies():
    assert tpol.available() == ("chbl", "hash", "jsq", "midas", "power_of_d",
                                "round_robin", "rr_request", "uniform")
    with pytest.raises(ValueError, match="available: chbl, hash, jsq"):
        tpol.get("least_loaded")
