"""The port's cooperative cache equals the reference in all three modes.

Batches repeat keys on purpose: a key read and written in one tick, and
a key installed twice, exercise the scatters whose repeats the port
resolves explicitly.  The reference runs under ``jax.jit``, as inside
the engine's tick.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cache as jcache  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402

N, R = 64, 48


def _assert_state_equal(js, ts):
    for f in jcache.CacheState._fields:
        w, g = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert w.dtype == g.dtype, f
        np.testing.assert_array_equal(w, g, err_msg=f)


def _batches(n, seed, write_frac):
    rng = np.random.default_rng(seed)
    for t in range(n):
        keys = rng.integers(0, N // 4 if t % 2 else N, R).astype(np.int32)
        keys[:8] = keys[0]  # one key repeated, mixed reads and writes
        mask = rng.random(R) < 0.9
        is_write = (rng.random(R) < write_frac) & mask
        yield t, keys, mask, is_write


@pytest.mark.parametrize("mode", jcache.MODES)
@pytest.mark.parametrize("write_frac", (0.05, 0.5))
def test_lookup_and_slow_update_match(mode, write_frac):
    kw = dict(mode=mode, lease_ms=400.0, rtt_ms=2.0, p_star=1e-4)
    jlook = jax.jit(functools.partial(jcache.lookup_batch, **kw))
    lease = 400.0 if mode == "lease" else float("inf")
    jslow = jax.jit(lambda c: jcache.slow_update(c, 30_000.0, 2.0, lease))
    js = jcache.init_cache(N)
    ts = tcache.init_cache(N, device="cpu")
    for t, keys, mask, is_write in _batches(40, 1, write_frac):
        now = np.float32(t * 50.0)
        js, jhit = jlook(js, jnp.asarray(keys), jnp.asarray(mask),
                         jnp.asarray(is_write), jnp.asarray(now))
        ts, thit = tcache.lookup_batch(
            ts, torch.as_tensor(keys).long(), torch.as_tensor(mask),
            torch.as_tensor(is_write), torch.tensor(now), **kw)
        np.testing.assert_array_equal(np.asarray(jhit), thit.numpy())
        _assert_state_equal(js, ts)
        if t % 10 == 9:
            js = jslow(js)
            ts = tcache.slow_update(ts, 30_000.0, 2.0, lease)
            _assert_state_equal(js, ts)
    assert int(ts.hits) > 0 and int(ts.misses) > 0


def test_version_bump_counts_every_repeat():
    ts = tcache.init_cache(8, device="cpu")
    keys = torch.tensor([3, 3, 3, 5, 3])
    is_write = torch.tensor([True, True, False, True, True])
    ts, _ = tcache.lookup_batch(ts, keys, torch.ones(5, dtype=torch.bool),
                                is_write, torch.tensor(0.0))
    assert ts.global_version.tolist() == [0, 0, 0, 3, 0, 1, 0, 0]


def test_write_pressure_guard_bypasses_installs():
    ts = tcache.init_cache(16, device="cpu")
    ts = ts._replace(win_writes=torch.tensor(40.0),
                     win_reads=torch.tensor(40.0))
    keys = torch.arange(8)
    ts, hit = tcache.lookup_batch(
        ts, keys, torch.ones(8, dtype=torch.bool),
        torch.zeros(8, dtype=torch.bool), torch.tensor(0.0))
    assert not hit.any() and int(ts.bypasses) == 8
    assert (ts.cached_version[:8] == -1).all()
