"""The port's threefry PRNG equals ``jax.random`` bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402

SEEDS = (0, 1, 3, 99, 12345, 2**31 - 1)
SHAPES = ((), (1,), (7,), (8,), (64, 4), (3, 2, 5))


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")


def _np(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(_np(jk), tk.numpy())
    for num in (2, 3, 8):
        np.testing.assert_array_equal(
            _np(jax.random.split(jk, num)), prng.split(tk, num).numpy()
        )
    for data in (0, 1, 2, 3, 7, 2**31 + 5):
        np.testing.assert_array_equal(
            _np(jax.random.fold_in(jk, data)),
            prng.fold_in(tk, data).numpy(),
        )


def test_batched_fold_in_is_a_vmapped_fold_in():
    jk, tk = _key(5)
    jks = jax.random.split(jk, 4)
    G = 8
    want = jax.vmap(
        lambda k: jax.vmap(lambda g: jax.random.fold_in(k, g))(
            jnp.arange(G)
        )
    )(jks)
    got = prng.fold_in(prng.split(tk, 4)[:, None, :], torch.arange(G))
    np.testing.assert_array_equal(_np(want), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bitwise(seed, shape):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, shape)),
        prng.uniform(tk, shape).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, shape, minval=-1.0, maxval=1.0)),
        prng.uniform(tk, shape, -1.0, 1.0).numpy(),
    )


def test_uniform_with_batched_keys_equals_per_key_draws():
    jk, tk = _key(11)
    jks = jax.random.split(jk, 6)
    want = np.stack([np.asarray(jax.random.uniform(k, (5, 4)))
                     for k in jks])
    got = prng.uniform(prng.split(tk, 6), (5, 4)).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("hi", (2, 8, 512, 4096, 1_000_000, 2**31 - 1))
def test_randint_bitwise(seed, hi):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(jk, (9, 13), 0, hi, jnp.int32)),
        prng.randint(tk, (9, 13), 0, hi).numpy(),
    )


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    want = (a * b).astype(np.int64)
    got = prng.mul32(torch.as_tensor(a.astype(np.int64)),
                     torch.as_tensor(b.astype(np.int64)))
    np.testing.assert_array_equal(want, got.numpy())
