"""The port's ring, hashes and feasible sets equal the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hashring as jring  # noqa: E402
from repro_torch.core import hashring as tring  # noqa: E402

KEYS = np.random.default_rng(7).integers(0, 1_000_000, 4096)


def test_mix32_and_hash2_bitwise():
    x = np.random.default_rng(1).integers(0, 2**32, 2000, dtype=np.uint64)
    want = np.asarray(jring.mix32(jnp.asarray(x.astype(np.uint32))))
    got = tring.mix32(torch.as_tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())
    for salt in (0, 11, 7919):
        want = np.asarray(jring.hash2(jnp.asarray(KEYS, jnp.uint32), salt))
        got = tring.hash2(torch.as_tensor(KEYS), salt)
        np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("m", (4, 8, 64))
@pytest.mark.parametrize("d_max", (2, 4))
def test_ring_primary_and_feasible_set_exact(m, d_max):
    jr = jring.make_ring(m, 64)
    tr = tring.make_ring(m, 64, device="cpu")
    np.testing.assert_array_equal(
        np.asarray(jr.positions).astype(np.int64), tr.positions.numpy()
    )
    np.testing.assert_array_equal(np.asarray(jr.owners), tr.owners.numpy())
    jk = jnp.asarray(KEYS, jnp.int32)
    tk = torch.as_tensor(KEYS)
    np.testing.assert_array_equal(
        np.asarray(jring.primary(jr, jk)), tring.primary(tr, tk).numpy()
    )
    # a leading batch axis, as the engine gathers a whole horizon
    want = np.asarray(jring.feasible_set(jr, jk.reshape(64, -1), d_max))
    got = tring.feasible_set(tr, tk.reshape(64, -1), d_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


def test_feasible_set_pads_when_the_window_is_short():
    # m=2 servers with V=1 vnode: a 16-slot window holds 2 owners, so
    # d_max=4 needs the (primary + i) mod m pad
    jr = jring.make_ring(2, 1)
    tr = tring.make_ring(2, 1, device="cpu")
    jk = jnp.asarray(KEYS[:256], jnp.int32)
    want = np.asarray(jring.feasible_set(jr, jk, 4))
    got = tring.feasible_set(tr, torch.as_tensor(KEYS[:256]), 4)
    np.testing.assert_array_equal(want, got.numpy())
