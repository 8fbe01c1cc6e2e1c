"""The port's ``route_select`` equals the reference's Pallas kernel.

The plain PyTorch version runs here on the CPU against the reference's
``route_select`` in interpret mode, on ``tests/test_kernels.py``'s
RS_CASES (ragged R, ``inf`` loads and first-index ties included).  The
CUDA kernel is held against the plain version on the card in
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.midas_route import kernel as jkernel  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.midas_route import ops, ref  # noqa: E402

RS_CASES = [(256, 8, 4, 128), (100, 8, 4, 128), (64, 32, 8, 8),
            (7, 4, 2, 256)]


def _inputs(R, m, d_max, seed=11, ties=False, infs=False):
    rng = np.random.default_rng(seed)
    feas = rng.integers(0, m, (R, d_max)).astype(np.int32)
    load = (np.abs(rng.normal(size=m)) * 3.0).astype(np.float32)
    p50 = (np.abs(rng.normal(size=m)) * 50.0).astype(np.float32)
    if ties:  # few distinct values: many exactly equal candidates
        load = np.round(load).astype(np.float32)
        p50 = np.round(p50 / 25.0).astype(np.float32) * 25.0
    if infs:
        load[::3] = np.inf  # never every server
    sampled = rng.random((R, d_max)) < 0.6
    tie = (rng.random((R, d_max)) * 1e-3).astype(np.float32)
    if ties:
        tie[::2] = 0.0
    return feas, load, p50, sampled, tie


def _run_both(mode, tile, feas, load, p50, sampled, tie, scal):
    want = jkernel.route_select(
        jnp.asarray(feas), jnp.asarray(load), jnp.asarray(p50),
        jnp.asarray(sampled.astype(np.int32)), jnp.asarray(tie),
        jnp.asarray(scal).reshape(1, 4), mode=mode, tile=tile,
        interpret=True)
    got = ref.route_select(
        torch.as_tensor(feas), torch.as_tensor(load), torch.as_tensor(p50),
        torch.as_tensor(sampled), torch.as_tensor(tie),
        torch.as_tensor(scal), mode=mode)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("mode", ("power_of_d", "midas", "chbl"))
@pytest.mark.parametrize("R,m,d_max,tile", RS_CASES)
@pytest.mark.parametrize("variant", ("plain", "ties", "infs"))
def test_ref_route_select_matches_pallas(mode, R, m, d_max, tile, variant):
    feas, load, p50, sampled, tie = _inputs(
        R, m, d_max, ties=variant == "ties", infs=variant == "infs")
    if mode == "midas":
        sampled[:, 0] = False
    cap = np.float32(1.25 * (load[np.isfinite(load)].mean() + 1.0))
    scal = np.array([0.5, 10.0, cap, 0.0], np.float32)
    _run_both(mode, tile, feas, load, p50, sampled, tie, scal)


def test_all_ineligible_rows_pick_slot_zero():
    feas = np.array([[3, 1, 2], [0, 2, 1]], np.int32)
    load = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
    sampled = np.zeros((2, 3), bool)
    tie = np.zeros((2, 3), np.float32)
    scal = np.array([0.5, 1.0, -1.0, 0.0], np.float32)
    for mode in ("power_of_d", "midas", "chbl"):
        _run_both(mode, 8, feas, load, load, sampled, tie, scal)
    assign, _ = ref.route_select(
        torch.as_tensor(feas), torch.as_tensor(load), torch.as_tensor(load),
        torch.as_tensor(sampled), torch.as_tensor(tie),
        torch.as_tensor(scal), mode="power_of_d")
    assert assign.tolist() == [3, 0]


def test_route_waves_flattens_leading_axes():
    feas, load, p50, sampled, tie = _inputs(48, 8, 4)
    scal = torch.tensor([0.5, 10.0, 0.0, 0.0])
    args = [torch.as_tensor(x) for x in (feas, load, p50, sampled, tie)]
    flat = ref.route_select(*args, scal, mode="midas")
    lead = [args[0].reshape(6, 8, 4), args[1], args[2],
            args[3].reshape(6, 8, 4), args[4].reshape(6, 8, 4)]
    waves = ops.route_waves(*lead, scal, mode="midas", impl="ref")
    for f, w in zip(flat, waves):
        assert w.shape == (6, 8)
        assert torch.equal(f, w.reshape(-1))


def test_cuda_impl_on_cpu_tensors_raises():
    feas, load, p50, sampled, tie = _inputs(8, 4, 2)
    args = [torch.as_tensor(x) for x in (feas, load, p50, sampled, tie)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.route_waves(*args, torch.zeros(4), mode="midas", impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        common.resolve_impl("cuda", torch.device("cpu"), "route_impl")
    assert common.resolve_impl("auto", torch.device("cpu")) == "ref"
