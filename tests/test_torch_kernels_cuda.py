"""The CUDA ``route_select`` kernel against its plain version, on the card.

Needs a CUDA device and nvcc; skips without them.  The file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m requires_cuda \\
        tests/test_torch_kernels_cuda.py
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.midas_route import ref  # noqa: E402

SHAPES = [(256, 8, 4), (100, 8, 4), (64, 32, 8), (7, 4, 2), (64, 64, 4),
          (4097, 64, 16)]


def _inputs(R, m, d_max, seed, variant):
    rng = np.random.default_rng(seed)
    feas = rng.integers(0, m, (R, d_max)).astype(np.int32)
    load = (np.abs(rng.normal(size=m)) * 3.0).astype(np.float32)
    p50 = (np.abs(rng.normal(size=m)) * 50.0).astype(np.float32)
    tie = (rng.random((R, d_max)) * 1e-3).astype(np.float32)
    if variant == "ties":  # few distinct values: many equal candidates
        load = np.round(load).astype(np.float32)
        p50 = np.round(p50 / 25.0).astype(np.float32) * 25.0
        tie[::2] = 0.0
    if variant == "infs":
        load[::3] = np.inf
    sampled = rng.random((R, d_max)) < 0.6
    scal = np.array([0.5, 10.0, 2.0, 0.0], np.float32)
    return [torch.as_tensor(x).cuda()
            for x in (feas, load, p50, sampled, tie, scal)]


@pytest.mark.requires_cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.midas_route import kernel

    before = kernel.route_select.launches
    cases = list(itertools.product(
        SHAPES, ref.ROUTE_MODES, ("plain", "ties", "infs")))
    for (R, m, d_max), mode, variant in cases:
        args = _inputs(R, m, d_max, R + m, variant)
        want = ref.route_select(*args, mode=mode)
        got = kernel.route_select(*args, mode=mode)
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            assert torch.equal(w, g), (R, m, d_max, mode, variant)
    assert kernel.route_select.launches == before + len(cases)


@pytest.mark.requires_cuda
def test_cuda_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.midas_route import kernel

    feas, load, p50, sampled, tie, scal = _inputs(8, 4, 2, 0, "plain")
    with pytest.raises(ValueError, match="dtype"):
        kernel.route_select(feas.long(), load, p50, sampled, tie, scal,
                            mode="midas")
    with pytest.raises(ValueError, match="contiguous"):
        kernel.route_select(feas, load, p50, sampled,
                            tie.T.contiguous().T, scal, mode="midas")
    with pytest.raises(ValueError, match="unknown route mode"):
        kernel.route_select(feas, load, p50, sampled, tie, scal,
                            mode="jsq")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.route_select(feas.cpu(), load.cpu(), p50.cpu(),
                            sampled.cpu(), tie.cpu(), scal.cpu(),
                            mode="midas")
