"""The port's selective scan against the JAX reference on the CPU.

The plain ``chunk_scan`` is held against the reference's Pallas kernel
run in interpret mode, on tests/test_kernels.py's cases, within 1e-4
(relative and absolute), as that file holds the Pallas kernel against
the sequential oracle.  ``ops.selective_scan`` is held against the
reference's ``ops.selective_scan(impl="ref")`` with that file's chunked
tolerances (y 1e-4, or 3e-2 in bfloat16; h 1e-3), on its cases plus
sequences that fit one chunk.  Inputs are made with numpy and handed
to both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan import kernel as jkernel  # noqa: E402
from repro.kernels.ssm_scan import ops as jops  # noqa: E402
from repro.kernels.ssm_scan import ref as jref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops, ref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _softplus(a):
    return np.logaddexp(a, 0.0).astype(np.float32)


def _inputs(Bt, S, DI, ST, seed, dtype="float32"):
    """(jax arrays, torch tensors) of h0, x, dt, A, B, C, D; x, dt, B
    and C rounded to ``dtype`` in both."""
    rng = np.random.default_rng(seed)
    arrs = dict(
        h0=rng.standard_normal((Bt, DI, ST), np.float32),
        x=rng.standard_normal((Bt, S, DI), np.float32),
        dt=_softplus(rng.standard_normal((Bt, S, DI), np.float32)),
        A=-np.exp(rng.standard_normal((DI, ST), np.float32) * 0.5),
        B=rng.standard_normal((Bt, S, ST), np.float32),
        C=rng.standard_normal((Bt, S, ST), np.float32),
        D=rng.standard_normal((DI,), np.float32),
    )
    j, t = {}, {}
    for name, a in arrs.items():
        a = a.astype(np.float32)
        if name in ("x", "dt", "B", "C"):
            j[name] = jnp.asarray(a).astype(getattr(jnp, dtype))
            t[name] = torch.as_tensor(a).to(getattr(torch, dtype))
        else:
            j[name], t[name] = jnp.asarray(a), torch.as_tensor(a)
    return j, t


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("Bt,Q,DI,ST,tile", [
    (2, 16, 32, 8, 16),
    (1, 32, 64, 16, 32),
    (2, 16, 32, 8, 32),
])
def test_plain_chunk_scan_matches_pallas_kernel(Bt, Q, DI, ST, tile):
    j, t = _inputs(Bt, Q, DI, ST, seed=Q + DI + tile)
    want_y, want_h = jkernel.chunk_scan(j["h0"], j["x"], j["dt"], j["A"],
                                        j["B"], j["C"], tile=tile,
                                        interpret=True)
    got_y, got_h = ref.chunk_scan(t["h0"], t["x"], t["dt"], t["A"], t["B"],
                                  t["C"])
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **TOL)


@pytest.mark.parametrize("Bt,Q,DI,ST", [(2, 40, 100, 16), (1, 7, 24, 64),
                                        (3, 1, 16, 3)])
def test_plain_chunk_scan_matches_sequential_oracle(Bt, Q, DI, ST):
    """Odd chunk lengths (not a power of two), a ragged DI, ST = 64 and
    a one-step chunk: the log-step scan against the sequential oracle
    from h0, without the D·x skip."""
    _, t = _inputs(Bt, Q, DI, ST, seed=Q * DI + ST)
    want_y, want_h = ref.selective_scan(t["x"], t["dt"], t["A"], t["B"],
                                        t["C"], torch.zeros(DI), t["h0"])
    got_y, got_h = ref.chunk_scan(t["h0"], t["x"], t["dt"], t["A"], t["B"],
                                  t["C"])
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **TOL)


# (Bt, S, DI, ST, chunk, dtype): tests/test_kernels.py's SSM_CASES, then
# sequences that fit one chunk (the sequential branch) and a ragged tail
SSM_CASES = [
    (2, 64, 32, 8, 16, "float32"),
    (1, 128, 64, 16, 32, "float32"),
    (2, 96, 32, 8, 32, "bfloat16"),
    (2, 24, 32, 8, 32, "float32"),
    (1, 32, 16, 4, 32, "bfloat16"),
    (1, 150, 48, 16, 128, "float32"),
]


@pytest.mark.parametrize("Bt,S,DI,ST,chunk,dtype", SSM_CASES)
def test_selective_scan_matches_reference(Bt, S, DI, ST, chunk, dtype):
    j, t = _inputs(Bt, S, DI, ST, seed=S + DI, dtype=dtype)
    want_y, want_h = jops.selective_scan(j["x"], j["dt"], j["A"], j["B"],
                                         j["C"], j["D"], chunk=chunk,
                                         impl="ref")
    got_y, got_h = ops.selective_scan(t["x"], t["dt"], t["A"], t["B"],
                                      t["C"], t["D"], chunk=chunk)
    assert got_y.dtype == t["x"].dtype and got_h.dtype == torch.float32
    assert tuple(got_y.shape) == want_y.shape
    ytol = 3e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(_np(got_y), _np(want_y), rtol=ytol,
                               atol=ytol)
    np.testing.assert_allclose(_np(got_h), _np(want_h), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_selective_scan_carries_h0_across_chunks(chunk):
    """The chunked scan from a given h0 against the reference's
    sequential oracle from the same h0."""
    j, t = _inputs(2, 64, 24, 8, seed=chunk)
    want_y, want_h = jref.selective_scan(j["x"], j["dt"], j["A"], j["B"],
                                         j["C"], j["D"], j["h0"])
    got_y, got_h = ops.selective_scan(t["x"], t["dt"], t["A"], t["B"],
                                      t["C"], t["D"], t["h0"], chunk=chunk)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_step_matches_reference(dtype):
    j, t = _inputs(3, 1, 40, 16, seed=5, dtype=dtype)
    want_y, want_h = jref.selective_step(j["x"][:, 0], j["dt"][:, 0], j["A"],
                                         j["B"][:, 0], j["C"][:, 0], j["D"],
                                         j["h0"])
    got_y, got_h = ref.selective_step(t["x"][:, 0], t["dt"][:, 0], t["A"],
                                      t["B"][:, 0], t["C"][:, 0], t["D"],
                                      t["h0"])
    assert got_y.dtype == t["x"].dtype
    tol = TOL if dtype == "float32" else dict(rtol=2.0**-7, atol=1e-6)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **tol)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **TOL)


def test_sequential_oracle_matches_reference():
    j, t = _inputs(2, 20, 24, 8, seed=9)
    want_y, want_h = jref.selective_scan(j["x"], j["dt"], j["A"], j["B"],
                                         j["C"], j["D"], j["h0"])
    got_y, got_h = ref.selective_scan(t["x"], t["dt"], t["A"], t["B"],
                                      t["C"], t["D"], t["h0"])
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **TOL)


def test_cuda_impl_on_cpu_tensors_raises():
    _, t = _inputs(1, 8, 16, 4, seed=0)
    args = (t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"])
    with pytest.raises(ValueError, match="CUDA device"):
        ops.selective_scan(*args, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.selective_scan(*args, impl="pallas")
    from repro_torch.kernels.ssm_scan import kernel

    with pytest.raises(ValueError, match="CUDA"):
        kernel.chunk_scan(t["h0"], t["x"], t["dt"], t["A"], t["B"], t["C"])
