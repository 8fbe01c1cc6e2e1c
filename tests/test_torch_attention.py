"""The port's attention functions against the JAX reference on the CPU.

The plain ``mha`` and ``decode_attention`` of the port are held against
the reference's plain versions and against its Pallas kernels run in
interpret mode, on ``tests/test_kernels.py``'s cases, with that file's
tolerance: 2e-5 (relative and absolute) in float32, 2e-2 in bfloat16.
Inputs are made with numpy and handed to both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import kernel as jda_kernel  # noqa: E402
from repro.kernels.decode_attention import ref as jda_ref  # noqa: E402
from repro.kernels.flash_attention import kernel as jfa_kernel  # noqa: E402
from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402

# (B, S, H, KV, D, window, softcap, dtype): tests/test_kernels.py's cases
FA_CASES = [
    (1, 128, 4, 2, 64, 0, 0.0, "float32"),
    (2, 256, 8, 8, 64, 0, 0.0, "float32"),
    (1, 256, 4, 1, 128, 0, 0.0, "bfloat16"),
    (1, 256, 8, 2, 64, 64, 0.0, "float32"),
    (1, 128, 4, 4, 64, 0, 50.0, "float32"),
    (1, 256, 2, 2, 256, 128, 30.0, "bfloat16"),
]
DA_CASES = [
    (2, 256, 8, 2, 64, 0, 0.0, "float32"),
    (1, 512, 4, 4, 64, 0, 0.0, "bfloat16"),
    (2, 256, 8, 8, 128, 0, 0.0, "float32"),
    (2, 256, 4, 2, 64, 128, 0.0, "float32"),
    (1, 256, 8, 4, 64, 0, 50.0, "float32"),
]


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _both(x, dtype):
    """One float32 numpy array as a JAX and a torch array of ``dtype``;
    bfloat16 rounds the same way (to nearest even) in both."""
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    t = torch.as_tensor(x).to(getattr(torch, dtype))
    return j, t


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _fa_inputs(B, S, H, KV, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, S, KV, D), np.float32)
    v = rng.standard_normal((B, S, KV, D), np.float32)
    return [_both(x, dtype) for x in (q, k, v)]


@pytest.mark.parametrize("B,S,H,KV,D,window,softcap,dtype", FA_CASES)
def test_mha_matches_reference_and_pallas(B, S, H, KV, D, window, softcap,
                                          dtype):
    (jq, tq), (jk, tk), (jv, tv) = _fa_inputs(B, S, H, KV, D, dtype)
    got = fa_ops.flash_attention(tq, tk, tv, causal=True, window=window,
                                 softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jfa_ref.mha(jq, jk, jv, causal=True, window=window,
                       softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    pallas = jfa_kernel.flash_attention(
        jq, jk, jv, causal=True, window=window, softcap=softcap,
        block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_mha_ragged_sequence(causal, window):
    """S = 100 is no multiple of any tile; the Pallas kernel cannot take
    it, so the port is held against the reference's plain version."""
    (jq, tq), (jk, tk), (jv, tv) = _fa_inputs(2, 100, 6, 2, 20, "float32",
                                              seed=5)
    got = fa_ref.mha(tq, tk, tv, causal=causal, window=window,
                     softcap=20.0)
    want = jfa_ref.mha(jq, jk, jv, causal=causal, window=window,
                       softcap=20.0)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


def _da_inputs(B, S, H, KV, D, dtype, seed=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), np.float32)
    kc = rng.standard_normal((B, S, KV, D), np.float32)
    vc = rng.standard_normal((B, S, KV, D), np.float32)
    pos = rng.integers(1, S - 1, (B,)).astype(np.int32)
    return [_both(x, dtype) for x in (q, kc, vc)], pos


@pytest.mark.parametrize("B,S,H,KV,D,window,softcap,dtype", DA_CASES)
def test_decode_attention_matches_reference_and_pallas(B, S, H, KV, D,
                                                       window, softcap,
                                                       dtype):
    ((jq, tq), (jk, tk), (jv, tv)), pos = _da_inputs(B, S, H, KV, D, dtype)
    got = da_ops.decode_attention(tq, tk, tv, torch.as_tensor(pos),
                                  window=window, softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jda_ref.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                    window=window, softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    pallas = jda_kernel.decode_attention(
        jq, jk, jv, jnp.asarray(pos), window=window, softcap=softcap,
        block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


def test_decode_attention_ragged_cache_and_edge_positions():
    """A 99-row cache; positions at the first row, past the last row, and
    one where the window keeps nothing."""
    ((jq, tq), (jk, tk), (jv, tv)), _ = _da_inputs(4, 99, 6, 3, 20,
                                                   "float32")
    pos = np.array([0, 98, 140, 57], np.int32)
    for window in (0, 16):
        got = da_ref.decode_attention(tq, tk, tv, torch.as_tensor(pos),
                                      window=window, softcap=10.0)
        want = jda_ref.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                        window=window, softcap=10.0)
        np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


def test_cuda_impl_on_cpu_tensors_raises():
    (_, tq), (_, tk), (_, tv) = _fa_inputs(1, 8, 2, 1, 8, "float32")
    with pytest.raises(ValueError, match="CUDA device"):
        fa_ops.flash_attention(tq, tk, tv, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        da_ops.decode_attention(tq[:, 0], tk, tv,
                                torch.zeros(1, dtype=torch.int32),
                                impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        fa_ops.flash_attention(tq, tk, tv, impl="pallas")
