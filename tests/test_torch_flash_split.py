"""The arithmetic of ``flash_attention``'s 3xTF32 split, on the CPU.

The CUDA kernel runs both products of float32 attention (q.k and p.v)
on the tensor cores in TF32, each operand x split into hi, x rounded to
TF32 (10 mantissa bits, half away from zero: what ``cvt.rna.tf32.f32``
does, ``(bits + 0x1000) & ~0x1fff`` on the float32 bits), and lo = x -
hi, of which the tensor core reads the TF32 part; a.b is summed as
a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.  This file emulates that on the
float32 bits (the products of TF32 values are exact, and are summed
here in float64) and holds it against the plain version at SmolLM-360M's
and Qwen3-MoE's head shapes with S cut to 128: within the kernel's 2e-5
tolerance with the split, whether the tensor core rounds lo or drops its
low bits, and beyond it with one TF32 product (the reason for the
split).  The emulation lives here; the port's main path does not use it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)  # the kernel's float32 tolerance
# (B, S, H, KV, D): SmolLM-360M's and Qwen3-MoE's heads, S cut to 128
SHAPES = {"smollm-360m": (1, 128, 15, 5, 64),
          "qwen3-moe": (1, 128, 64, 4, 128)}


def tf32(x, mode="rna"):
    """x (float32) rounded to TF32 on its bits: half away from zero
    ("rna"), or with the low 13 bits dropped ("trunc")."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    if mode == "rna":
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(x, lo_mode):
    x = np.asarray(x, np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi, lo_mode)


def product(a, b, subscripts, terms, lo_mode):
    """einsum(subscripts, a, b) with TF32 operands: ``terms`` 3 for the
    split (a_lo.b_hi + a_hi.b_lo + a_hi.b_hi), 1 for a_hi.b_hi alone;
    products exact, summed in float64."""
    (ah, al), (bh, bl) = split(a, lo_mode), split(b, lo_mode)
    pairs = [(ah, bh)] + ([(al, bh), (ah, bl)] if terms == 3 else [])
    return sum(np.einsum(subscripts, x.astype(np.float64),
                         y.astype(np.float64)) for x, y in pairs)


def emulated_mha(q, k, v, terms, lo_mode="rna"):
    """Causal GQA attention as the kernel computes it: s = q.k in TF32
    products, times 1/sqrt(D); p = exp(s - max) unnormalised, rounded to
    float32; out = (p.v in TF32 products) / sum p."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D)
    s = product(qg, k, "bskgd,btkd->bkgst", terms, lo_mode)
    s = (s * np.float32(1.0 / np.sqrt(D))).astype(np.float32)
    s = np.where(np.tril(np.ones((S, S), bool)), s, np.float32(-2.0**30))
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    o = product(p, v, "bkgst,btkd->bskgd", terms, lo_mode)
    o = o / p.astype(np.float64).sum(-1).transpose(0, 3, 1, 2)[..., None]
    return o.reshape(B, S, H, D).astype(np.float32)


def _inputs(shape, seed=0):
    B, S, H, KV, D = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32))


def _plain(q, k, v):
    return ref.mha(torch.as_tensor(q), torch.as_tensor(k),
                   torch.as_tensor(v)).numpy()


def test_tf32_rounding_is_round_half_away_from_zero():
    ulp = 2.0**-10  # TF32's spacing at 1
    x = np.array([1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                  1 + ulp, 3.0], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([1 + ulp, 1, 1 + ulp, -(1 + ulp), 1 + ulp, 3.0],
                          np.float32))
    np.testing.assert_array_equal(tf32(x, "trunc"),
                                  np.array([1, 1, 1, -1, 1 + ulp, 3.0],
                                           np.float32))


@pytest.mark.parametrize("lo_mode", ["rna", "trunc"])
@pytest.mark.parametrize("arch", list(SHAPES))
def test_three_tf32_products_meet_the_float32_tolerance(arch, lo_mode):
    q, k, v = _inputs(SHAPES[arch])
    got = emulated_mha(q, k, v, terms=3, lo_mode=lo_mode)
    np.testing.assert_allclose(got, _plain(q, k, v), **TOL)


@pytest.mark.parametrize("arch", list(SHAPES))
def test_one_tf32_product_misses_the_float32_tolerance(arch):
    q, k, v = _inputs(SHAPES[arch])
    want = _plain(q, k, v)
    err = np.abs(emulated_mha(q, k, v, terms=1) - want)
    assert (err > TOL["atol"] + TOL["rtol"] * np.abs(want)).any()
    assert err.max() > 20 * TOL["atol"]  # by far: about 1e-3
