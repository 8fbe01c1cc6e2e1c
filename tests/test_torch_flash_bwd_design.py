"""The arithmetic of the flash-attention backward kernel, on the CPU.

The CUDA backward (``csrc/flash_attention_bwd.cu``) runs its products on
the tensor cores: in bfloat16 with float32 sums, p and ds rounded to
bfloat16 where they become operands; in float32 as three TF32 products
each (a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, hi = x rounded to TF32 half
away from zero on the bits, lo = x - hi of which the tensor core reads
the TF32 part).  This file holds the plain backward (``ref.mha_backward``,
autograd of ``ref.mha``) against the JAX package's gradient (``jax.vjp``
of ``repro.kernels.flash_attention.ref.mha``) on the same numpy inputs,
then emulates the kernel's roundings in torch and shows that they meet
``chip_smoke.py``'s tolerance against that gradient: |diff| <= tol (max
|want| + |want|), 2e-2 in bfloat16 and 1e-4 in float32.  Cases:
SmolLM-360M's heads (15 over 5, head_dim 64) with S cut to 128, and a
ragged S with a padded head_dim under a window and a softcap.  The
emulation lives here; the port's main path does not use it.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

LOG2E = 1.4426950408889634
# (B, S, H, KV, D, window, softcap), dtype
CASES = {
    "smollm-bf16": ((1, 128, 15, 5, 64, 0, 0.0), "bfloat16"),
    "smollm-f32": ((1, 128, 15, 5, 64, 0, 0.0), "float32"),
    "ragged-bf16": ((2, 100, 6, 2, 20, 24, 20.0), "bfloat16"),
    "ragged-f32": ((2, 100, 6, 2, 20, 24, 20.0), "float32"),
}


@contextlib.contextmanager
def one_thread():
    """One intra-op thread for these small tensors: the test workers'
    other processes take the cores, and torch's threads then contend
    (~50x slower here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def bwd_tol(dtype):
    """chip_smoke.py's tolerance of the backward kernel."""
    return 2e-2 if dtype == "bfloat16" else 1e-4


def tf32(x: torch.Tensor, mode: str = "rna") -> torch.Tensor:
    """float32 x rounded to TF32 on its bits: half away from zero
    ("rna"), or with the low 13 bits dropped ("trunc")."""
    bits = x.float().contiguous().view(torch.int32)
    if mode == "rna":
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def product(a, b, subscripts, dtype, terms=3):
    """einsum(subscripts, a, b) as the kernel's MMAs take it: bfloat16
    operands (exact products, float32 sums); float32 ones split into
    TF32 parts (``terms`` 3: lo.hi + hi.lo + hi.hi, 1: hi.hi), the
    tensor core reading lo's TF32 part.  Sums in float64, rounded to
    float32."""
    if dtype == "bfloat16":
        pairs = [(a.bfloat16(), b.bfloat16())]
    else:
        ah, bh = tf32(a), tf32(b)
        al, bl = tf32(a - ah, "trunc"), tf32(b - bh, "trunc")
        pairs = [(ah, bh)] + ([(al, bh), (ah, bl)] if terms == 3 else [])
    return sum(torch.einsum(subscripts, x.double(), y.double())
               for x, y in pairs).float()


def masks(S, causal, window):
    si = torch.arange(S)[:, None]
    ti = torch.arange(S)[None, :]
    keep = torch.ones((S, S), dtype=torch.bool)
    if causal:
        keep &= ti <= si
    if window > 0:
        keep &= ti > si - window
    return keep


def emulated_backward(q, k, v, dout, *, window, softcap, dtype, terms=3):
    """(dq, dk, dv) as the kernel computes them, causal: s and dO . v
    by the MMAs, p = exp2(s log2(e) - lse) from the forward's logsumexp
    (taken exact here), D = dO . o from the output in q's dtype, ds =
    p (dO . v - D) (1 - t^2) scale; in bfloat16 p and ds rounded to
    bfloat16 before the products; dK and dV summed over each KV head's
    query heads in float32, the gradients stored in q's dtype."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kk, vv = (x.repeat_interleave(G, dim=2) for x in (k, v))
    scale = 1.0 / math.sqrt(D)
    keep = masks(S, True, window)
    s = product(q, kk, "bshd,bthd->bhst", dtype)
    # the forward's logsumexp and output, exact
    s64 = torch.einsum("bshd,bthd->bhst", q.double(), kk.double()) * scale
    if softcap > 0.0:
        s64 = softcap * torch.tanh(s64 / softcap)
    s64 = torch.where(keep, s64, -math.inf)
    lse = (torch.logsumexp(s64, -1) * LOG2E).float()
    o = torch.einsum("bhst,bthd->bshd", torch.softmax(s64, -1), vv.double())
    o = o.to(getattr(torch, dtype)).float()
    if softcap > 0.0:
        t = torch.tanh(s * (scale / softcap))
        x = (softcap * LOG2E) * t
    else:
        t = torch.zeros_like(s)
        x = s * (scale * LOG2E)
    p = torch.where(keep, torch.exp2(x - lse[..., None]), 0.0)
    dp = product(dout, vv, "bshd,bthd->bhst", dtype)
    delta = (dout * o).sum(-1).transpose(1, 2)  # (B, H, S)
    ds = p * (dp - delta[..., None]) * (1.0 - t * t) * scale
    if dtype == "bfloat16":
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dv = product(p, dout, "bhst,bshd->bthd", dtype, terms)
    dk = product(ds, q, "bhst,bshd->bthd", dtype, terms)
    dq = product(ds, kk, "bhst,bthd->bshd", dtype, terms)
    dk, dv = (x.reshape(B, S, -1, G, D).sum(3) for x in (dk, dv))
    cast = getattr(torch, dtype)
    return tuple(x.to(cast).float().numpy() for x in (dq, dk, dv))


def _inputs(case):
    (B, S, H, KV, D, window, softcap), dtype = CASES[case]
    rng = np.random.default_rng(S + H + D)
    out = []
    for n in (H, KV, KV, H):
        x = torch.from_numpy(rng.standard_normal((B, S, n, D), np.float32))
        out.append(x.to(getattr(torch, dtype)).float().numpy())
    return out


_JAX = {}


def _jax_grad(case):
    """(inputs, the JAX package's gradient) of ``case``: one jitted vjp
    a case, kept for the module."""
    if case not in _JAX:
        (B, S, H, KV, D, window, softcap), dtype = CASES[case]
        q, k, v, dout = _inputs(case)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

        @jax.jit
        def grad(q, k, v, dout):
            f = lambda q, k, v: jref.mha(  # noqa: E731
                q, k, v, causal=True, window=window, softcap=softcap)
            return jax.vjp(f, q, k, v)[1](dout)

        got = grad(*(jnp.asarray(x).astype(jdt) for x in (q, k, v, dout)))
        _JAX[case] = ((q, k, v, dout),
                      [np.asarray(g.astype(jnp.float32)) for g in got])
    return _JAX[case]


@pytest.fixture(scope="module")
def jax_grad():
    return _jax_grad


def _assert_close(got, want, tol, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, (what, name)
        assert np.isfinite(g).all(), (what, name)
        err = np.abs(g - w)
        bound = tol * (np.abs(w).max() + np.abs(w))
        assert (err <= bound).all(), (
            f"{what} {name}: max |diff| {err.max():.3g} at scale "
            f"{np.abs(w).max():.3g}")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_the_jax_gradient(case, jax_grad):
    (shape, dtype) = CASES[case]
    (q, k, v, dout), want = jax_grad(case)
    dt = getattr(torch, dtype)
    with one_thread():
        got = ref.mha_backward(*(torch.from_numpy(x).to(dt)
                                 for x in (q, k, v, dout)),
                               causal=True, window=shape[5],
                               softcap=shape[6])
    # both differentiate float32 logits; bfloat16 gradients may round
    # apart by an ulp
    _assert_close([g.float().numpy() for g in got], want,
                  8e-3 if dtype == "bfloat16" else 4e-6, case)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_roundings_meet_the_tolerance(case, jax_grad):
    (shape, dtype) = CASES[case]
    (q, k, v, dout), want = jax_grad(case)
    with one_thread():
        got = emulated_backward(*(torch.from_numpy(x)
                                  for x in (q, k, v, dout)),
                                window=shape[5], softcap=shape[6],
                                dtype=dtype)
    _assert_close(got, want, bwd_tol(dtype), case)


def test_one_tf32_product_misses_the_float32_tolerance(jax_grad):
    """One TF32 product for dV, dK and dQ (the products that take p and
    ds) misses 1e-4: the reason for the split."""
    case = "smollm-f32"
    (q, k, v, dout), want = jax_grad(case)
    with one_thread():
        got = emulated_backward(*(torch.from_numpy(x)
                                  for x in (q, k, v, dout)),
                                window=0, softcap=0.0, dtype="float32",
                                terms=1)
    tol = bwd_tol("float32")
    misses = [bool((np.abs(g - w) > tol * (np.abs(w).max() + np.abs(w)))
                   .any()) for g, w in zip(got, want)]
    assert any(misses)
