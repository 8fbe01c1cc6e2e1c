"""The port's attention functions against the JAX reference on the CPU.

The plain ``mha`` and ``decode_attention`` of the port are held against
the reference's plain versions and against its Pallas kernels run in
interpret mode, on ``tests/test_kernels.py``'s cases, with that file's
tolerance: 2e-5 (relative and absolute) in float32, 2e-2 in bfloat16.
Inputs are made with numpy and handed to both.

The CUDA ``decode_attention`` cannot run here; its arithmetic can.  Its
split plan must cover every cache row once, a few lines of torch that
split a cache as the kernel does, reduce each span to (m, l, acc) tile
by tile and merge the spans in split order must give the plain
version's result within 1e-6, and its buffers for a stream are made
once, grown on demand and never made in a CUDA-graph capture.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import kernel as jda_kernel  # noqa: E402
from repro.kernels.decode_attention import ref as jda_ref  # noqa: E402
from repro.kernels.flash_attention import kernel as jfa_kernel  # noqa: E402
from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    kernel as da_kernel,
)
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


# (B, S, H, KV, D): the card tests' DA_SHAPES and the two serving shapes
SPLIT_SHAPES = [
    (2, 256, 8, 2, 64), (1, 512, 4, 4, 64), (2, 256, 8, 8, 128),
    (2, 256, 4, 2, 64), (1, 256, 8, 4, 64), (4, 99, 6, 3, 20),
    (2, 300, 24, 2, 256), (1, 547, 15, 5, 64), (3, 400, 8, 2, 64),
    (2, 300, 8, 2, 64), (1, 544, 15, 5, 64), (1, 544, 64, 4, 128),
    (64, 4096, 32, 8, 128), (1, 1, 2, 1, 8), (1, 65536, 64, 4, 128),
]
SERVING = [(1, 544, 15, 5, 64), (1, 544, 64, 4, 128)]


@pytest.mark.parametrize("B,S,H,KV,D", SPLIT_SHAPES)
def test_split_plan_covers_every_row_once(B, S, H, KV, D):
    span, splits = da_kernel.split_plan(B, S, KV)
    assert span >= 1
    seen = np.zeros(S, np.int64)
    for sp in range(splits):
        seen[sp * span:min(S, (sp + 1) * span)] += 1
    assert (seen == 1).all()
    assert da_kernel.smem_bytes(D, H // KV, span, splits) \
        <= da_kernel.MAX_SMEM
    # about one block per SM and at most MAX_SPLITS spans to merge, at
    # any S: a longer cache makes longer spans
    assert splits <= da_kernel.MAX_SPLITS
    assert B * KV * splits <= max(da_kernel.SMS, B * KV)
    if (B, S, H, KV, D) in SERVING:
        assert splits == da_kernel.MAX_SPLITS
        assert B * KV * splits >= 0.7 * da_kernel.SMS


def _reduce_span(qg, k, v, scale, softcap, none):
    """(m, l, acc) of one span's kept rows, walked TILE rows at a time
    with the online softmax: a later tile rescales l and acc by
    exp(m_old - m)."""
    G, D = qg.shape[0], v.shape[1]
    m, l, acc = torch.full((G,), -math.inf), torch.zeros(G), torch.zeros(G, D)
    for t0 in range(0, k.shape[0], da_kernel.TILE):
        kt, vt = k[t0:t0 + da_kernel.TILE], v[t0:t0 + da_kernel.TILE]
        s = qg @ kt.T * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        if none:
            s = torch.full_like(s, da_ref.NEG_INF)
        m_new = torch.maximum(m, s.max(-1).values)
        a = torch.exp(m - m_new)
        pj = torch.exp(s - m_new[:, None])
        l, acc, m = l * a + pj.sum(-1), acc * a[:, None] + pj @ vt, m_new
    return m, l, acc


def _split_decode(q, kc, vc, pos, window, softcap, span):
    """The kernel's arithmetic in torch: per (row, KV head) the kept rows
    of each span reduced to (m, l, acc) over the G heads, then merged in
    split order; a span with no kept row has weight 0."""
    B, H, D = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    splits = -(-S // span)
    out = torch.empty(B, H, D)
    for b in range(B):
        p = int(pos[b])
        hi = min(p, S - 1)
        lo = max(0, p - window + 1) if window > 0 else 0
        none = lo > hi
        lo, hi = (0, S - 1) if none else (lo, hi)
        for kv in range(KV):
            qg = q[b, kv * G:(kv + 1) * G].float()
            recs = []
            for sp in range(splits):
                r0, r1 = max(sp * span, lo), min(sp * span + span - 1, hi)
                if r1 < r0:
                    recs.append((torch.full((G,), da_ref.NEG_INF),
                                 torch.zeros(G), torch.zeros(G, D)))
                    continue
                recs.append(_reduce_span(
                    qg, kc[b, r0:r1 + 1, kv].float(),
                    vc[b, r0:r1 + 1, kv].float(), 1 / math.sqrt(D), softcap,
                    none))
            M = torch.full((G,), da_ref.NEG_INF)
            for m, l, _ in recs:
                M = torch.where(l > 0, torch.maximum(M, m), M)
            L, acc = torch.zeros(G), torch.zeros(G, D)
            for m, l, a in recs:
                w = torch.where(l > 0, torch.exp(m - M), torch.zeros(G))
                L, acc = L + l * w, acc + w[:, None] * a
            out[b, kv * G:(kv + 1) * G] = acc / L.clamp_min(1e-30)[:, None]
    return out


# (B, S, H, KV, D, window, softcap, positions, span or None for the plan)
SPLIT_CASES = [
    (1, 544, 15, 5, 64, 0, 0.0, [543], None),  # SmolLM-360M, plan
    (1, 544, 64, 4, 32, 0, 0.0, [543], None),  # G = 16, narrow D
    (3, 400, 8, 2, 64, 0, 0.0, [5, 201, 399], None),  # empty spans
    (2, 99, 6, 3, 20, 0, 10.0, [-1, 40], 8),  # nothing kept
    (2, 99, 6, 3, 20, 16, 0.0, [120, 98], 8),  # pos >= S, window
    (2, 300, 8, 2, 64, 3, 0.0, [151, 0], 4),  # window inside a span
    (1, 70, 4, 1, 16, 5, 0.0, [-1], 1),  # nothing kept, one-row spans
    (1, 3000, 8, 4, 32, 0, 0.0, [2999], None),  # plan: spans of 4 tiles
    (1, 1000, 4, 2, 16, 70, 5.0, [600], 50),  # window over ragged tiles
    (2, 200, 4, 1, 16, 0, 0.0, [-1, 150], 100),  # nothing kept, 4 tiles
]


@pytest.mark.parametrize("B,S,H,KV,D,window,softcap,positions,span",
                         SPLIT_CASES)
def test_split_merge_matches_plain_decode(B, S, H, KV, D, window, softcap,
                                          positions, span):
    rng = np.random.default_rng(S + H + D)
    q, kc, vc = (torch.as_tensor(rng.standard_normal(shape, np.float32))
                 for shape in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
    pos = torch.tensor(positions, dtype=torch.int32)
    if span is None:
        span = da_kernel.split_plan(B, S, KV)[0]
    got = _split_decode(q, kc, vc, pos, window, softcap, span)
    want = da_ref.decode_attention(q, kc, vc, pos, window=window,
                                   softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_decode_buffers_are_made_once_per_stream(monkeypatch):
    """A stream's buffer is made zeroed, reused while it is large enough
    and replaced by a larger one (the older kept for captured graphs);
    another stream gets its own; none is made while a graph captures."""
    table = {}
    a = da_kernel._buffer(table, (0, 1), 10, torch.int32, "cpu")
    assert a.numel() == 1024 and not a.any()
    assert da_kernel._buffer(table, (0, 1), 1024, torch.int32, "cpu") is a
    b = da_kernel._buffer(table, (0, 2), 10, torch.int32, "cpu")
    assert b is not a
    c = da_kernel._buffer(table, (0, 1), 5000, torch.float32, "cpu")
    assert c.numel() == 5000 and table[(0, 1)] == [a, c]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert da_kernel._buffer(table, (0, 1), 5000, torch.int32, "cpu") is c
    with pytest.raises(RuntimeError, match="before a CUDA graph"):
        da_kernel._buffer(table, (0, 1), 5001, torch.int32, "cpu")
    with pytest.raises(RuntimeError, match="before a CUDA graph"):
        da_kernel._buffer(table, (0, 3), 1, torch.int32, "cpu")
