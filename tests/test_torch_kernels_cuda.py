"""The port's CUDA kernels against their plain versions, on the card.

``route_select`` must equal its plain version bit for bit;
``flash_attention`` and ``decode_attention`` must agree within the JAX
suite's tolerance (2e-5 relative and absolute in float32, 2e-2 in
bfloat16), on tests/test_kernels.py's shapes, the serving shapes of
SmolLM-360M (a 512-token prompt, a 544-row cache, 15 query heads over
5 KV heads, head_dim 64), Qwen3-MoE's prefill and decode shapes (64
query heads over 4 KV heads, head_dim 128), a ragged sequence and a
padded head_dim; ``flash_attention`` also with a ragged sequence in
bfloat16 at each padded head_dim (64, 128, 256), 16 heads a KV group
with a window narrower than a key tile, rows no multiple of 16 bytes
(copied element by element), other block tilings than the
plan's, bitwise equal on a repeated call and replayed from a CUDA
graph; ``decode_attention`` also with a cache not a multiple of its
span, rows at other positions, a window narrower than a span, a
65536-row cache (spans of many tiles), nothing kept (pos -1), other
spans than the plan's, launches on two streams at once and replayed
from a CUDA graph, and bitwise equal on a repeated call.
``chunk_scan`` must agree within 1e-4 (relative and absolute, the JAX
suite's tolerance for the Pallas chunk kernel) on that suite's shapes,
a ragged d_inner, bfloat16 inputs, d_state 3 and 64, chunks longer
than the kernel's staging pass and ragged against it (37 and 161
steps), falcon-mamba's smoke shape and its serving shape (a 128-step
chunk of d_inner 8192, d_state 16).
``dispatch_fused`` and ``dispatch_candidates`` must equal their plain
versions bit for bit on the experts, the candidates and the steered
flags, with weights within 1e-6, on tests/test_kernels.py's MR shapes,
ragged T, exact ties and qwen3-moe's serving shapes (E 128, top-8,
d 2, a 512-token prompt and one decode token).

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

from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.midas_route import ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as ssm_ref  # noqa: E402

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


# (B, S, H, KV, D, window, softcap, dtype)
FA_SHAPES = [
    (1, 128, 4, 2, 64, 0, 0.0, "float32"),  # tests/test_kernels.py
    (2, 256, 8, 8, 64, 0, 0.0, "float32"),
    (1, 256, 4, 1, 128, 0, 0.0, "bfloat16"),
    (1, 256, 8, 2, 64, 64, 0.0, "float32"),
    (1, 128, 4, 4, 64, 0, 50.0, "float32"),
    (1, 256, 2, 2, 256, 128, 30.0, "bfloat16"),
    (1, 512, 15, 5, 64, 0, 0.0, "float32"),  # SmolLM-360M prefill
    (2, 100, 6, 2, 20, 24, 20.0, "float32"),  # ragged S, padded D
    (1, 333, 8, 4, 256, 0, 0.0, "float32"),  # ragged S at D = 256
    (3, 16, 3, 1, 20, 0, 0.0, "float32"),  # the smoke config's heads
    (1, 512, 64, 4, 128, 0, 0.0, "float32"),  # Qwen3-MoE prefill
    (1, 333, 6, 2, 64, 0, 0.0, "bfloat16"),  # ragged S at each padded D
    (1, 301, 8, 2, 128, 0, 0.0, "bfloat16"),
    (1, 197, 4, 1, 256, 0, 0.0, "bfloat16"),
    (1, 300, 32, 2, 64, 24, 0.0, "float32"),  # G = 16, a narrow window
    # rows no multiple of 16 bytes: copied element by element
    (2, 77, 4, 2, 30, 0, 0.0, "bfloat16"),
    (1, 50, 2, 1, 7, 16, 5.0, "float32"),
]
# block tilings (gh, nb, ks) other than the plan's, each on the shapes
# whose head groups and head_dim take it: one warp a block, 64-row query
# tiles of one head (the CUDA-core kernel's grid), 4 or 2 warps
# splitting a strip's keys, and two heads by two strips by two splits
FA_PLANS = [(1, 1, 1), (1, 4, 1), (1, 1, 4), (1, 2, 2), (2, 2, 2)]
DA_SHAPES = [
    (2, 256, 8, 2, 64, 0, 0.0, "float32"),  # tests/test_kernels.py
    (1, 512, 4, 4, 64, 0, 0.0, "bfloat16"),
    (2, 256, 8, 8, 128, 0, 0.0, "float32"),
    (2, 256, 4, 2, 64, 128, 0.0, "float32"),
    (1, 256, 8, 4, 64, 0, 50.0, "float32"),
    (1, 544, 15, 5, 64, 0, 0.0, "float32"),  # SmolLM-360M decode
    (4, 99, 6, 3, 20, 16, 10.0, "float32"),  # ragged S, padded D
    (2, 300, 24, 2, 256, 0, 0.0, "bfloat16"),  # G = 12, D = 256
    (1, 65536, 64, 4, 128, 0, 0.0, "float32"),  # spans of many tiles
    (1, 544, 64, 4, 128, 0, 0.0, "float32"),  # Qwen3-MoE decode
    (1, 547, 15, 5, 64, 0, 0.0, "float32"),  # S no multiple of the span
    (3, 400, 8, 2, 64, 0, 0.0, "float32"),  # rows with other positions
    (2, 300, 8, 2, 64, 3, 0.0, "float32"),  # window narrower than a span
]
# spans (rows a block takes) other than the split plan's: one-row spans
# (up to 547 records to merge), 5, 7, one whole tile (32) and two tiles
# and a ragged third (75)
DA_SPANS = [1, 5, 7, 32, 75]


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _randn(rng, shape, dtype):
    x = rng.standard_normal(shape, np.float32)
    return torch.as_tensor(x).to(getattr(torch, dtype)).cuda()


@pytest.mark.requires_cuda
def test_cuda_flash_attention_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel

    before = kernel.flash_attention.launches
    for B, S, H, KV, D, window, cap, dtype in FA_SHAPES:
        rng = np.random.default_rng(S + H + D)
        q = _randn(rng, (B, S, H, D), dtype)
        k = _randn(rng, (B, S, KV, D), dtype)
        v = _randn(rng, (B, S, KV, D), dtype)
        for causal in (True, False):
            kw = dict(causal=causal, window=window, softcap=cap)
            got = kernel.flash_attention(q, k, v, **kw)
            want = fa_ref.mha(q, k, v, **kw)
            torch.cuda.synchronize()
            assert got.dtype == q.dtype and got.shape == q.shape
            np.testing.assert_allclose(
                got.float().cpu().numpy(), want.float().cpu().numpy(),
                **_tol(dtype), err_msg=str((B, S, H, KV, D, kw, dtype)))
    assert kernel.flash_attention.launches == before + 2 * len(FA_SHAPES)


def _fa_inputs(shape, seed):
    B, S, H, KV, D, _, _, dtype = shape
    rng = np.random.default_rng(seed)
    return tuple(_randn(rng, (B, S, n, D), dtype) for n in (H, KV, KV))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("plan", FA_PLANS)
def test_cuda_flash_attention_plan_overrides(plan, monkeypatch):
    """Other block tilings than the plan's give the plain version's
    result within the tolerance, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel

    gh, nb, ks = plan
    monkeypatch.setattr(kernel, "tile_plan", lambda *a: plan)
    kernel._plan.cache_clear()
    before = kernel.flash_attention.launches
    calls = 0
    for shape in FA_SHAPES:
        B, S, H, KV, D, window, cap, dtype = shape
        if ((H // KV) % gh or gh * nb * ks > (4 if D > 128 else 8)
                or ks > (2 if D > 128 else 4)):
            continue
        q, k, v = _fa_inputs(shape, S + H + D + ks)
        kw = dict(causal=True, window=window, softcap=cap)
        got = kernel.flash_attention(q, k, v, **kw)
        want = fa_ref.mha(q, k, v, **kw)
        torch.cuda.synchronize()
        calls += 1
        np.testing.assert_allclose(
            got.float().cpu().numpy(), want.float().cpu().numpy(),
            **_tol(dtype), err_msg=str((shape, plan)))
    kernel._plan.cache_clear()  # the plan is restored after the test
    assert calls >= 5
    assert kernel.flash_attention.launches == before + calls


@pytest.mark.requires_cuda
def test_cuda_flash_attention_is_bitwise_repeatable():
    """The key splits merge in warp order: a repeated call is bitwise
    equal, at every shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel

    for shape in FA_SHAPES:
        q, k, v = _fa_inputs(shape, 11)
        kw = dict(causal=True, window=shape[5], softcap=shape[6])
        first = kernel.flash_attention(q, k, v, **kw)
        for _ in range(3):
            assert torch.equal(first, kernel.flash_attention(q, k, v, **kw)), \
                shape


@pytest.mark.requires_cuda
def test_cuda_flash_attention_in_a_cuda_graph():
    """A call captured in a warmed CUDA graph replays the eager call's
    result, bit for bit, at both prefill shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel

    for shape in [(1, 512, 15, 5, 64, 0, 0.0, "float32"),
                  (1, 512, 64, 4, 128, 0, 0.0, "float32")]:
        q, k, v = _fa_inputs(shape, 5)
        eager = kernel.flash_attention(q, k, v)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel.flash_attention(q, k, v)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kernel.flash_attention.launches
        with torch.cuda.graph(graph, stream=side):
            out = kernel.flash_attention(q, k, v)
        assert kernel.flash_attention.launches == before + 1
        for _ in range(3):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager), shape


@pytest.mark.requires_cuda
def test_cuda_decode_attention_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.decode_attention import kernel

    before = kernel.decode_attention.launches
    calls = 0
    for B, S, H, KV, D, window, cap, dtype in DA_SHAPES:
        rng = np.random.default_rng(S + H + D)
        q = _randn(rng, (B, H, D), dtype)
        kc = _randn(rng, (B, S, KV, D), dtype)
        vc = _randn(rng, (B, S, KV, D), dtype)
        # random rows (one per batch row), the first and last row, past
        # the end, and nothing kept (-1; with a window, also S + 40)
        for pos in (rng.integers(1, S - 1, (B,)), [0] * B, [S - 1] * B,
                    [S + 40] * B, [-1] * B):
            pos = torch.as_tensor(np.asarray(pos, np.int32)).cuda()
            kw = dict(window=window, softcap=cap)
            got = kernel.decode_attention(q, kc, vc, pos, **kw)
            want = da_ref.decode_attention(q, kc, vc, pos, **kw)
            torch.cuda.synchronize()
            calls += 1
            assert got.dtype == q.dtype and got.shape == q.shape
            np.testing.assert_allclose(
                got.float().cpu().numpy(), want.float().cpu().numpy(),
                **_tol(dtype),
                err_msg=str((B, S, H, KV, D, window, cap, dtype, pos)))
            # the merge runs in split order: a repeat is bitwise equal
            again = kernel.decode_attention(q, kc, vc, pos, **kw)
            calls += 1
            assert torch.equal(got, again)
    assert kernel.decode_attention.launches == before + calls


@pytest.mark.requires_cuda
@pytest.mark.parametrize("span", DA_SPANS)
def test_cuda_decode_attention_span_overrides(span, monkeypatch):
    """Other spans than the plan's give the same result within the
    tolerance, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.decode_attention import kernel

    monkeypatch.setattr(kernel, "split_plan",
                        lambda B, S, KV: (span, -(-S // span)))
    kernel._plan.cache_clear()
    before = kernel.decode_attention.launches
    calls = 0
    for B, S, H, KV, D, window, cap, dtype in DA_SHAPES[-4:]:
        rng = np.random.default_rng(S + H + D + span)
        q = _randn(rng, (B, H, D), dtype)
        kc = _randn(rng, (B, S, KV, D), dtype)
        vc = _randn(rng, (B, S, KV, D), dtype)
        for pos in (rng.integers(0, S, (B,)), [-1] * B):
            pos = torch.as_tensor(np.asarray(pos, np.int32)).cuda()
            kw = dict(window=window, softcap=cap)
            got = kernel.decode_attention(q, kc, vc, pos, **kw)
            want = da_ref.decode_attention(q, kc, vc, pos, **kw)
            torch.cuda.synchronize()
            calls += 1
            np.testing.assert_allclose(
                got.float().cpu().numpy(), want.float().cpu().numpy(),
                **_tol(dtype), err_msg=str((B, S, H, KV, D, span, pos)))
    kernel._plan.cache_clear()  # the plan is restored after the test
    assert kernel.decode_attention.launches == before + calls


def _decode_inputs(shape, seed):
    B, S, H, KV, D, _, _, dtype = shape
    rng = np.random.default_rng(seed)
    return (_randn(rng, (B, H, D), dtype), _randn(rng, (B, S, KV, D), dtype),
            _randn(rng, (B, S, KV, D), dtype),
            torch.as_tensor(rng.integers(0, S, (B,)).astype(np.int32)).cuda())


@pytest.mark.requires_cuda
def test_cuda_decode_attention_on_two_streams_at_once():
    """Launches in two streams that overlap keep to their own counters
    and workspace: both give the plain version's result every time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.decode_attention import kernel

    shapes = [(1, 544, 15, 5, 64, 0, 0.0, "float32"),
              (1, 544, 64, 4, 128, 0, 0.0, "float32")]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    args = [_decode_inputs(s, i) for i, s in enumerate(shapes)]
    wants = [da_ref.decode_attention(*a) for a in args]
    torch.cuda.synchronize()
    before = kernel.decode_attention.launches
    outs = [[], []]
    for _ in range(50):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(kernel.decode_attention(*args[i]))
    torch.cuda.synchronize()
    assert kernel.decode_attention.launches == before + 100
    for i, shape in enumerate(shapes):
        for got in outs[i]:
            np.testing.assert_allclose(
                got.cpu().numpy(), wants[i].cpu().numpy(),
                **_tol(shape[-1]), err_msg=str(shape))


@pytest.mark.requires_cuda
def test_cuda_decode_attention_in_a_cuda_graph():
    """Called once in a stream, the kernel is captured in that stream
    and replays the plain version's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.decode_attention import kernel

    shape = (1, 544, 64, 4, 128, 0, 0.0, "float32")
    q, kc, vc, pos = _decode_inputs(shape, 3)
    want = da_ref.decode_attention(q, kc, vc, pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel.decode_attention(q, kc, vc, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kernel.decode_attention.launches
    with torch.cuda.graph(graph, stream=side):
        out = kernel.decode_attention(q, kc, vc, pos)
    assert kernel.decode_attention.launches == before + 1
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   **_tol("float32"))


@pytest.mark.requires_cuda
def test_cuda_attention_kernels_reject_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.flash_attention import kernel as fa

    rng = np.random.default_rng(0)
    q = _randn(rng, (1, 8, 4, 64), "float32")
    k = _randn(rng, (1, 8, 2, 64), "float32")
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, k.transpose(1, 2).contiguous().transpose(
            1, 2), k)
    with pytest.raises(ValueError, match="head_dim"):
        big = _randn(rng, (1, 8, 2, 320), "float32")
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q.cpu(), k.cpu(), k.cpu())
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="pos"):
        da.decode_attention(q[:, 0], k, k, pos.long())
    with pytest.raises(ValueError, match="split"):
        da.decode_attention(q[:, 0, :3], k, k, pos)


# (Bt, Q, DI, ST, dtype)
CS_SHAPES = [
    (2, 16, 32, 8, "float32"),  # tests/test_kernels.py
    (1, 32, 64, 16, "float32"),
    (2, 16, 32, 8, "bfloat16"),
    (2, 40, 100, 16, "float32"),  # ragged DI
    (1, 200, 24, 64, "float32"),  # ST = 64, Q past one staging pass
    (3, 5, 33, 3, "bfloat16"),  # ST < one lane's four states
    (1, 16, 128, 8, "float32"),  # falcon-mamba smoke
    (1, 128, 8192, 16, "float32"),  # falcon-mamba-7b prefill chunk
    # Q neither a multiple of the 32-step pass nor under one pass
    (1, 37, 64, 16, "float32"),
    (2, 161, 100, 16, "float32"),
    (1, 37, 24, 64, "bfloat16"),
    (1, 161, 48, 64, "float32"),
]


def _scan_inputs(rng, Bt, Q, DI, ST, dtype):
    dt = np.logaddexp(rng.standard_normal((Bt, Q, DI), np.float32), 0.0)
    A = -np.exp(rng.standard_normal((DI, ST), np.float32) * 0.5)
    h0 = torch.as_tensor(rng.standard_normal((Bt, DI, ST),
                                             np.float32)).cuda()
    x = _randn(rng, (Bt, Q, DI), dtype)
    B = _randn(rng, (Bt, Q, ST), dtype)
    C = _randn(rng, (Bt, Q, ST), dtype)
    dt = torch.as_tensor(dt.astype(np.float32)).to(
        getattr(torch, dtype)).cuda()
    return h0, x, dt, torch.as_tensor(A.astype(np.float32)).cuda(), B, C


@pytest.mark.requires_cuda
def test_cuda_chunk_scan_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ssm_scan import kernel

    before = kernel.chunk_scan.launches
    for Bt, Q, DI, ST, dtype in CS_SHAPES:
        rng = np.random.default_rng(Q + DI + ST)
        args = _scan_inputs(rng, Bt, Q, DI, ST, dtype)
        got_y, got_h = kernel.chunk_scan(*args)
        want_y, want_h = ssm_ref.chunk_scan(*args)
        torch.cuda.synchronize()
        assert got_y.dtype == torch.float32 and got_y.shape == (Bt, Q, DI)
        assert got_h.dtype == torch.float32 and got_h.shape == (Bt, DI, ST)
        for got, want in ((got_y, want_y), (got_h, want_h)):
            np.testing.assert_allclose(
                got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                atol=1e-4, err_msg=str((Bt, Q, DI, ST, dtype)))
    assert kernel.chunk_scan.launches == before + len(CS_SHAPES)


@pytest.mark.requires_cuda
def test_cuda_chunk_scan_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ssm_scan import kernel

    rng = np.random.default_rng(0)
    h0, x, dt, A, B, C = _scan_inputs(rng, 1, 8, 16, 4, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.chunk_scan(h0.cpu(), x.cpu(), dt.cpu(), A.cpu(), B.cpu(),
                          C.cpu())
    with pytest.raises(ValueError, match="dtype"):
        kernel.chunk_scan(h0, x, dt.bfloat16(), A, B, C)
    with pytest.raises(ValueError, match="dtype"):
        kernel.chunk_scan(h0, x.double(), dt, A, B, C)
    with pytest.raises(ValueError, match="shape"):
        kernel.chunk_scan(h0, x, dt[:, :7], A, B, C)
    with pytest.raises(ValueError, match="shape"):
        kernel.chunk_scan(h0[:, :8], x, dt, A, B, C)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.chunk_scan(h0, x, dt, A, B.transpose(1, 2).contiguous()
                          .transpose(1, 2), C)
    _, x2, dt2, A2, B2, C2 = _scan_inputs(rng, 1, 8, 16, 65, "float32")
    with pytest.raises(ValueError, match="d_state"):
        kernel.chunk_scan(torch.zeros((1, 16, 65), device="cuda"), x2, dt2,
                          A2, B2, C2)


# (T, E, k, d, f_max): tests/test_kernels.py's MR_CASES and
# MR_FMAX_CASES, qwen3-moe's prefill and decode, dbrx's and jamba's
# E = 16, ragged T, E not a multiple of 32, E at the kernel's limit,
# and k + d = 16
MR_SHAPES = [
    (256, 8, 2, 2, 1.0), (256, 16, 4, 2, 1.0), (512, 128, 8, 4, 1.0),
    (256, 4, 2, 2, 1.0), (256, 16, 4, 2, 0.5), (250, 16, 4, 2, 0.25),
    (37, 8, 2, 2, 0.5), (512, 128, 8, 4, 0.25), (250, 16, 4, 2, 1.0),
    (512, 128, 8, 2, 0.25), (512, 128, 8, 2, 1.0), (1, 128, 8, 2, 0.25),
    (1, 128, 8, 2, 1.0), (333, 16, 2, 2, 0.25), (9, 100, 3, 5, 1.0),
    (65, 1024, 6, 10, 1.0), (40, 48, 12, 4, 0.5), (128, 4, 4, 2, 1.0),
]


def _dispatch_inputs(T, E, seed, variant):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E), np.float32) * 2.0
    load = np.abs(rng.standard_normal(E).astype(np.float32)) * 3.0
    if variant == "ties":  # a few values: many exactly equal logits
        logits = np.round(logits) / 2.0
        load = np.round(load)
    if variant == "balanced":  # what serving sees: nothing steers
        load = np.ones(E, np.float32)
    return (torch.as_tensor(logits.astype(np.float32)).cuda(),
            torch.as_tensor(load.astype(np.float32)).cuda())


@pytest.mark.requires_cuda
def test_cuda_dispatch_kernels_match_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.midas_route import kernel, ops

    fused0 = kernel.dispatch_fused.launches
    cand0 = kernel.dispatch_candidates.launches
    fused = cands = steered = 0
    for (T, E, k, d, f_max), variant in itertools.product(
            MR_SHAPES, ("random", "ties", "balanced")):
        logits, load = _dispatch_inputs(T, E, T + E + k, variant)
        what = str((T, E, k, d, f_max, variant))
        kd = k + min(d, E - k)
        ids, vals = kernel.dispatch_candidates(logits, kd)
        want_ids, want_vals = ref.top_candidates(logits, kd)
        torch.cuda.synchronize()
        cands += 1
        assert torch.equal(ids, want_ids), what
        assert torch.equal(vals, want_vals), what
        got = ops.midas_dispatch(logits, load, k, d, f_max=f_max,
                                 impl="cuda")
        want = ref.midas_dispatch(logits, load, k, d, f_max=f_max)
        torch.cuda.synchronize()
        if kd > k:
            fused += f_max >= 1.0
            cands += f_max < 1.0
        assert torch.equal(got[0], want[0]), what
        assert torch.equal(got[2], want[2]), what
        np.testing.assert_allclose(got[1].cpu().numpy(),
                                   want[1].cpu().numpy(), rtol=0,
                                   atol=1e-6, err_msg=what)
        steered += int(got[2].sum())
        if variant == "balanced":
            assert not got[2].any(), what
    assert steered > 0
    assert kernel.dispatch_fused.launches == fused0 + fused
    assert kernel.dispatch_candidates.launches == cand0 + cands


@pytest.mark.requires_cuda
def test_cuda_dispatch_kernels_reject_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.midas_route import kernel

    logits, load = _dispatch_inputs(8, 32, 0, "random")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.dispatch_candidates(logits.cpu(), 4)
    with pytest.raises(ValueError, match="dtype"):
        kernel.dispatch_candidates(logits.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.dispatch_candidates(logits.T.contiguous().T, 4)
    with pytest.raises(ValueError, match="k \\+ d"):
        kernel.dispatch_candidates(logits, 17)
    with pytest.raises(ValueError, match="E must be"):
        kernel.dispatch_candidates(torch.zeros((2, 1025), device="cuda"), 4)
    with pytest.raises(ValueError, match="shape"):
        kernel.dispatch_fused(logits, load[:31], 2, 2)
    with pytest.raises(ValueError, match="k and d"):
        kernel.dispatch_fused(logits, load, 2, 0)
