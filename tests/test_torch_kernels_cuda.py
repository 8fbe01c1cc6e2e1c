"""The port's CUDA kernels against their plain versions, on the card.

``route_select`` must equal its plain version bit for bit, and
``route_tick`` in each of its modes (midas, power_of_d, chbl) the
engine's waves one at a time through it (assignments, the view each
wave was routed on, arrivals, counts, the dV to the bit, also against
``steering_dv_waves`` on those views, and midas's pin tables, histories
and ``hist_idx``),
with repeated keys, live and expired pins, binding and free budgets, one
wave, every row masked or pinned, a budget of 0, 4096 rows a wave, the
dV's and chbl's cap's sum orders at 3-1100 rows a wave and m = 1-1100,
loads that sit on chbl's cap, on one view and on fleet routing's
per-wave views, and replayed from a CUDA graph; both also on the
member-aware feasible sets of a membership fault (m = 64 with server 0
dead; m = 4 with three dead, every row repeating its one live server),
and a faulted fleet run through each equals its plain run;
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
``flash_attention_backward`` must agree with the autograd gradient of
the plain attention (2e-2 in bfloat16, 1e-4 in float32, of the largest
gradient), causal and not, be bitwise equal on a repeated call and
replayed from a CUDA graph, and carry ``flash_attention``'s gradient
under autograd.
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
d 2, a 512-token prompt and one decode token), and under other
rows a block than the wrapper's plan; ``dispatch_steer`` the same on
``ref.steer_from_candidates`` over the same candidates, at every
f_max (0, below 1 and 1), one token (which never steers below f_max
1), infinite loads, loads under which most benefits clear the floor (so
its quantile selects, with and without equal benefits), the edges of its
register kernel (31, 32, 33, 512 and 513 tokens) and of its select's
crossover (319-321), k + d = 16 at E = 1024, 1024 and 4096 tokens (the
most whose state stays in shared memory) and 4097 and 5000 (state in a
scratch buffer), and under other select plans than the wrapper's.  At
f_max < 1 ``ops.midas_dispatch`` is one launch of each pass and no
other device kernel but allocator fills (torch.profiler).

Needs a CUDA device and nvcc; skips without them.  The file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m requires_cuda \\
        tests/test_torch_kernels_cuda.py
"""

import contextlib
import itertools
import re

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


# route_tick cases: (seed, G, Rg, f_max, key pool, variant) at m = 64,
# d_max = 4, N = 10**6 and a 5-wave history ring (so a tick wraps it):
# chip_smoke's phase-2 cases, then one wave, every row masked, every row
# pinned, a budget of 0 and 4096 rows a wave (16 chunks of the block);
# f_max, the pins and the ring are midas's alone
TICK_CASES = [
    (1, 8, 64, 0.3, 40, "plain"), (2, 8, 64, 0.3, 8, "plain"),
    (3, 8, 64, 1.0, 40, "plain"), (4, 8, 64, 1.0, 8, "plain"),
    (5, 1, 64, 0.3, 40, "plain"), (6, 8, 64, 0.3, 40, "masked"),
    (7, 8, 64, 0.3, 40, "pinned"), (8, 8, 64, 0.0, 40, "plain"),
    (9, 2, 4096, 1.0, 500, "plain"), (10, 3, 300, 0.3, 30, "plain"),
]
TICK_POLICIES = ("midas", "power_of_d", "chbl")
# (Rg, m): the dV's loop_sum below 16 rows, at 16, between 16 and 32
# (lanes and the rest), just above 32 (windows of 32 with pads), at 64
# and 66 and on two levels of windows (1100); chbl's cap at m = 1, 8,
# 33 (one pad), 64, 100, 259 and 1100 (two levels)
SUM_CASES = [(3, 1), (16, 8), (31, 33), (33, 64), (64, 100), (66, 259),
             (1100, 1100)]


def _on_the_cap(L, c_idx=(0, 3)):
    """``L`` with the servers ``c_idx`` moved onto chbl's cap: a fixed
    point of L[i] <- load_cap(L), found by iterating (float32 loads on
    the plain version's cap exactly)."""
    from repro_torch.core.policies.bounded_load import load_cap

    L = np.array(L, np.float32)
    idx = [i % L.size for i in c_idx]
    for _ in range(200):
        c = np.float32(load_cap(torch.as_tensor(L)).item())
        if (L[idx] == c).all():
            return L
        L[idx] = c
    raise AssertionError("no load vector on the cap found")


def _tick_case(seed, G, Rg, f_max, pool, variant, m=64, d_max=4,
               N=10**6, W=5, member=None, policy="midas"):
    """One tick's engine inputs on the card, made with numpy: keys from a
    small pool (repeated within and across waves), a ragged mask, live
    and expired pins on the pool, integer histories, hot servers.  With
    ``member`` ((m,) bool) the feasible sets are the member-aware ones
    the fault layer gathers, at its scan width.  ``policy`` is midas
    (with its state and knobs), power_of_d (fixed_d 2, 3 or 4 by the
    seed; no state) or chbl (no draws, no state); variant "on_cap" puts
    two servers' loads on chbl's cap."""
    from repro_torch.core import hashring, policies, prng
    from repro_torch.core import sim as tsim
    from repro_torch.core.controllers.base import Knobs
    from repro_torch.core.policies.midas import MidasState

    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x).cuda()  # noqa: E731
    keypool = rng.choice(N, pool, replace=False)
    keys = t(keypool[rng.integers(0, pool, (G, Rg))]).long()
    mask = t(rng.random((G, Rg)) < 0.85)
    if variant == "masked":
        mask[:] = False
    feas = _feasible(keys, m, d_max, member)
    name = policy
    policy = policies.get(name)
    draws = policy.draws(prng.fold_in(prng.PRNGKey(seed, "cuda")[None],
                                      torch.arange(G, device="cuda")),
                         (Rg, d_max))
    now = 1000.0
    pin_server = np.full(N, -1, np.int32)
    pin_expiry = np.zeros(N, np.float32)
    pin_server[keypool] = rng.integers(-1, m, pool)
    pin_expiry[keypool] = now + rng.integers(-2, 3, pool) * 100.0
    if variant == "pinned":
        pin_server[keypool] = rng.integers(0, m, pool)
        pin_expiry[keypool] = now + 500.0
    steer = rng.integers(0, 4, W).astype(np.float32)
    state = MidasState(
        pin_server=t(pin_server), pin_expiry=t(pin_expiry),
        steer_hist=t(steer),
        elig_hist=t(steer + rng.integers(0, 3, W).astype(np.float32)),
        hist_idx=t(np.int32(rng.integers(0, 3 * W))))
    L_hat = np.round(rng.random(m) * 6, 1).astype(np.float32)
    L_hat[rng.integers(0, m, 4)] += 30.0
    if variant == "on_cap":
        L_hat = _on_the_cap(L_hat)
    cfg = tsim.SimConfig(m=m, N=N, d_max=d_max, n_groups=G, policy=name,
                         fixed_d=2 + seed % 3)
    st = tsim.init_state(cfg, device="cuda")._replace(
        L_hat=t(L_hat), p50_hat=t((rng.random(m) * 300).astype(np.float32)),
        policy=state if name == "midas" else ())
    knobs = Knobs(d=t(np.int32(3)), delta_l=t(np.float32(1.0)),
                  delta_t=t(np.float32(-1e9)), f_max=t(np.float32(f_max)),
                  pin_ms=t(np.float32(300.0)), ttl_scale=t(np.float32(1.0)))
    consts = tsim._Consts(*(torch.ones((), device="cuda") * v
                            for v in (0.0, 1.0)), torch.ones(m,
                                                             device="cuda"),
                          fixed_d=t(np.int32(cfg.fixed_d)))
    return cfg, policy, st, knobs, t(np.float32(now)), keys, mask, feas, \
        draws, consts


def _feasible(keys, m, d_max, member=None):
    """Feasible sets of ``keys`` on the card: member-free, or restricted
    to the live servers of ``member`` at the fault layer's scan width
    (rows repeat their one live server when fewer than d_max live)."""
    from repro_torch.core import hashring
    from repro_torch.core.faults import base as faults_base

    ring = hashring.make_ring(m, 64, device="cuda")
    if member is None:
        return hashring.feasible_set(ring, keys, d_max)
    member = np.asarray(member, bool)
    return hashring.feasible_set(
        ring, keys, d_max,
        scan_width=faults_base._scan_width(m, 64, member[None]),
        member=torch.as_tensor(member).cuda())


def _clone(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    items = [_clone(x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


@contextlib.contextmanager
def _recording():
    """Record the outputs of each route_tick call (the policies call it
    through the ops module), the views included, which the engine's
    TickRoute leaves out."""
    from repro_torch.kernels.midas_route import ops

    real, calls = ops.route_tick, []

    def record(*args, **kw):
        calls.append(real(*args, **kw))
        return calls[-1]

    ops.route_tick = record
    try:
        yield calls
    finally:
        ops.route_tick = real


def _assert_views(case, want, out, views=None):
    """route_tick's views (``out[1]``) equal the views the plain loop
    routed each wave on (``views``, or the shared view plus the earlier
    waves' sends), and its dV (``out[5]``) equals ``steering_dv_waves``
    on them and the plain loop's assignments, bit for bit."""
    from repro_torch.core import sim as tsim
    from repro_torch.core.policies.base import (
        RouteContext,
        steering_dv_waves,
    )

    cfg, policy, st, knobs, now, keys, mask, feas, draws, consts = case
    if views is None:
        sent, rows = torch.zeros_like(st.L), []
        for g in range(keys.shape[0]):
            rows.append(st.L_hat + sent)
            sent = sent + tsim._wave_counts(cfg.m, mask[g], want.assign[g])
        views = torch.stack(rows)
    ctx = RouteContext(keys=keys, mask=mask, feas=feas, L_view=None,
                       p50_view=None, knobs=None, now_ms=None, draws=None,
                       m=cfg.m, fixed_d=None)
    dv = steering_dv_waves(ctx, views, want.assign)
    for name, w, g in (("views", views, out[1]), ("dV", dv, out[5])):
        assert w.dtype == g.dtype and torch.equal(_bits(w), _bits(g)), name


def _route_tick_both(case, views=None):
    """The tick through the plain wave loop and through the kernel, each
    from its own copy of the state, on the shared view or on per-wave
    ``views``; the kernel's views and dV held against the plain loop's
    (:func:`_assert_views`)."""
    from repro_torch.core import sim as tsim

    cfg, policy, st, knobs, now, keys, mask, feas, draws, consts = case
    out = {}
    for impl in ("ref", "cuda"):
        s = st._replace(policy=_clone(st.policy))
        with _recording() as calls:
            out[impl] = tsim._route_waves(cfg, policy, s, knobs, now, keys,
                                          mask, feas, draws, impl, consts,
                                          views)
        assert len(calls) == (impl == "cuda")
    torch.cuda.synchronize()
    _assert_views(case, out["ref"][1], calls[0], views)
    return out["ref"], out["cuda"]


def _bits(x):
    """A float32 tensor's bits (so +0.0 and -0.0 differ), else itself."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_ticks_equal(want, got, what):
    (wps, wt), (gps, gt) = want, got
    pairs = [("assign", wt.assign, gt.assign),
             ("arrivals", wt.arrivals, gt.arrivals)]
    pairs += [(f, getattr(wt.stats, f), getattr(gt.stats, f))
              for f in ("steered", "eligible", "dV")]
    pairs += [(f, getattr(wps, f), getattr(gps, f))
              for f in getattr(wps, "_fields", ())]
    assert type(wps) is type(gps), what
    for name, w, g in pairs:
        assert w.dtype == g.dtype and torch.equal(_bits(w), _bits(g)), (
            what, name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("policy", TICK_POLICIES)
def test_cuda_route_tick_matches_the_waves_one_at_a_time(policy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.midas_route import kernel

    steered = moved = 0
    for case in TICK_CASES:
        before = kernel.route_tick.launches
        want, got = _route_tick_both(_tick_case(*case, policy=policy))
        assert kernel.route_tick.launches == before + 1, case
        _assert_ticks_equal(want, got, case)
        steered += int(got[1].stats.steered)
        moved += float(got[1].stats.dV) != 0.0
        if case[-1] == "masked" or (policy == "midas" and (
                case[-1] == "pinned" or case[3] == 0.0)):
            assert int(got[1].stats.steered) == 0, case
    assert moved > 0
    assert (steered > 0) == (policy != "power_of_d")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("policy", TICK_POLICIES)
def test_cuda_route_tick_sum_orders_match_the_waves(policy):
    """The dV's loop_sum and chbl's reduce_sum of the view at every shape
    of their schedules (SUM_CASES), on one view and on per-wave views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    moved = 0
    for i, (Rg, m) in enumerate(SUM_CASES):
        case = _tick_case(20 + i, 3, Rg, 0.5, max(4, Rg // 2), "plain",
                          m=m, policy=policy)
        want, got = _route_tick_both(case)
        _assert_ticks_equal(want, got, (policy, Rg, m))
        moved += float(got[1].stats.dV) != 0.0
        views = torch.as_tensor(_views(20 + i, 3, m)).cuda()
        want, got = _route_tick_both(case, views)
        _assert_ticks_equal(want, got, (policy, Rg, m, "fleet"))
    assert moved >= len(SUM_CASES) - 1  # m = 1 moves nothing


@pytest.mark.requires_cuda
def test_cuda_route_tick_chbl_loads_on_the_cap():
    """chbl with two servers' loads exactly on the cap (load <= cap keeps
    the request): the first wave's view on one shared view, every wave's
    on per-wave views, at m = 8 and 64; the kernel's cap rounds as
    load_cap does, so it routes as the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for m in (8, 64):
        case = _tick_case(40 + m, 4, 64, 0.5, 30, "on_cap", m=m,
                          policy="chbl")
        cfg, pol, st, knobs, now, keys, mask, feas, draws, consts = case
        L = st.L_hat.cpu().numpy()
        # primaries on the cap, and a successor on it
        feas[0, ::2, 0] = 0
        feas[0, 1::4, 1] = 3
        want, got = _route_tick_both(case)
        _assert_ticks_equal(want, got, ("on cap", m))
        kept = got[1].assign[0, ::2][mask[0, ::2]]
        assert L[0] == L[3] and bool((kept == 0).all()), m
        views = np.stack([_on_the_cap(v, (g, g + 3)) for g, v in
                          enumerate(_views(40 + m, 4, m))])
        want, got = _route_tick_both(case, torch.as_tensor(views).cuda())
        _assert_ticks_equal(want, got, ("on cap fleet", m))


def _views(seed, G, m):
    """(G, m) per-wave views, each proxy's own: tenths with a few hot
    servers a wave."""
    rng = np.random.default_rng(seed + 100)
    views = np.round(rng.random((G, m)) * 6, 1).astype(np.float32)
    for g in range(G):  # each proxy sees its own hot servers
        views[g, rng.integers(0, m, 4)] += 30.0
    return views


@pytest.mark.requires_cuda
@pytest.mark.parametrize("policy", TICK_POLICIES)
def test_cuda_route_tick_fleet_views_match_the_waves_one_at_a_time(policy):
    """Fleet routing: wave g routes on the (G, m) base view's row g
    alone, with no sends shared within the tick; the kernel's base-view
    mode against the plain loop fed the same views, in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.midas_route import kernel

    steered = 0
    for case in TICK_CASES:
        tc = _tick_case(*case, policy=policy)
        G, m = tc[5].shape[0], tc[2].L_hat.shape[0]
        views = torch.as_tensor(_views(case[0], G, m)).cuda()
        before = kernel.route_tick.launches
        want, got = _route_tick_both(tc, views)
        assert kernel.route_tick.launches == before + 1
        _assert_ticks_equal(want, got, case)
        steered += int(got[1].stats.steered)
    assert (steered > 0) == (policy != "power_of_d")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("policy", TICK_POLICIES)
def test_cuda_route_tick_in_a_cuda_graph(policy):
    """Captured once, the tick replays the plain loop's result from the
    same state (restored before each replay: the midas kernel updates
    the pin tables and histories in place)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import sim as tsim
    from repro_torch.kernels.midas_route import kernel

    case = _tick_case(*TICK_CASES[1], policy=policy)
    want, _ = _route_tick_both(case)
    cfg, policy, st, knobs, now, keys, mask, feas, draws, consts = case
    saved = _clone(st.policy)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tsim._route_waves(cfg, policy, st, knobs, now, keys, mask, feas,
                          draws, "cuda", consts)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kernel.route_tick.launches
    with _recording() as calls, torch.cuda.graph(graph, stream=side):
        got = tsim._route_waves(cfg, policy, st, knobs, now, keys, mask,
                                feas, draws, "cuda", consts)
    assert kernel.route_tick.launches == before + 1 and len(calls) == 1
    for _ in range(3):
        for x, y in zip(st.policy, saved):
            x.copy_(y)
        got[1].assign.zero_()
        calls[0][1].zero_()
        graph.replay()
        torch.cuda.synchronize()
        _assert_ticks_equal(want, got, "graph replay")
        _assert_views(case, want[1], calls[0])


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


# (B, S, H, KV, D, window, softcap, dtype): SmolLM-360M's training shape
# in both dtypes, Qwen3-MoE's heads (64 over 4, D 128), MusicGen's G = 1,
# gemma2's window and softcap, a ragged S with a padded D, and a ragged S
# in bfloat16 at D 128 with one KV head
FA_BWD_SHAPES = [
    (8, 512, 15, 5, 64, 0, 0.0, "bfloat16"),
    (8, 512, 15, 5, 64, 0, 0.0, "float32"),
    (1, 512, 64, 4, 128, 0, 0.0, "float32"),
    (1, 512, 32, 32, 64, 0, 0.0, "bfloat16"),
    (2, 256, 8, 4, 256, 128, 50.0, "float32"),
    (2, 100, 6, 2, 20, 24, 20.0, "float32"),
    (1, 77, 4, 1, 128, 0, 0.0, "bfloat16"),
]


def bwd_tol(dtype):
    """The backward against ``ref.mha_backward``: |diff| <= tol (1 +
    |want|) scaled by the largest |want|.  float32: 1e-4 (the forward's
    3xTF32 output and its ex2.approx logsumexp enter D = dO . o and p);
    bfloat16: 2e-2, the forward's tolerance (the gradients are rounded
    to bfloat16, and D reads the bfloat16 output)."""
    return 2e-2 if dtype == "bfloat16" else 1e-4


def _assert_grads_close(got, want, dtype, what):
    tol = bwd_tol(dtype)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        g, w = g.float(), w.float()
        assert bool(torch.isfinite(g).all()), (what, name)
        scale = w.abs().max().item()
        err = (g - w).abs()
        bad = err > tol * (scale + w.abs())
        assert not bool(bad.any()), (
            f"{what} {name}: max |diff| {err.max().item():.3g} at scale "
            f"{scale:.3g}")


@pytest.mark.requires_cuda
def test_cuda_flash_attention_backward_matches_plain_version():
    """The backward kernels against the autograd gradient of ``ref.mha``
    at each case, causal and not, one launch a call, in q's dtype, and
    bitwise equal on a repeated call (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel

    before = kernel.flash_attention_backward.launches
    calls = 0
    for shape in FA_BWD_SHAPES:
        B, S, H, KV, D, window, cap, dtype = shape
        rng = np.random.default_rng(S + H + D)
        q, k, v = (_randn(rng, (B, S, n, D), dtype) for n in (H, KV, KV))
        dout = _randn(rng, (B, S, H, D), dtype)
        for causal in (True, False):
            kw = dict(causal=causal, window=window, softcap=cap)
            out, lse = kernel._forward(q, k, v, causal, window, cap, True)
            got = kernel.flash_attention_backward(q, k, v, out, dout, lse,
                                                  **kw)
            want = fa_ref.mha_backward(q, k, v, dout, **kw)
            torch.cuda.synchronize()
            _assert_grads_close(got, want, dtype, (shape, causal))
            again = kernel.flash_attention_backward(q, k, v, out, dout,
                                                    lse, **kw)
            calls += 2
            for a, b in zip(got, again):
                assert torch.equal(a, b), (shape, causal)
    assert kernel.flash_attention_backward.launches == before + calls


@pytest.mark.requires_cuda
def test_cuda_flash_attention_backward_in_a_cuda_graph():
    """A backward call captured in a warmed CUDA graph replays the eager
    call's gradients bit for bit: at the training shape in both dtypes
    and at the ragged, windowed, softcapped case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel

    for shape in (FA_BWD_SHAPES[0], FA_BWD_SHAPES[1], FA_BWD_SHAPES[5]):
        B, S, H, KV, D, window, cap, dtype = shape
        rng = np.random.default_rng(S + H + D)
        q, k, v = (_randn(rng, (B, S, n, D), dtype) for n in (H, KV, KV))
        dout = _randn(rng, (B, S, H, D), dtype)
        kw = dict(causal=True, window=window, softcap=cap)
        out, lse = kernel._forward(q, k, v, True, window, cap, True)
        eager = kernel.flash_attention_backward(q, k, v, out, dout, lse,
                                                **kw)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel.flash_attention_backward(q, k, v, out, dout, lse, **kw)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kernel.flash_attention_backward.launches
        with torch.cuda.graph(graph, stream=side):
            got = kernel.flash_attention_backward(q, k, v, out, dout, lse,
                                                  **kw)
        assert kernel.flash_attention_backward.launches == before + 1
        for _ in range(3):
            for g in got:
                g.zero_()
            graph.replay()
            torch.cuda.synchronize()
            for a, b in zip(got, eager):
                assert torch.equal(a, b), shape


@pytest.mark.requires_cuda
def test_cuda_flash_attention_under_autograd():
    """With inputs that require a gradient the kernel's result carries
    the backward kernels: the forward's output is the no-grad call's bit
    for bit, and ``backward`` gives ``flash_attention_backward``'s
    gradients, one forward and one backward launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel, ops

    shape = (2, 200, 15, 5, 64, 0, 0.0, "bfloat16")
    q, k, v = _fa_inputs(shape, 3)
    dout = _fa_inputs(shape, 4)[0]
    plain = kernel.flash_attention(q, k, v)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    f0 = kernel.flash_attention.launches
    b0 = kernel.flash_attention_backward.launches
    out = ops.flash_attention(qq, kk, vv)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), plain)
    out.backward(dout)
    assert kernel.flash_attention.launches == f0 + 1
    assert kernel.flash_attention_backward.launches == b0 + 1
    _, lse = kernel._forward(q, k, v, True, 0, 0.0, True)
    want = kernel.flash_attention_backward(q, k, v, plain, dout, lse)
    for g, w in zip((qq.grad, kk.grad, vv.grad), want):
        assert torch.equal(g, w)


@pytest.mark.requires_cuda
def test_cuda_flash_attention_backward_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel

    q, k, v = _fa_inputs((1, 16, 4, 2, 64, 0, 0.0, "float32"), 0)
    out, lse = kernel._forward(q, k, v, True, 0, 0.0, True)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_backward(q.cpu(), k.cpu(), v.cpu(),
                                        out.cpu(), out.cpu(), lse.cpu())
    with pytest.raises(ValueError, match="lse"):
        kernel.flash_attention_backward(q, k, v, out, out, lse.double())
    with pytest.raises(ValueError, match="dout"):
        kernel.flash_attention_backward(q, k, v, out, out.bfloat16(), lse)


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


def _dispatch_inputs(T, E, seed, variant, k=8):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E), np.float32) * 2.0
    load = np.abs(rng.standard_normal(E).astype(np.float32)) * 3.0
    if variant == "ties":  # a few values: many exactly equal logits
        logits = np.round(logits) / 2.0
        load = np.round(load)
    if variant == "balanced":  # what serving sees: nothing steers
        load = np.ones(E, np.float32)
    if variant.startswith("hot"):
        # every token ranks experts 0, 1, ... about alike, within the
        # gate slack, and the load is hot on the first k: most benefits
        # clear the floor, so dispatch_steer's quantile selects; "hot
        # ties" rounds the load (equal benefits, some on the floor)
        logits = (-0.05 * np.arange(E)[None, :]
                  + 0.02 * rng.standard_normal((T, E)))
        load = np.where(np.arange(E) < k, 6.0 + np.abs(
            rng.standard_normal(E)), np.abs(rng.standard_normal(E)) * 3.0)
        if variant == "hot ties":
            load = np.round(load)
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


# (T, E, k, d, f_max) for dispatch_steer beyond MR_SHAPES' f_max < 1
# cases: one decode token, f_max 0 and 1, and state beyond shared memory;
# the register kernel's edges: one warp (31, 32) and a block (33), its
# select's crossover (kernel.STEER_COUNT_MAX = 320 tokens) +- 1, its last
# token (512) and the shared-memory kernel's first (513, and 1025), k + d
# = 16 at E = 1024 and at E = 16
STEER_SHAPES = [shape for shape in MR_SHAPES if shape[4] < 1.0] + [
    (1, 16, 4, 2, 0.25), (2, 16, 4, 2, 0.5), (300, 16, 4, 2, 0.0),
    (300, 16, 4, 2, 1.0), (1, 128, 8, 2, 0.5), (1024, 128, 8, 2, 0.25),
    (4096, 128, 8, 2, 0.25), (4097, 16, 4, 2, 0.75),
    (5000, 128, 8, 2, 0.25),
    (31, 128, 8, 2, 0.25), (32, 128, 8, 2, 0.25), (33, 128, 8, 2, 0.5),
    (319, 128, 8, 2, 0.25), (320, 128, 8, 2, 0.25), (321, 128, 8, 2, 0.25),
    (1025, 128, 8, 2, 0.25), (513, 128, 8, 2, 0.25), (512, 1024, 12, 4, 0.25),
    (513, 1024, 12, 4, 0.25), (300, 16, 8, 8, 0.5), (64, 1024, 15, 1, 0.9),
]
STEER_VARIANTS = ("random", "ties", "balanced", "infs", "hot", "hot ties")


@pytest.mark.requires_cuda
def test_cuda_dispatch_steer_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.midas_route import kernel

    before = kernel.dispatch_steer.launches
    calls = steered = 0
    for (T, E, k, d, f_max), variant in itertools.product(
            STEER_SHAPES, STEER_VARIANTS):
        logits, load = _dispatch_inputs(T, E, T + E + k + d, variant
                                        if variant != "infs" else "random",
                                        k)
        if variant == "infs":
            load[::5] = float("inf")
        what = str((T, E, k, d, f_max, variant))
        cand, vals = kernel.dispatch_candidates(logits, k + d)
        got = kernel.dispatch_steer(cand, vals, load, k, f_max=f_max)
        want = ref.steer_from_candidates(cand, vals, load, k, f_max=f_max)
        torch.cuda.synchronize()
        calls += 1
        assert torch.equal(got[0], want[0]), what
        assert torch.equal(got[2], want[2]), what
        np.testing.assert_allclose(got[1].cpu().numpy(),
                                   want[1].cpu().numpy(), rtol=0,
                                   atol=1e-6, err_msg=what)
        assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
        if variant == "balanced" or f_max <= 0.0 or (T == 1
                                                     and variant != "infs"):
            assert not got[2].any(), what
        steered += int(got[2].sum())
    assert steered > 0
    assert kernel.dispatch_steer.launches == before + calls


@pytest.mark.requires_cuda
@pytest.mark.parametrize("plan", [(False, 1 << 30), (True, 0), (False, 0),
                                  (True, 40)])
def test_cuda_dispatch_steer_select_plans(plan, monkeypatch):
    """Other select plans than the wrapper's (no warp path at T <= 32;
    the radix select whatever the count; a crossover at 40 ranked
    values) steer the same, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.midas_route import kernel

    monkeypatch.setattr(kernel, "steer_plan", lambda T: plan)
    before = kernel.dispatch_steer.launches
    calls = steered = 0
    for T, variant in itertools.product(
            (1, 2, 31, 32, 33, 100, 512, 1024), ("hot", "hot ties")):
        logits, load = _dispatch_inputs(T, 128, T, variant)
        cand, vals = kernel.dispatch_candidates(logits, 10)
        for f_max in (0.25, 0.6):
            got = kernel.dispatch_steer(cand, vals, load, 8, f_max=f_max)
            want = ref.steer_from_candidates(cand, vals, load, 8,
                                             f_max=f_max)
            torch.cuda.synchronize()
            calls += 1
            what = str((T, variant, f_max, plan))
            assert torch.equal(got[0], want[0]), what
            assert torch.equal(got[2], want[2]), what
            np.testing.assert_allclose(got[1].cpu().numpy(),
                                       want[1].cpu().numpy(), rtol=0,
                                       atol=1e-6, err_msg=what)
            steered += int(got[2].sum())
    assert steered > 0
    assert kernel.dispatch_steer.launches == before + calls


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows", [1, 3, 4, 8, 32])
def test_cuda_dispatch_selection_plan_overrides(rows, monkeypatch):
    """Other rows a block than the wrapper's plan give the same
    candidates and the same fused dispatch, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.midas_route import kernel

    monkeypatch.setattr(kernel, "select_plan", lambda T, E: rows)
    kernel._plan.cache_clear()
    before = (kernel.dispatch_candidates.launches,
              kernel.dispatch_fused.launches)
    calls = 0
    for T, E, k, d, _ in MR_SHAPES:
        if min(-(-E // 32) * 32, 256) * rows > 1024 or rows > T:
            continue
        kd = k + min(d, E - k)
        if kd == k:  # no alternate: plain top-k, no dispatch kernel
            continue
        logits, load = _dispatch_inputs(T, E, T + E + k, "ties")
        ids, vals = kernel.dispatch_candidates(logits, kd)
        want_ids, want_vals = ref.top_candidates(logits, kd)
        got = kernel.dispatch_fused(logits, load, k, kd - k)
        want = ref.midas_dispatch(logits, load, k, kd - k, f_max=1.0)
        torch.cuda.synchronize()
        calls += 1
        what = str((T, E, k, d, rows))
        assert torch.equal(ids, want_ids) and torch.equal(vals, want_vals), \
            what
        assert torch.equal(got[0], want[0]), what
        assert torch.equal(got[2], want[2]), what
    kernel._plan.cache_clear()  # the plan is restored after the test
    assert calls >= 5
    assert (kernel.dispatch_candidates.launches,
            kernel.dispatch_fused.launches) == (before[0] + calls,
                                                before[1] + calls)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("T", [1, 512])
def test_cuda_fmax_below_one_is_two_launches(T):
    """ops.midas_dispatch at f_max < 1 on the card: one launch of
    dispatch_candidates and one of dispatch_steer a call, no
    dispatch_fused, and on the device no other kernel than at most two
    allocator fills (no sort, no per-slot op)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.midas_route import kernel, ops

    logits, load = _dispatch_inputs(T, 128, T, "random")
    ops.midas_dispatch(logits, load, 8, 2, f_max=0.25)  # built, planned
    torch.cuda.synchronize()
    counts = (kernel.dispatch_candidates.launches,
              kernel.dispatch_steer.launches, kernel.dispatch_fused.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        got = ops.midas_dispatch(logits, load, 8, 2, f_max=0.25)
        torch.cuda.synchronize()
    assert (kernel.dispatch_candidates.launches,
            kernel.dispatch_steer.launches,
            kernel.dispatch_fused.launches) == (counts[0] + 1, counts[1] + 1,
                                                counts[2])
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [re.search(r"dispatch_[a-z]+_kernel", n) for n in names]
    assert sorted(m.group(0) for m in ours if m) == [
        "dispatch_candidates_kernel", "dispatch_steer_kernel"], names
    others = [n for n in names if "dispatch_" not in n]
    assert len(others) <= 2, names
    assert not any("sort" in n.lower() or "Sort" in n for n in others), names
    want = ref.midas_dispatch(logits, load, 8, 2, f_max=0.25)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])


@pytest.mark.requires_cuda
def test_cuda_dispatch_steer_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.midas_route import kernel

    logits, load = _dispatch_inputs(8, 32, 0, "random")
    cand, vals = kernel.dispatch_candidates(logits, 6)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.dispatch_steer(cand.cpu(), vals.cpu(), load.cpu(), 4)
    with pytest.raises(ValueError, match="dtype"):
        kernel.dispatch_steer(cand.long(), vals, load, 4)
    with pytest.raises(ValueError, match="dtype"):
        kernel.dispatch_steer(cand, vals.double(), load, 4)
    with pytest.raises(ValueError, match="dtype"):
        kernel.dispatch_steer(cand, vals, load.half(), 4)
    with pytest.raises(ValueError, match="shape"):
        kernel.dispatch_steer(cand, vals[:, :5], load, 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.dispatch_steer(cand, vals.T.contiguous().T, load, 4)
    with pytest.raises(ValueError, match="k and d"):
        kernel.dispatch_steer(cand, vals, load, 6)
    with pytest.raises(ValueError, match="k and d"):
        kernel.dispatch_steer(cand, vals, load, 0)
    with pytest.raises(ValueError, match="k \\+ d"):
        big = torch.zeros((8, 17), dtype=torch.int32, device="cuda")
        kernel.dispatch_steer(big, big.float(), load, 4)
    with pytest.raises(ValueError, match="E must be"):
        kernel.dispatch_steer(cand, vals, torch.zeros(1025, device="cuda"),
                              4)
    with pytest.raises(ValueError, match="cand must be"):
        kernel.dispatch_steer(cand[0], vals, load, 4)


PLANE_CONFIGS = [
    dict(policy="chbl"),
    dict(policy="midas", middleware=("cache",),
         ablate="no_margin,no_pin,no_bucket"),
    dict(policy="midas", middleware=("cache",), controller="aimd"),
    dict(policy="midas", middleware=("cache",), controller="deadband_pid",
         cache_mode="ttl_per_key"),
    dict(policy="midas", middleware=("cache",), guard=True),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kw", PLANE_CONFIGS,
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in
                                                 kw.items()))
def test_cuda_evaluation_plane_matches_its_plain_run(kw):
    """chbl, and midas under the ablations and the other control laws,
    through route_tick once a tick, bit for bit the plain run on the
    card (700 ticks: the slow loop runs once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import make_workload
    from repro_torch.core import sim as tsim
    from repro_torch.kernels.midas_route import kernel

    T = 700
    wl = make_workload("bursty", T=T, m=8, seed=3, N=512, write_frac=0.5,
                       device="cuda")
    runs = {}
    for impl in ("cuda", "ref"):
        cfg = tsim.SimConfig(m=8, N=512, route_impl=impl, **kw)
        before = (kernel.route_select.launches, kernel.route_tick.launches)
        st = tsim.init_state(cfg, 0.15, 500.0, device="cuda")
        runs[impl] = tsim.run_ticks(cfg, st, wl.keys, wl.mask, wl.is_write)
        n = (kernel.route_select.launches - before[0],
             kernel.route_tick.launches - before[1])
        assert n == ((0, 0) if impl == "ref" else (0, T))
    (fa, oa), (fb, ob) = runs["cuda"], runs["ref"]
    for f in oa._fields:
        assert torch.equal(getattr(oa, f), getattr(ob, f)), f
    la, lb = _leaves(fa), _leaves(fb)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return []


# (m, dead servers): phase 3's shape with server 0 dead, and m = 4 with
# three dead, where every row repeats its one live server
MEMBER_CASES = [(64, (0,)), (4, (0, 1, 3))]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,dead", MEMBER_CASES)
def test_cuda_route_kernels_on_member_aware_feasible_sets(m, dead):
    """route_tick (midas, power_of_d, chbl) and route_select fed the
    feasible sets of a membership fault, repeated entries included,
    equal their plain versions bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.midas_route import kernel

    member = np.ones(m, bool)
    member[list(dead)] = False
    steered = 0
    for case, policy in itertools.product(TICK_CASES[:4], TICK_POLICIES):
        seed, G, Rg, f_max, pool, variant = case[:6]
        tc = _tick_case(seed, G, Rg, f_max, pool, variant, m=m,
                        member=member, policy=policy)
        feas = tc[7]
        assert bool(torch.as_tensor(member).cuda()[feas.long()].all())
        if m - len(dead) < feas.shape[-1]:
            assert bool((feas == feas[..., :1]).all())
        before = kernel.route_tick.launches
        want, got = _route_tick_both(tc)
        assert kernel.route_tick.launches == before + 1
        _assert_ticks_equal(want, got, (m, dead, case, policy))
        steered += int(got[1].stats.steered)
    for variant in ("plain", "ties", "infs"):
        feas, load, p50, sampled, tie, scal = _inputs(512, m, 4, m,
                                                       variant)
        keys = torch.randint(0, 10**6, (512,), device="cuda")
        feas = _feasible(keys, m, 4, member)
        for mode in ("power_of_d", "chbl", "midas"):
            args = (feas, load, p50, sampled, tie, scal)
            want = ref.route_select(*args, mode=mode)
            got = kernel.route_select(*args, mode=mode)
            torch.cuda.synchronize()
            for w, g in zip(want, got):
                assert w.dtype == g.dtype and torch.equal(w, g), (
                    m, dead, variant, mode)
            assert bool(torch.as_tensor(member).cuda()[got[0].long()]
                        .all())
    if m == 64:
        assert steered > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("policy", ["midas", "power_of_d"])
def test_cuda_faulted_engine_matches_its_plain_run(policy):
    """A crash, a storm and a partition under the fleet with fleet
    routing: the kernel run equals the plain run bit for bit on every
    output and the final state; both launch route_tick once a tick
    (each proxy's wave on its own view) and never route_select."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import make_workload
    from repro_torch.core import sim as tsim
    from repro_torch.core.faults import FaultEvent
    from repro_torch.kernels.midas_route import kernel

    T, P = 300, 4
    events = (FaultEvent("ckpt_storm_fleet", t0=100, duration=150,
                         magnitude=0.6),
              FaultEvent("proxy_crash", t0=120, duration=120, target=0),
              FaultEvent("gossip_partition", t0=150, duration=60,
                         target=-1))
    wl = make_workload("bursty", T=T, m=8, seed=3, N=512, device="cuda")
    runs = {}
    for impl in ("cuda", "ref"):
        cfg = tsim.SimConfig(m=8, N=512, P=P, policy=policy,
                             middleware=("fleet_cache",), gossip_ms=100.0,
                             fleet_routing=True, faults=events,
                             route_impl=impl)
        before = (kernel.route_select.launches, kernel.route_tick.launches)
        st = tsim.init_state(cfg, 0.15, 500.0, device="cuda")
        runs[impl] = tsim.run_ticks(cfg, st, wl.keys, wl.mask, wl.is_write)
        n = (kernel.route_select.launches - before[0],
             kernel.route_tick.launches - before[1])
        want = (0, 0) if impl == "ref" else (0, T)
        assert n == want, (impl, n)
    (fa, oa), (fb, ob) = runs["cuda"], runs["ref"]
    for f in oa._fields:
        assert torch.equal(getattr(oa, f), getattr(ob, f)), f
    la, lb = _leaves(fa), _leaves(fb)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i
    assert (oa.arrivals[135:240, 0] == 0).all()
