"""The algorithms of the CUDA dispatch kernels, on the CPU.

``csrc/midas_dispatch.cu`` selects a row's top-(k+d) by rank counting
and finds the f_max quantile of ``dispatch_steer`` by a radix select.
Neither can run here, so this file emulates both on the same layout
(rows padded to float4s, a thread's elements e + m·cover; the select's
8-bit digits, histograms, one-warp scan and early stop) and holds them
against the plain functions they replace:

- rank by counting against ``ref.top_candidates`` (ids and values bit
  for bit), with ties, E = 4, 16, 128 and 1024 and ragged T;
- the radix select of ``s[low]`` and ``s[high]`` against ``torch.sort``
  (bit for bit up to the sign of a zero), with -1e9 pads for
  non-finite benefits, repeated values, +-0, T = 1 (no pass) and T = 2;
- ``ref.quantile_plan`` with the double-rounded interpolation against
  ``ref.quantile``, bit for bit, and against ``jnp.quantile``;
- the whole of ``dispatch_steer``'s slot loop against
  ``ref.steer_from_candidates``: experts and steered bit for bit,
  weights within 1e-6;
- and the property that f_max < 1 at T = 1 never steers, against the
  live JAX reference under skewed loads.

The emulation lives here; the port's main path does not use it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.midas_route import ref as jref  # noqa: E402
from repro_torch.kernels.midas_route import kernel, ref  # noqa: E402

W_TOL = dict(rtol=0.0, atol=1e-6)
SIGN = np.uint32(0x80000000)


# ---------------------------------------------------------------------------
# rank by counting (dispatch_candidates, dispatch_fused)
# ---------------------------------------------------------------------------


def rank_select(logits, kd):
    """The kernels' selection of (T, E) float32 ``logits``: the rows
    padded with -inf to a multiple of 4, each element counting over the
    whole padded row, the element of rank r < kd written to candidate
    r."""
    T, E = logits.shape
    cover = min(-(-E // 32) * 32, 256)
    Ep = -(-E // 4) * 4
    row = np.full((T, Ep), -np.inf, np.float32)
    row[:, :E] = logits
    # thread i of a row takes the elements i, i + cover, ...: all of them
    owned = sorted(e for i in range(cover) for e in range(i, E, cover))
    assert owned == list(range(E))
    j = np.arange(Ep)
    e = np.arange(E)
    ve = row[:, :E, None]
    vj = row[:, None, :]
    above = (vj > ve) | ((vj == ve) & (j[None, None, :] < e[None, :, None]))
    rank = above.sum(-1)
    assert (np.sort(rank, 1) == e).all()  # a permutation: a total order
    ids = np.zeros((T, kd), np.int32)
    vals = np.zeros((T, kd), np.float32)
    t, el = np.nonzero(rank < kd)
    ids[t, rank[t, el]] = el
    vals[t, rank[t, el]] = row[t, el]
    return ids, vals


@pytest.mark.parametrize("variant", ["random", "ties", "constant"])
@pytest.mark.parametrize("T,E,kd", [(1, 4, 4), (37, 4, 3), (5, 16, 6),
                                    (250, 16, 16), (1, 128, 10),
                                    (33, 128, 10), (3, 1024, 16),
                                    (2, 100, 8)])
def test_rank_by_counting_matches_top_candidates(T, E, kd, variant):
    rng = np.random.default_rng(T * 1000 + E)
    logits = rng.standard_normal((T, E), np.float32) * 2.0
    if variant == "ties":  # a few values: many exactly equal logits
        logits = np.round(logits) / 2.0 + 0.0
    if variant == "constant":  # every logit equal: ranks by id alone
        logits = np.full((T, E), 0.5, np.float32)
    logits = logits.astype(np.float32)
    want_ids, want_vals = ref.top_candidates(torch.as_tensor(logits), kd)
    ids, vals = rank_select(logits, kd)
    np.testing.assert_array_equal(ids, want_ids.numpy())
    np.testing.assert_array_equal(vals.view(np.uint32),
                                  want_vals.numpy().view(np.uint32))


def test_select_plan_fits_a_block():
    for T in (1, 2, 37, 250, 512, 4096, 100_000):
        for E in (1, 4, 16, 100, 128, 1024):
            rows = kernel.select_plan(T, E)
            assert 1 <= rows <= T
            assert min(-(-E // 32) * 32, 256) * rows <= 1024
    # one thread an element: a decode token's row over 128 threads, a
    # prompt's in blocks of two rows
    assert kernel.select_plan(1, 128) == 1
    assert kernel.select_plan(512, 128) == 2


# ---------------------------------------------------------------------------
# radix select (dispatch_steer's quantile)
# ---------------------------------------------------------------------------


def order_key(b):
    """The kernel's order-preserving 32-bit key of a benefit, non-finite
    values as -1e9."""
    f = np.where(np.isfinite(b), b, np.float32(-1e9)).astype(np.float32)
    u = f.view(np.uint32)
    return np.where(u & SIGN, ~u, u | SIGN).astype(np.uint32)


def key_value(key):
    key = np.uint32(key)
    u = np.uint32(key & np.uint32(0x7FFFFFFF)) if key & SIGN else ~key
    return np.array([u], np.uint32).view(np.float32)[0]


def warp_scan_bin(hist, r):
    """Warp 0's scan: lane l holds bins 8l..8l+7; the lane whose
    inclusive range holds rank r finds its bin.  Returns (digit, count
    of the bins below it)."""
    c = hist.reshape(32, 8)
    incl = np.cumsum(c.sum(1))
    found = []
    for lane in range(32):
        acc = incl[lane] - c[lane].sum()
        if acc <= r < incl[lane]:
            for b in range(8):
                if r < acc + c[lane, b]:
                    found.append((8 * lane + b, acc))
                    break
                acc += c[lane, b]
    assert len(found) == 1
    return found[0]


def radix_select(benefit, low, high):
    """s[low] and s[high] of where(isfinite(b), b, -1e9), sorted, as
    select_digits finds them: up to four passes of 8-bit digits, one
    histogram while the two prefixes agree, stopping once one key is
    left for each rank, which its holder then reports.  Returns the two
    values and the number of passes taken."""
    keys = order_key(benefit)
    pre, rem, m = [0, 0], [low, high], [keys.size, keys.size]
    p = 0
    while p < 4 and (m[0] > 1 or m[1] > 1):
        shift = 24 - 8 * p
        ranks = 1 if pre[0] == pre[1] else 2
        hists = []
        for g in range(ranks):
            match = (np.ones(keys.shape, bool) if p == 0
                     else (keys >> np.uint32(shift + 8)) == pre[g])
            hists.append(np.bincount((keys[match] >> np.uint32(shift))
                                     & np.uint32(0xFF), minlength=256))
        for g in range(2):
            hist = hists[0 if ranks == 1 else g]
            dig, below = warp_scan_bin(hist, rem[g])
            pre[g] = (pre[g] << 8) | dig
            rem[g] -= below
            m[g] = int(hist[dig])
        p += 1
    out = []
    for g in range(2):
        left = keys if p == 0 else keys[(keys >> np.uint32(32 - 8 * p))
                                        == pre[g]]
        assert left.size >= 1 and (left == left[0]).all()
        out.append(key_value(left[0]))
    return out[0], out[1], p


def benefit_vectors():
    rng = np.random.default_rng(5)
    yield "T=1", np.array([3.5], np.float32)
    yield "T=1 -inf", np.array([-np.inf], np.float32)
    yield "T=2", np.array([4.0, -1.25], np.float32)
    yield "T=2 equal", np.array([2.0, 2.0], np.float32)
    yield "+-0", np.array([0.0, -0.0, 0.0, -0.0, 1.0, -1.0], np.float32)
    yield "pads", np.array([-np.inf, np.nan, np.inf, 2.5, -1e9, 3.0,
                            -np.inf, 7.0], np.float32)
    yield "repeats", rng.integers(-3, 4, 300).astype(np.float32)
    yield "all pads", np.full(512, -np.inf, np.float32)
    mixed = (rng.standard_normal(512) * 4).astype(np.float32)
    mixed[rng.random(512) < 0.7] = -np.inf
    yield "mostly pads", mixed
    yield "wide", (rng.standard_normal(4097) * 1e30).astype(np.float32)
    yield "tiny", (rng.standard_normal(1000) * 1e-40).astype(np.float32)


@pytest.mark.parametrize("q", [0.0, 0.5, 0.75, 0.9, 1.0])
@pytest.mark.parametrize("name,b", list(benefit_vectors()),
                         ids=[n for n, _ in benefit_vectors()])
def test_radix_select_matches_sort(name, b, q):
    n = b.shape[0]
    low, high, _, _ = ref.quantile_plan(n, q)
    finite = torch.where(torch.isfinite(torch.as_tensor(b)),
                         torch.as_tensor(b), -1e9)
    s = torch.sort(finite).values.numpy()
    lo, hi, passes = radix_select(b, low, high)
    assert passes <= 4 and (n > 1 or passes == 0)
    for got, want in ((lo, s[low]), (hi, s[high])):
        assert got == want  # float equality: +-0 alike
        if want != 0:
            assert got.view(np.uint32) == want.view(np.uint32)


# ---------------------------------------------------------------------------
# the quantile's plan and rounding
# ---------------------------------------------------------------------------


def interpolate(lo, hi, w_high, w_low):
    """dispatch_steer's interpolation: lo * w_low in float32, then the
    product and the sum in double, rounded to float32."""
    lw = np.float32(lo * np.float32(w_low))
    return np.float32(np.float64(hi) * np.float64(w_high) + np.float64(lw))


def kernel_quantile(b, q):
    """dispatch_steer's threshold before the clamp, from the radix
    select's order statistics."""
    low, high, w_high, w_low = ref.quantile_plan(b.shape[0], q)
    lo, hi, _ = radix_select(b, low, high)
    return interpolate(lo, hi, w_high, w_low)


@pytest.mark.parametrize("seed", range(12))
def test_quantile_plan_and_double_rounding_match_ref_quantile(seed):
    """Bit for bit on the sort's order statistics; from the radix
    select's, equal up to the sign of a zero (rounded data holds -0.0)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 700))
    b = np.round(rng.standard_normal(n) * 5, int(rng.integers(0, 3)))
    b = b.astype(np.float32)
    b[rng.random(n) < 0.3] = -np.inf
    finite = np.where(np.isfinite(b), b, np.float32(-1e9))
    s = torch.sort(torch.as_tensor(finite)).values.numpy()
    for q in (0.75, 1.0 - 0.3, 0.5, 0.6, 0.1):
        want = ref.quantile(torch.as_tensor(finite), q).numpy()
        low, high, w_high, w_low = ref.quantile_plan(n, q)
        got = interpolate(s[low], s[high], w_high, w_low)
        assert got.view(np.uint32) == want.view(np.uint32)
        assert got == np.float32(jnp.quantile(jnp.asarray(finite), q))
        radix = kernel_quantile(b, q)
        assert radix == want
        if want != 0:
            assert radix.view(np.uint32) == want.view(np.uint32)


@pytest.mark.parametrize("seed", [200, 2257])
def test_double_rounding_is_the_fused_quantile(seed):
    """tests/test_torch_moe.py's batches whose threshold the single
    rounding of the reference's fused multiply-add decides: the
    kernel's double-rounded interpolation lands on the same float."""
    rng = np.random.default_rng(seed)
    T = int(rng.integers(5, 60))
    f_max = float(rng.choice([0.25, 0.3, 0.4, 0.6, 0.7]))
    load = (rng.random(8) * 10).astype(np.float32)
    pairs = [(int(a), int(b)) for a, b in rng.integers(0, 8, (3, 2))
             if a != b]
    cand = np.array([pairs[i] for i in rng.integers(0, len(pairs), T)],
                    np.int32)
    benefit = load[cand[:, 0]] - load[cand[:, 1]]
    has = load[cand[:, 1]] <= load[cand[:, 0]] - np.float32(2.0)
    b = np.where(has, benefit, np.float32(-np.inf)).astype(np.float32)
    finite = np.where(has, benefit, np.float32(-1e9)).astype(np.float32)
    want = ref.quantile(torch.as_tensor(finite), 1.0 - f_max).numpy()
    got = kernel_quantile(b, 1.0 - f_max)
    assert got.view(np.uint32) == want.view(np.uint32)
    vals = np.zeros((T, 2), np.float32)
    emu = emulate_steer(cand, vals, load, 1, f_max=f_max)
    plain = ref.steer_from_candidates(torch.as_tensor(cand),
                                      torch.as_tensor(vals),
                                      torch.as_tensor(load), 1, f_max=f_max)
    np.testing.assert_array_equal(emu[2], plain[2].numpy())


def test_quantile_plan_is_what_ref_quantile_interpolates():
    for n in (1, 2, 3, 37, 512, 4097):
        for q in (0.0, 0.25, 0.75, 0.999, 1.0):
            low, high, w_high, w_low = ref.quantile_plan(n, q)
            assert 0 <= low <= high <= n - 1 and high - low <= 1
            assert np.float32(w_high) == w_high
            assert np.float32(w_low) == w_low
            assert np.float32(w_high) + np.float32(w_low) == np.float32(1)
    # one value: its quantile is the value, with all the weight on it
    assert ref.quantile_plan(1, 0.75) == (0, 0, 0.0, 1.0)


# ---------------------------------------------------------------------------
# dispatch_steer's slot loop, whole
# ---------------------------------------------------------------------------


def emulate_steer(cand, vals, load, k, *, delta_l=2.0, gate_slack=1.0,
                  f_max=1.0):
    """dispatch_steer on numpy float32: each slot's benefit and best
    alternate per token, the radix-selected quantile threshold, the
    steer, and the softmax of the chosen logits."""
    T, kd = cand.shape
    d = kd - k
    dl, slack = np.float32(delta_l), np.float32(gate_slack)
    floor = np.float32(delta_l - 1e-9)
    rows = np.arange(T)
    used = np.zeros((T, d), bool)
    experts = np.zeros((T, k), np.int32)
    chosen = np.zeros((T, k), np.float32)
    steered = np.zeros((T, k), bool)
    alt_load = load[cand[:, k:]]
    for i in range(k):
        lp = load[cand[:, i]]
        ok = (~used & (alt_load <= (lp - dl)[:, None])
              & (vals[:, k:] >= (vals[:, i] - slack)[:, None]))
        masked = np.where(ok, alt_load, np.float32(np.inf))
        best = np.argmin(masked, 1)
        has = ok.any(1)
        with np.errstate(invalid="ignore"):
            benefit = np.where(has, lp - masked[rows, best],
                               np.float32(-np.inf)).astype(np.float32)
            if f_max >= 1.0:
                steer = has & (benefit >= dl)
            elif f_max <= 0.0:
                steer = np.zeros(T, bool)
            elif not (benefit > floor).any():  # the select is skipped
                steer = np.zeros(T, bool)
            else:
                q = kernel_quantile(benefit, 1.0 - f_max)
                steer = has & (benefit > (floor if q < floor else q))
        src = np.where(steer, k + best, i)
        experts[:, i] = cand[rows, src]
        chosen[:, i] = vals[rows, src]
        steered[:, i] = steer
        used[rows[steer], best[steer]] = True
    ex = np.exp(chosen - chosen.max(1, keepdims=True))
    return experts, ex / ex.sum(1, keepdims=True), steered


STEER_CASES = [  # (T, E, k, d, f_max): the MR f_max < 1 cases and more
    (256, 16, 4, 2, 0.5), (250, 16, 4, 2, 0.25), (37, 8, 2, 2, 0.5),
    (512, 128, 8, 4, 0.25), (512, 128, 8, 2, 0.25), (1, 128, 8, 2, 0.25),
    (512, 16, 2, 2, 0.25), (1, 16, 4, 2, 0.25), (2, 16, 4, 2, 0.5),
    (300, 16, 4, 2, 0.0), (300, 16, 4, 2, 1.0), (40, 48, 12, 4, 0.5),
    (5000, 128, 8, 2, 0.25),
]


@pytest.mark.parametrize("variant", ["random", "ties", "balanced"])
@pytest.mark.parametrize("T,E,k,d,f_max", STEER_CASES)
def test_steer_emulation_matches_steer_from_candidates(T, E, k, d, f_max,
                                                       variant):
    rng = np.random.default_rng(T + E + k + d)
    logits = rng.standard_normal((T, E), np.float32) * 2.0
    load = np.abs(rng.standard_normal(E).astype(np.float32)) * 3.0
    if variant == "ties":
        logits = np.round(logits) / 2.0 + 0.0
        load = np.round(load)
    if variant == "balanced":
        load = np.ones(E, np.float32)
    logits, load = logits.astype(np.float32), load.astype(np.float32)
    cand, vals = ref.top_candidates(torch.as_tensor(logits), k + d)
    want = ref.steer_from_candidates(cand, vals, torch.as_tensor(load), k,
                                     f_max=f_max)
    got = emulate_steer(cand.numpy(), vals.numpy(), load, k, f_max=f_max)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[2], want[2].numpy())
    np.testing.assert_allclose(got[1], want[1].numpy(), **W_TOL)
    if variant == "balanced" or f_max <= 0.0 or T == 1:
        assert not got[2].any()


def test_steer_emulation_with_infinite_loads():
    """An infinite primary load gives an infinite (or NaN) benefit:
    counted as -1e9 by the quantile, and an infinite one steers."""
    rng = np.random.default_rng(11)
    T, E, k, d = 64, 16, 4, 2
    logits = (rng.standard_normal((T, E)) * 2.0).astype(np.float32)
    load = (np.abs(rng.standard_normal(E)) * 3.0).astype(np.float32)
    load[::5] = np.inf
    cand, vals = ref.top_candidates(torch.as_tensor(logits), k + d)
    for f_max in (0.25, 0.5, 1.0):
        want = ref.steer_from_candidates(cand, vals, torch.as_tensor(load),
                                         k, f_max=f_max)
        got = emulate_steer(cand.numpy(), vals.numpy(), load, k,
                            f_max=f_max)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[2], want[2].numpy())
        assert got[2].any()


@pytest.mark.parametrize("f_max", [0.1, 0.25, 0.5, 0.9])
@pytest.mark.parametrize("seed", range(4))
def test_one_token_at_fmax_below_one_never_steers(seed, f_max):
    """At T = 1 the quantile of one benefit is that benefit, and a steer
    needs a benefit strictly above it: a decode token never steers at
    f_max < 1, under any finite load, in the reference, the plain port
    and the kernel's algorithm alike."""
    rng = np.random.default_rng(seed)
    E, k, d = 128, 8, 2
    logits = (rng.standard_normal((1, E)) * 2.0).astype(np.float32)
    load = (np.abs(rng.standard_normal(E)) * 3.0).astype(np.float32)
    # the heaviest experts where the token's gate points: every slot has
    # an alternate far below its primary's load
    load[np.argsort(-logits[0])[:k]] += np.float32(50.0)
    je, jw, js = jref.midas_dispatch(jnp.asarray(logits), jnp.asarray(load),
                                     k, d, f_max=f_max)
    assert not np.asarray(js).any()
    got = ref.midas_dispatch(torch.as_tensor(logits), torch.as_tensor(load),
                             k, d, f_max=f_max)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(je))
    assert not got[2].any()
    cand, vals = ref.top_candidates(torch.as_tensor(logits), k + d)
    emu = emulate_steer(cand.numpy(), vals.numpy(), load, k, f_max=f_max)
    assert not emu[2].any()
    # the same token under the margin rule steers: the load has teeth
    _, _, s1 = jref.midas_dispatch(jnp.asarray(logits), jnp.asarray(load),
                                   k, d, f_max=1.0)
    assert np.asarray(s1).any()
