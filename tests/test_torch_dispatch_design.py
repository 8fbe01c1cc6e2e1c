"""The algorithms of the CUDA dispatch kernels, on the CPU.

``csrc/midas_dispatch.cu`` selects a row's top-(k+d) by rank counting
and finds the f_max quantile of ``dispatch_steer`` by counting stable
ranks among the benefits at or above the floor (by shuffles in one
warp, or over each warp's slots in shared memory), or by a radix select
above a crossover and beyond the register kernel's tokens.  None of it
can run here, so this file emulates each on the same layout (rows
padded to float4s, a thread's elements e + m·cover; each warp's values
at or above the floor first and +inf after, read in float4s; the
select's 8-bit digits, histograms, one-warp scan and early stop) and
holds them against the plain functions they replace:

- rank by counting against ``ref.top_candidates`` (ids and values bit
  for bit), with ties, E = 4, 16, 128 and 1024 and ragged T;
- the radix select and the counting select of ``s[low]`` and
  ``s[high]`` against ``torch.sort`` (bit for bit up to the sign of a
  zero), with -1e9 pads for non-finite benefits, repeated values, +-0,
  T = 1 (no pass) and T = 2, equal keys across the two ranks, and the
  rule that lets a slot skip the select: when ``s[high]`` lies below
  the floor, the interpolated quantile does not exceed it;
- ``ref.quantile_plan`` with the double-rounded interpolation against
  ``ref.quantile``, bit for bit, and against ``jnp.quantile``;
- the whole of ``dispatch_steer``'s slot loop, the register kernel's
  and the shared-memory kernel's, against
  ``ref.steer_from_candidates`` and the live JAX reference: experts and
  steered bit for bit, weights within 1e-6, at T = 31, 32, 33, 1024 and
  1025 and on either side of the select's crossover;
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
# the register kernel's select (dispatch_steer up to STEER_REG_T tokens)
# ---------------------------------------------------------------------------


def quantile_values(b):
    """What the quantile ranks: where(isfinite(b), b, -1e9)."""
    return np.where(np.isfinite(b), b, np.float32(-1e9)).astype(np.float32)


def warp_ranks(f, ge):
    """T <= 32: each lane's stable rank among the values at or above the
    floor, from the 32 shuffles of the kernel's warp path (+inf for a
    value not ranked)."""
    keys = np.full(32, np.float32(np.inf))
    keys[:f.size] = np.where(ge, f, np.float32(np.inf))
    x = f[:, None]
    j, lane = np.arange(32)[None, :], np.arange(f.size)[:, None]
    v = keys[None, :]
    return ((v < x) | ((v == x) & (j < lane))).sum(1)


def block_ranks(f, ge):
    """Up to STEER_REG_T tokens: each warp writes its values at or above
    the floor first (the ballot's prefix) and +inf after into its 32
    slots; a ranked thread counts every slot of earlier warps with <=,
    its own warp's by position, later warps' with < (+inf never
    counts)."""
    T = f.size
    nt = -(-T // 32) * 32
    nw = nt // 32
    fp = np.full(nt, np.float32(-1e9))
    fp[:T] = f
    gp = np.zeros(nt, bool)
    gp[:T] = ge
    seg = np.full((nw, 32), np.float32(np.inf))
    pos = np.zeros(nt, np.int64)
    for w in range(nw):
        lanes = gp[32 * w:32 * w + 32]
        cw = int(lanes.sum())
        above = np.cumsum(lanes) - lanes  # ranked lanes below this one
        other = np.cumsum(~lanes) - ~lanes
        p = np.where(lanes, above, cw + other)
        assert sorted(p) == list(range(32))  # a stable partition
        seg[w, p] = np.where(lanes, fp[32 * w:32 * w + 32], np.inf)
        pos[32 * w:32 * w + 32] = p
    vals = seg.reshape(-1)
    wid = np.repeat(np.arange(nw), 32)
    j = np.tile(np.arange(32), nw)
    t = np.nonzero(gp)[0]
    x, wt = fp[t][:, None], (t // 32)[:, None]
    v = vals[None, :]
    hit = np.where(wid[None, :] < wt, v <= x,
                   np.where(wid[None, :] > wt, v < x,
                            (v < x) | ((v == x)
                                       & (j[None, :] < pos[t][:, None]))))
    r = np.zeros(nt, np.int64)
    r[t] = hit.sum(1)
    return r[:T]


def reg_select(b, low, high, floor, *, warp, count_max):
    """The register kernel's s[low] and s[high], or None when s[high]
    lies below the floor (the threshold is then the floor): only the G
    values at or above the floor are ranked, at T - G and up; s[low]
    below the floor is the largest value below it; beyond count_max
    tokens, the radix select.  Returns (lo, hi, how)."""
    f = quantile_values(b)
    T = f.size
    ge = f >= floor
    G = int(ge.sum())
    if G < T - high:
        return None
    if T > count_max and not warp:
        lo, hi, _ = radix_select(f, low, high)
        return lo, hi, "digits"
    assert not warp or T <= 32
    rank = T - G + (warp_ranks(f, ge) if warp else block_ranks(f, ge))
    assert sorted(rank[ge]) == list(range(T - G, T))  # a permutation
    hi = f[ge & (rank == high)]
    assert hi.size == 1
    if G >= T - low:
        lo = f[ge & (rank == low)]
        assert lo.size == 1
        lo = lo[0]
    else:  # G = T - high = T - low - 1: the warps' largest keys
        lo = key_value(order_key(f[~ge]).max())
    return lo, hi[0], "warp" if warp else "count"


def select_floors(b):
    """Floors that rank every value, about half of them, and none."""
    f = quantile_values(b)
    return (np.float32(-3e38), np.float32(np.median(f)), np.float32(2.0),
            np.float32(np.max(f)), np.nextafter(np.max(f), np.float32(np.inf)))


@pytest.mark.parametrize("q", [0.0, 0.5, 0.75, 0.9, 1.0])
@pytest.mark.parametrize("name,b", list(benefit_vectors()),
                         ids=[n for n, _ in benefit_vectors()])
def test_counting_select_matches_sort(name, b, q):
    """The warp path (T <= 32) and the block path count the same stable
    ranks; the values they return are torch.sort's, and a skipped select
    is one whose quantile does not exceed the floor."""
    n = b.shape[0]
    low, high, w_high, w_low = ref.quantile_plan(n, q)
    f = quantile_values(b)
    s = torch.sort(torch.as_tensor(f)).values.numpy()
    paths = [False] + ([True] if n <= 32 else [])
    for floor in select_floors(b):
        for warp in paths:
            got = reg_select(b, low, high, floor, warp=warp, count_max=n)
            if got is None:
                assert s[high] < floor
                assert interpolate(s[low], s[high], w_high, w_low) <= floor
                continue
            assert s[high] >= floor
            lo, hi, how = got
            assert how == ("warp" if warp else "count")
            for g, want in ((lo, s[low]), (hi, s[high])):
                assert g == want  # float equality: +-0 alike
                if want != 0:
                    assert g.view(np.uint32) == want.view(np.uint32)
            # beyond the crossover the radix select gives the same values
            assert reg_select(b, low, high, floor, warp=False,
                              count_max=0)[:2] == (lo, hi)


def near_floor_vectors(rng, n, floor):
    """Benefits on and about the floor: the floor, its float neighbours,
    a few ulps away, pads, far values."""
    below = np.nextafter(floor, np.float32(-np.inf))
    pool = np.array([floor, below, np.nextafter(floor, np.float32(np.inf)),
                     np.nextafter(below, np.float32(-np.inf)), -np.inf,
                     -1e9, floor - np.float32(1.0), floor * np.float32(0.5),
                     -floor, 0.0, -0.0], np.float32)
    b = rng.choice(pool, n)
    mix = rng.random(n) < 0.3
    b[mix] = (floor + rng.standard_normal(mix.sum()) * 2.0 ** int(
        rng.integers(-24, 4)) * max(abs(floor), 1e-30)).astype(np.float32)
    return b.astype(np.float32)


@pytest.mark.parametrize("seed", range(24))
def test_below_floor_quantile_never_exceeds_the_floor(seed):
    """The select is skipped when s[high] lies below the floor: then
    lo <= hi < floor, and the interpolation rounded as the kernel rounds
    it (the product and the sum in double) lands at or below the floor,
    on values a few ulps from it, with q's from 0 to 1 (positions below
    1 among them, where w_high + w_low is 1 only to float32's
    precision), at floors of either sign."""
    rng = np.random.default_rng(seed)
    for floor in (np.float32(2.0), np.float32(2.0 - 1e-9 * seed),
                  np.float32(-1e-9), np.float32(0.5), np.float32(-3.0),
                  np.float32(1e-30), np.float32(1024.0)):
        for _ in range(40):
            n = int(rng.integers(1, 80))
            b = near_floor_vectors(rng, n, floor)
            s = np.sort(quantile_values(b))
            for q in (rng.random(), 0.75, 0.5, 1.0 / n, 0.999, 0.0, 1.0):
                low, high, w_high, w_low = ref.quantile_plan(n, q)
                if s[high] < floor:
                    assert interpolate(s[low], s[high], w_high, w_low) <= floor
                    assert reg_select(b, low, high, floor, warp=False,
                                      count_max=n) is None


def test_equal_keys_across_low_and_high():
    """Equal values straddle ranks low and high (and the floor): the
    stable ranks give each rank one writer, in both paths."""
    for T, q in ((32, 0.75), (31, 0.5), (33, 0.75), (512, 0.75),
                 (1024, 0.9)):
        low, high, w_high, w_low = ref.quantile_plan(T, q)
        b = np.full(T, np.float32(3.0))
        b[:low - 2] = -np.inf
        b[T - 2:] = 7.0
        b[::7] = 2.0  # on the floor
        s = np.sort(quantile_values(b))
        assert s[low] == s[high] or s[high] == 3.0
        for warp in ([True, False] if T <= 32 else [False]):
            lo, hi, _ = reg_select(b, low, high, np.float32(2.0), warp=warp,
                                   count_max=T)
            assert (lo, hi) == (s[low], s[high])


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


def test_one_token_threshold_is_its_value():
    """At T = 1 the register kernel takes the token's own value f as the
    quantile (no shuffle): the plan is (0, 0, 0, 1) at every q, and the
    double-rounded interpolation of (f, f) is f, bit for bit, -0.0,
    subnormals and the -1e9 pad included."""
    rng = np.random.default_rng(3)
    f = np.concatenate([(rng.standard_normal(2000) * 10.0 ** rng.integers(
        -40, 38, 2000)).astype(np.float32),
        np.array([0.0, -0.0, -1e9, 1e-45, -3e38], np.float32)])
    for q in (0.0, 0.1, 0.25, 0.5, 0.75, 0.999, 1.0):
        assert ref.quantile_plan(1, q) == (0, 0, 0.0, 1.0)
    for x in f:
        assert interpolate(x, x, 0.0, 1.0).view(np.uint32) == \
            np.float32(x).view(np.uint32)


# ---------------------------------------------------------------------------
# dispatch_steer's slot loop, whole
# ---------------------------------------------------------------------------


def emulate_steer(cand, vals, load, k, *, delta_l=2.0, gate_slack=1.0,
                  f_max=1.0, count_max=None, warp=True, stats=None):
    """dispatch_steer on numpy float32, on the kernel the launcher picks
    (``kernel.steer_path``): each slot's benefit and best alternate per
    token, the threshold, the steer, and the softmax of the chosen
    logits.  The register kernel's threshold comes from ``reg_select``
    (``count_max``: the wrapper's crossover; ``warp``: its plan at T <=
    32), the shared-memory kernel's from the radix select once a benefit
    exceeds the floor.  ``stats`` counts the selects by kind."""
    T, kd = cand.shape
    d = kd - k
    on_regs = kernel.steer_path(T) == "registers"
    count_max = kernel.STEER_COUNT_MAX if count_max is None else count_max
    stats = {} if stats is None else stats
    dl, slack = np.float32(delta_l), np.float32(gate_slack)
    floor = np.float32(delta_l - 1e-9)
    low, high, w_high, w_low = ref.quantile_plan(T, 1.0 - f_max)
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
            else:
                thr, how = floor, None
                if on_regs:
                    got = reg_select(benefit, low, high, floor,
                                     warp=warp and T <= 32,
                                     count_max=count_max)
                    if got is not None:
                        lo, hi, how = got
                elif (benefit > floor).any():
                    lo, hi, _ = radix_select(benefit, low, high)
                    how = "digits"
                if how is not None:
                    q = interpolate(lo, hi, w_high, w_low)
                    thr = floor if q < floor else q
                    stats[how] = stats.get(how, 0) + 1
                steer = has & (benefit > thr)
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


def hot_inputs(T, E, k, seed, ties=False):
    """Logits whose top k + d come in about the same order for every
    token (experts 0, 1, ... within the gate slack of each other) and a
    load hot on the first k experts and cooler after: most tokens have a
    benefit over the floor in the first slots, so the quantile's select
    runs.  ``ties`` rounds the load to integers: many equal benefits,
    some on the floor."""
    rng = np.random.default_rng(seed)
    logits = (-0.05 * np.arange(E)[None, :]
              + 0.02 * rng.standard_normal((T, E))).astype(np.float32)
    load = np.where(np.arange(E) < k, 6.0 + np.abs(rng.standard_normal(E)),
                    np.abs(rng.standard_normal(E)) * 3.0)
    if ties:
        load = np.round(load)
    return logits, load.astype(np.float32)


def assert_steer_equal(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **W_TOL)


# (T, E, k, d, the kernel): one warp, one warp's edges, a block's, the
# select's crossover, the register kernel's last token and the
# shared-memory kernel's first, k + d = 16 with E = 1024, 1024 and 1025
EDGE_CASES = [
    (31, 128, 8, 2, "registers"), (32, 128, 8, 2, "registers"),
    (33, 128, 8, 2, "registers"),
    (kernel.STEER_COUNT_MAX, 128, 8, 2, "registers"),
    (kernel.STEER_COUNT_MAX + 1, 128, 8, 2, "registers"),
    (512, 128, 8, 2, "registers"), (513, 128, 8, 2, "shared memory"),
    (200, 1024, 12, 4, "registers"), (512, 1024, 12, 4, "registers"),
    (513, 64, 12, 4, "shared memory"),
    (1024, 128, 8, 2, "shared memory"), (1025, 128, 8, 2, "shared memory"),
]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("T,E,k,d,path", EDGE_CASES)
def test_steer_emulation_at_the_design_edges(T, E, k, d, path, ties):
    assert kernel.steer_path(T) == path
    how = ("warp" if T <= 32 else "count" if T <= kernel.STEER_COUNT_MAX
           else "digits")
    logits, load = hot_inputs(T, E, k, T + E, ties)
    cand, vals = ref.top_candidates(torch.as_tensor(logits), k + d)
    for f_max in (0.25, 0.5):
        stats = {}
        got = emulate_steer(cand.numpy(), vals.numpy(), load, k,
                            f_max=f_max, stats=stats)
        want = ref.steer_from_candidates(cand, vals, torch.as_tensor(load), k,
                                         f_max=f_max)
        assert_steer_equal(got, [w.numpy() for w in want])
        assert stats.get(how, 0) > 0 and got[2].any()


@pytest.mark.parametrize("T,count_max,how", [
    (320, 319, "digits"), (320, 320, "count"), (321, 320, "digits"),
    (319, 320, "count"), (31, 0, "warp"), (33, 32, "digits")])
def test_steer_emulation_on_either_side_of_the_crossover(T, count_max, how):
    """Up to the crossover (count_max tokens) the register kernel counts
    ranks, beyond it runs the radix select, and one warp shuffles
    whatever the crossover: the same steers either way."""
    E, k = 64, 8
    logits, load = hot_inputs(T, E, k, 3, ties=True)
    cand, vals = ref.top_candidates(torch.as_tensor(logits), k + 2)
    want = ref.steer_from_candidates(cand, vals, torch.as_tensor(load), k,
                                     f_max=0.25)
    stats = {}
    got = emulate_steer(cand.numpy(), vals.numpy(), load, k, f_max=0.25,
                        count_max=count_max, stats=stats)
    assert_steer_equal(got, [w.numpy() for w in want])
    assert set(stats) == {how}


@pytest.mark.parametrize("T,k,d,f_max", [(1, 8, 2, 0.25), (31, 8, 2, 0.3),
                                         (33, 8, 2, 0.25), (200, 4, 2, 0.5),
                                         (96, 12, 4, 0.75)])
def test_register_emulation_matches_the_jax_reference(T, k, d, f_max):
    """The register kernel's algorithm against the live JAX
    ``steer_from_candidates`` on batches whose selects run (one warp,
    both paths' edges, tied benefits on the floor)."""
    logits, load = hot_inputs(T, 64, k, T, ties=True)
    cand, vals = ref.top_candidates(torch.as_tensor(logits), k + d)
    want = jref.steer_from_candidates(jnp.asarray(cand.numpy()),
                                      jnp.asarray(vals.numpy()),
                                      jnp.asarray(load), k, f_max=f_max)
    stats = {}
    got = emulate_steer(cand.numpy(), vals.numpy(), load, k, f_max=f_max,
                        stats=stats)
    assert_steer_equal(got, want)
    assert any(stats.get(how) for how in ("warp", "count"))
    assert T == 1 or got[2].any()
