"""The port's MoE dispatch and MoE layer against the JAX reference on
the CPU.

The plain dispatch (``kernels/midas_route/ref.py``) is held against
the reference's ``ref`` and its Pallas kernel run in interpret mode, on
tests/test_kernels.py's MR_CASES and MR_FMAX_CASES (ragged T
included), on logits with many exact ties, and on a batch whose f_max
quantile is decided by the reference's fused multiply-add: experts and
steered exactly equal, weights within 1e-6 (absolute; the two
softmaxes round their exponentials differently).  The MoE layer, the
model's ``forward`` with non-uniform telemetry, prefill and decode run
with the reference's weights converted: outputs within 1e-5 (the
layer) and logits within 1e-4 (the model; the two packages order
their float32 sums differently), the dispatch, the drop rate, the
expert load and the new telemetry state exactly equal.  Inputs are
made with numpy and handed to both.  Logits never hold -0.0, which
``jax.lax.top_k`` may rank apart from +0.0.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.config import get_smoke_arch as jget_smoke_arch  # noqa: E402
from repro.kernels.midas_route import kernel as jkernel  # noqa: E402
from repro.kernels.midas_route import ref as jref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert, models  # noqa: E402
from repro_torch.config import get_smoke_arch  # noqa: E402
from repro_torch.kernels.midas_route import ops, ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402

W_TOL = dict(rtol=0.0, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
MOE_ARCHS = ["qwen3-moe-235b-a22b", "dbrx-132b", "jamba-v0.1-52b"]

# (T, E, k, d, f_max, tile): tests/test_kernels.py's MR_CASES (f_max 1,
# tile 128) and MR_FMAX_CASES
MR_CASES = [
    (256, 8, 2, 2, 1.0, 128),
    (256, 16, 4, 2, 1.0, 128),
    (512, 128, 8, 4, 1.0, 128),
    (256, 4, 2, 2, 1.0, 128),
    (256, 16, 4, 2, 0.5, 8),
    (256, 16, 4, 2, 0.5, 256),
    (250, 16, 4, 2, 0.25, 128),
    (37, 8, 2, 2, 0.5, 8),
    (512, 128, 8, 4, 0.25, 256),
    (250, 16, 4, 2, 1.0, 128),
]


def _logits_load(T, E, seed, ties=False):
    """(T, E) logits and an (E,) skewed load, float32 numpy; with
    ``ties`` both take a few values only."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E), np.float32) * 2.0
    load = np.abs(rng.standard_normal(E).astype(np.float32)) * 3.0
    if ties:
        logits = np.round(logits) / 2.0
        load = np.round(load)
    return logits.astype(np.float32) + 0.0, load.astype(np.float32)


def _check_equal(got, want):
    e, w, s = (x.numpy() for x in got)
    np.testing.assert_array_equal(e, np.asarray(want[0]))
    np.testing.assert_array_equal(s, np.asarray(want[2]))
    np.testing.assert_allclose(w, np.asarray(want[1]), **W_TOL)
    assert e.dtype == np.int32 and w.dtype == np.float32 and s.dtype == bool


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("T,E,k,d,f_max,tile", MR_CASES)
def test_plain_dispatch_matches_reference_and_pallas(T, E, k, d, f_max,
                                                     tile, ties):
    logits, load = _logits_load(T, E, seed=T + E, ties=ties)
    jl, jld = jnp.asarray(logits), jnp.asarray(load)
    want = jref.midas_dispatch(jl, jld, k, d, f_max=f_max)
    pallas = jkernel.midas_dispatch(jl, jld, k, d, f_max=f_max, tile=tile,
                                    interpret=True)
    got = ref.midas_dispatch(torch.as_tensor(logits), torch.as_tensor(load),
                             k, d, f_max=f_max)
    _check_equal(got, want)
    _check_equal(got, pallas)
    if E > k + 1:  # the skewed load steers somewhere: the check has teeth
        assert got[2].any()


@pytest.mark.parametrize("f_max", [1.0, 0.5, 0.25, 0.0])
def test_steer_from_candidates_matches_reference(f_max):
    logits, load = _logits_load(300, 16, seed=3)
    vals, cand = jax.lax.top_k(jnp.asarray(logits), 6)
    want = jref.steer_from_candidates(cand.astype(jnp.int32), vals,
                                      jnp.asarray(load), 4, f_max=f_max)
    got = ref.steer_from_candidates(
        torch.as_tensor(np.array(cand, np.int32)),
        torch.as_tensor(np.array(vals)), torch.as_tensor(load), 4,
        f_max=f_max)
    _check_equal(got, want)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_top_candidates_and_topk_match_reference(k, ties):
    logits, _ = _logits_load(64, 8, seed=k, ties=ties)
    vals, ids = jax.lax.top_k(jnp.asarray(logits), k)
    got_ids, got_vals = ref.top_candidates(torch.as_tensor(logits), k)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got_vals.numpy(), np.asarray(vals))
    e, w = ref.topk_dispatch(torch.as_tensor(logits), k)
    je, jw = jref.topk_dispatch(jnp.asarray(logits), k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **W_TOL)


def _unfused_quantile(x, q):
    """jnp.quantile's linear interpolation rounded twice (no FMA)."""
    s = np.sort(x)
    pos = np.float32(q) * np.float32(x.shape[0] - 1)
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = pos - lo
    return (np.float32(s[int(hi)] * w_hi)
            + np.float32(s[int(lo)] * (np.float32(1.0) - w_hi)))


@pytest.mark.parametrize("seed", [200, 2257])
def test_fma_rounded_quantile_decides_a_steer(seed):
    """One slot, three (primary, alternate) pairs repeated over the
    batch: many equal benefits, so the f_max threshold lands on one of
    them.  The reference's quantile rounds its interpolation once (a
    fused multiply-add); rounded twice it would steer other tokens."""
    rng = np.random.default_rng(seed)
    T = int(rng.integers(5, 60))
    f_max = float(rng.choice([0.25, 0.3, 0.4, 0.6, 0.7]))
    load = (rng.random(8) * 10).astype(np.float32)
    pairs = [(int(a), int(b)) for a, b in rng.integers(0, 8, (3, 2))
             if a != b]
    cand = np.array([pairs[i] for i in rng.integers(0, len(pairs), T)],
                    np.int32)
    vals = np.zeros((T, 2), np.float32)
    want = jref.steer_from_candidates(jnp.asarray(cand), jnp.asarray(vals),
                                      jnp.asarray(load), 1, f_max=f_max)
    got = ref.steer_from_candidates(torch.as_tensor(cand),
                                    torch.as_tensor(vals),
                                    torch.as_tensor(load), 1, f_max=f_max)
    _check_equal(got, want)
    benefit = load[cand[:, 0]] - load[cand[:, 1]]
    has = load[cand[:, 1]] <= load[cand[:, 0]] - np.float32(2.0)
    finite = np.where(has, benefit, np.float32(-1e9)).astype(np.float32)
    unfused = has & (benefit > max(_unfused_quantile(finite, 1.0 - f_max),
                                   np.float32(2.0)))
    assert not np.array_equal(unfused, got[2].numpy()[:, 0])
    q = ref.quantile(torch.as_tensor(finite), 1.0 - f_max)
    assert q.item() == float(jnp.quantile(jnp.asarray(finite), 1.0 - f_max))


def test_dispatch_reduces_load_dispersion():
    """Steering pushes the realised expert load toward balance when
    the telemetry is imbalanced (tests/test_kernels.py's claim)."""
    rng = np.random.default_rng(7)
    T, E, k = 4096, 16, 4
    logits = torch.as_tensor(rng.standard_normal((T, E), np.float32) * 2.0)
    load = torch.tensor([5.0] * 4 + [0.5] * 12)
    e_van, _ = ref.topk_dispatch(logits, k)
    e_mid, _, steered = ref.midas_dispatch(logits, load, k, 4, f_max=1.0)
    assert steered.sum() > 0
    assert (e_mid < 4).float().mean() < (e_van < 4).float().mean()


def test_dispatch_respects_fmax_zero():
    rng = np.random.default_rng(8)
    logits = torch.as_tensor(rng.standard_normal((256, 8), np.float32))
    load = torch.as_tensor(np.abs(rng.standard_normal(8, np.float32)) * 5)
    e0, _, s0 = ref.midas_dispatch(logits, load, 2, 2, f_max=0.0)
    e_van, _ = ref.topk_dispatch(logits, 2)
    assert not s0.any()
    assert torch.equal(e0, e_van)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_ops_dispatch_on_the_cpu(impl):
    """On CPU tensors "auto" is the plain version; k + d spanning every
    expert (d_eff <= 0) is plain top-k on every impl, as the reference
    kernel does; "cuda" raises."""
    logits, load = _logits_load(128, 8, seed=9)
    lt, ld = torch.as_tensor(logits), torch.as_tensor(load)
    for f_max in (1.0, 0.25):
        got = ops.midas_dispatch(lt, ld, 2, 2, f_max=f_max, impl=impl)
        want = ref.midas_dispatch(lt, ld, 2, 2, f_max=f_max)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    e, w, s = ops.midas_dispatch(lt[:, :4], ld[:4], 4, 2, impl=impl)
    je, jw = jref.topk_dispatch(jnp.asarray(logits[:, :4]), 4)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert not s.any()
    with pytest.raises(ValueError, match="CUDA device"):
        ops.midas_dispatch(lt, ld, 2, 2, impl="cuda")


@pytest.mark.parametrize("T,E,k", [(37, 8, 2), (250, 16, 4), (512, 128, 8)])
def test_expert_load_matches_compiled_reference(T, E, k):
    rng = np.random.default_rng(T)
    experts = rng.integers(0, E, (T, k)).astype(np.int32)
    want = jax.jit(jref.expert_load, static_argnums=1)(
        jnp.asarray(experts), E)
    got = ref.expert_load(torch.as_tensor(experts), E)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_update_load_ewma_matches_compiled_reference():
    rng = np.random.default_rng(5)
    a = np.abs(rng.standard_normal(4096)).astype(np.float32) * 3
    b = np.abs(rng.standard_normal(4096)).astype(np.float32) * 3
    want = jax.jit(jmoe.update_load_ewma)(jnp.asarray(a), jnp.asarray(b))
    got = moe.update_load_ewma(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the MoE layer and the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """arch -> (jax cfg, jax params, port cfg, port model), built once."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg, cfg = jget_smoke_arch(arch), get_smoke_arch(arch)
            params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
            model = convert.params_from_numpy(
                cfg, jax.device_get(params), device="cpu")
            made[arch] = (jcfg, params, cfg, model)
        return made[arch]

    return get


def _skewed(E, seed):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.standard_normal(E)) * 3.0).astype(np.float32)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
def test_moe_apply_matches_reference(pair, arch, capacity_factor):
    jcfg, params, cfg, model = pair(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    p = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["0"]["ffn"])
    layer = moe.MoE(cfg)
    for name in ("router", "w_gate", "w_up", "w_down"):
        getattr(layer, name).copy_(torch.as_tensor(np.asarray(p[name])))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, cfg.d_model), np.float32)
    load = _skewed(cfg.moe.num_experts, 4)
    jy, jaux = jax.jit(jmoe.moe_apply, static_argnums=1)(
        p, jcfg, jnp.asarray(x), jnp.asarray(load))
    y, aux = layer(torch.as_tensor(x), torch.as_tensor(load))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_array_equal(aux.load.numpy(), np.asarray(jaux.load))
    np.testing.assert_array_equal(aux.drop_rate.numpy(),
                                  np.asarray(jaux.drop_rate))
    assert aux.steer_rate.item() == float(jaux.steer_rate) > 0
    np.testing.assert_allclose(aux.aux_loss.numpy(),
                               np.asarray(jaux.aux_loss), **MOE_TOL)
    if capacity_factor < 1:
        assert float(jaux.drop_rate) > 0

    # the dispatch itself on the reference's gate logits
    T, E = 48, cfg.moe.num_experts
    gate = jnp.einsum("td,de->te", jnp.asarray(x).reshape(T, -1),
                      p["router"]).astype(jnp.float32)
    je, jw, js = jmoe._dispatch(jcfg, gate, jnp.asarray(load), T, E)
    got = moe.dispatch(cfg, torch.as_tensor(np.asarray(gate)),
                       torch.as_tensor(load))
    _check_equal(got, (je, jw, js))
    flat = np.asarray(je).reshape(-1)
    np.testing.assert_array_equal(
        moe.positions_within_expert(torch.as_tensor(flat), E).numpy(),
        np.asarray(jmoe._positions_within_expert(jnp.asarray(flat), E)))
    assert moe.capacity(cfg, T) == min(max(int(
        -(-cfg.moe.experts_per_token * T // E) * capacity_factor), 1), T)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_with_moe_state_matches_reference(pair, arch):
    """Non-uniform telemetry, so tokens steer; the reference's forward
    compiled, as its train step runs it (the EWMA as one fused
    multiply-add)."""
    jcfg, params, cfg, model = pair(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    state = {pos: (np.abs(rng.standard_normal(a.shape)) * 3).astype(
        np.float32) for pos, a in jmodels.init_moe_state(jcfg).items()}
    jstate = {pos: jnp.asarray(a) for pos, a in state.items()}
    want, wstate, waux = jax.jit(jmodels.forward, static_argnums=1)(
        params, jcfg, {"tokens": jnp.asarray(toks)}, jstate)
    got, gstate, gaux = models.forward(
        model, {"tokens": torch.as_tensor(toks)},
        moe_state=convert.moe_state_from_numpy(cfg, state, device="cpu"),
        return_moe=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert sorted(gstate) == sorted(wstate) == sorted(gaux)
    steered = 0.0
    for pos in wstate:
        np.testing.assert_array_equal(gstate[pos].numpy(),
                                      np.asarray(wstate[pos]))
        for f in ("load", "drop_rate", "steer_rate"):
            np.testing.assert_array_equal(
                getattr(gaux[pos], f).numpy(),
                np.asarray(getattr(waux[pos], f)), err_msg=f)
        steered += float(gaux[pos].steer_rate.sum())
    assert steered > 0
    # without telemetry: logits only, and balanced loads never steer
    plain = models.forward(model, {"tokens": torch.as_tensor(toks)})
    _, _, aux = models.forward(model, {"tokens": torch.as_tensor(toks)},
                               return_moe=True)
    assert plain.shape == got.shape
    assert all(float(a.steer_rate.sum()) == 0 for a in aux.values())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_reference(pair, arch):
    """The reference's prefill (balanced telemetry), then decode steps
    (none) from a float32 cache; the port continues from its own
    prefill."""
    jcfg, params, cfg, model = pair(arch)
    P, S = 8, 12
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = jmodels.prefill(params, jcfg,
                             {"tokens": jnp.asarray(toks[:, :P])},
                             cache_len=S, cache_dtype=jnp.float32)
    tl, tc = models.prefill(model, {"tokens": torch.as_tensor(toks[:, :P])},
                            cache_len=S, cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for t in range(P, S):
        pos = np.full((2,), t, np.int32)
        jl, jc = jmodels.decode_step(params, jcfg, jc,
                                     jnp.asarray(toks[:, t:t + 1]),
                                     jnp.asarray(pos))
        tl, tc = models.decode_step(model, tc,
                                    torch.as_tensor(toks[:, t:t + 1]),
                                    torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"{arch} pos {t}")
    for pos in jc:
        for name, a in jc[pos].items():
            np.testing.assert_allclose(tc[pos][name].numpy(), np.asarray(a),
                                       **LOGIT_TOL)


def test_init_params_follows_the_reference_moe_rules():
    cfg = get_smoke_arch("dbrx-132b")
    model = models.init_params(cfg, seed=2, device="cpu")
    ffn = model.blocks[1]["0"].ffn
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    assert isinstance(ffn, moe.MoE)
    for w, fan_in in ((ffn.router, d), (ffn.w_gate, d), (ffn.w_up, d),
                      (ffn.w_down, f), (model.blocks[0]["0"].mixer.wq, d)):
        std = float(w.std()) * fan_in ** 0.5
        assert 0.85 < std < 1.15, (w.shape, std)


def test_moe_conversion_checks_shapes(pair):
    jcfg, params, cfg, model = pair("qwen3-moe-235b-a22b")
    tree = jax.device_get(params)
    ffn = model.blocks[2]["0"].ffn
    np.testing.assert_array_equal(
        ffn.w_gate.numpy(),
        np.asarray(tree["blocks"]["0"]["ffn"]["w_gate"][2]))
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["blocks"]["0"]["ffn"]["w_down"] = np.zeros((3, 8, 64, 65), np.float32)
    with pytest.raises(ValueError, match="ffn/w_down"):
        convert.params_from_numpy(cfg, bad, device="cpu")
    state = jax.device_get(jmodels.init_moe_state(jcfg))
    got = convert.moe_state_from_numpy(cfg, state, device="cpu")
    assert sorted(got) == ["0"] and got["0"].shape == (3, 8)
    assert torch.equal(got["0"], models.init_moe_state(cfg, "cpu")["0"])
    with pytest.raises(ValueError, match="shape"):
        convert.moe_state_from_numpy(cfg, {"0": np.ones((3, 7))},
                                     device="cpu")
    with pytest.raises(ValueError, match="positions"):
        convert.moe_state_from_numpy(cfg, {"1": np.ones((3, 8))},
                                     device="cpu")
