"""The port's model against the JAX reference on the CPU, with the
reference's weights converted by ``convert.params_from_numpy``: the
dense attention families and falcon-mamba (pure Mamba-1).

Tolerances: logits and float32 cache leaves within 1e-4 (relative and
absolute); the two packages order their float32 sums differently.  A
bfloat16 cache leaf may differ by one bfloat16 step (2**-7 relative),
since a float32 difference of one ulp can round to the neighbouring
bfloat16.  The port's own prefill-then-decode is held against its own
forward at tests/test_serving_path.py's 2e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.config import get_smoke_arch as jget_smoke_arch  # noqa: E402
from repro_torch import convert, models  # noqa: E402
from repro_torch.config import get_smoke_arch  # noqa: E402

DENSE = ["smollm-360m", "gemma2-2b", "stablelm-1.6b", "starcoder2-3b"]
SERVING = ["smollm-360m", "gemma2-2b"]
MAMBA = "falcon-mamba-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-6)


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


def _tokens(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", DENSE + [MAMBA])
def test_forward_matches_reference(pair, arch):
    jcfg, params, cfg, model = pair(arch)
    toks = _tokens(cfg, 2, 12)
    want, _, _ = jmodels.forward(params, jcfg, {"tokens": jnp.asarray(toks)})
    got = models.forward(model, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SERVING)
def test_prefill_matches_reference(pair, arch, cache_dtype):
    jcfg, params, cfg, model = pair(arch)
    toks = _tokens(cfg, 2, 10)
    want_lg, want_c = jmodels.prefill(
        params, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=14,
        cache_dtype=getattr(jnp, cache_dtype))
    got_lg, got_c = models.prefill(
        model, {"tokens": torch.as_tensor(toks)}, cache_len=14,
        cache_dtype=getattr(torch, cache_dtype))
    np.testing.assert_allclose(_np(got_lg), _np(want_lg), **TOL)
    tol = TOL if cache_dtype == "float32" else BF16_TOL
    assert sorted(got_c) == sorted(want_c)
    for pos in want_c:
        for name in ("k", "v"):
            g, w = got_c[pos][name], want_c[pos][name]
            assert g.dtype == getattr(torch, cache_dtype)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(_np(g), _np(w), **tol,
                                       err_msg=f"cache[{pos}][{name}]")


@pytest.mark.parametrize("arch", SERVING)
def test_decode_continuation_matches_reference(pair, arch):
    """Both packages prefill 8 tokens into a 13-row float32 cache, then
    decode the same 5 tokens; the port starts from its own prefill."""
    jcfg, params, cfg, model = pair(arch)
    P, S = 8, 13
    toks = _tokens(cfg, 2, S, seed=3)
    _, jc = jmodels.prefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :P])},
                            cache_len=S, cache_dtype=jnp.float32)
    _, tc = models.prefill(model, {"tokens": torch.as_tensor(toks[:, :P])},
                           cache_len=S, cache_dtype=torch.float32)
    for t in range(P, S):
        pos = np.full((2,), t, np.int32)
        jl, jc = jmodels.decode_step(params, jcfg, jc,
                                     jnp.asarray(toks[:, t:t + 1]),
                                     jnp.asarray(pos))
        tl, tc = models.decode_step(model, tc, torch.as_tensor(
            toks[:, t:t + 1]), torch.as_tensor(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"{arch} pos {t}")
    for pos in jc:
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc[pos][name]),
                                       _np(jc[pos][name]), **TOL)


def test_decode_writes_at_first_rows_position_clamped(pair):
    """The reference writes the new K/V of every row at ``pos[0]`` and
    clamps that index into the cache; each row still attends up to its
    own position.  The port starts from the converted reference cache."""
    jcfg, params, cfg, model = pair("smollm-360m")
    rng = np.random.default_rng(4)
    S = 9
    shape = (models.num_blocks(cfg), 2, S, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    jc = {"0": {n: jnp.asarray(rng.standard_normal(shape, np.float32))
                for n in ("k", "v")}}
    tc = convert.cache_from_numpy(cfg, jax.device_get(jc), device="cpu")
    for pos in ([5, 2], [S + 3, 4], [3, 7]):
        pos = np.array(pos, np.int32)
        toks = _tokens(cfg, 2, 1, seed=int(pos[0]))
        jl, jc = jmodels.decode_step(params, jcfg, jc, jnp.asarray(toks),
                                     jnp.asarray(pos))
        tl, tc = models.decode_step(model, tc, torch.as_tensor(toks),
                                    torch.as_tensor(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc["0"][name]),
                                       _np(jc["0"][name]), **TOL)


@pytest.mark.parametrize("arch", SERVING + [MAMBA])
def test_prefill_then_decode_matches_forward(arch):
    """The port's own serving path against its own forward, as
    tests/test_serving_path.py holds the reference."""
    cfg = get_smoke_arch(arch)
    model = models.init_params(cfg, seed=0, device="cpu")
    B, P, D = 2, 6, 4
    S = P + D
    toks = torch.as_tensor(_tokens(cfg, B, S, seed=7))
    ref = models.forward(model, {"tokens": toks})
    lg, cache = models.prefill(model, {"tokens": toks[:, :P]}, cache_len=S,
                               cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(lg[:, 0]), _np(ref[:, P - 1]),
                               rtol=2e-2, atol=2e-2)
    for t in range(P, S):
        pos = torch.full((B,), t, dtype=torch.int32)
        lg, cache = models.decode_step(model, cache, toks[:, t:t + 1], pos)
        np.testing.assert_allclose(_np(lg[:, 0]), _np(ref[:, t]),
                                   rtol=2e-2, atol=2e-2,
                                   err_msg=f"{arch} pos {t}")


def test_init_params_follows_the_reference_scale_rule():
    cfg = get_smoke_arch("stablelm-1.6b")
    model = models.init_params(cfg, seed=3, device="cpu")
    again = models.init_params(cfg, seed=3, device="cpu")
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(p, q), name
    blk = model.blocks[0]["0"]
    assert torch.equal(blk.pre_norm.scale, torch.ones(cfg.d_model))
    assert torch.equal(blk.pre_norm.bias, torch.zeros(cfg.d_model))
    assert torch.equal(blk.mixer.bq, torch.zeros_like(blk.mixer.bq))
    d, hd = cfg.d_model, cfg.resolved_head_dim
    for w, fan_in in ((blk.mixer.wq, d), (blk.mixer.wo, cfg.num_heads * hd),
                      (blk.ffn.w_down, cfg.d_ff),
                      (model.embed.tokens, 1), (model.embed.head, d)):
        std = float(w.std()) * fan_in ** 0.5
        assert 0.8 < std < 1.2, (w.shape, std)


def test_params_from_numpy_checks_shapes(pair):
    _, params, cfg, _ = pair("smollm-360m")
    tree = jax.device_get(params)
    bad = dict(tree, final_norm={"scale": np.ones(7, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        convert.params_from_numpy(cfg, bad, device="cpu")
    extra = dict(tree, frontend={"proj": np.ones((2, 2), np.float32)})
    with pytest.raises(ValueError, match="leaves"):
        convert.params_from_numpy(cfg, extra, device="cpu")
    with pytest.raises(ValueError, match="cache"):
        convert.cache_from_numpy(
            cfg, {"0": {"k": np.zeros((1, 1, 4, 9, 20), np.float32),
                        "v": np.zeros((1, 1, 4, 9, 20), np.float32)}},
            device="cpu")


@pytest.mark.parametrize("arch,item", [
    ("dbrx-132b", "item 11"), ("qwen3-moe-235b-a22b", "item 11"),
    ("jamba-v0.1-52b", "item 11"),
    ("musicgen-large", "item 8"), ("llava-next-mistral-7b", "item 8"),
])
def test_unported_families_raise(arch, item):
    """The families these items named as unported build now: the MoE
    families of item 11, and the audio and vision frontends of item 8
    (LLaVA's patch projector, MusicGen without a frontend parameter)."""
    cfg = get_smoke_arch(arch)
    model = models.init_params(cfg, device="cpu")
    if item == "item 11":
        assert sorted(models.init_moe_state(cfg, "cpu")) == [
            str(i) for i, spec in enumerate(model.pattern) if spec.is_moe]
    elif cfg.frontend == "vlm_patches":
        proj = model.frontend.proj
        assert tuple(proj.shape) == (cfg.d_model, cfg.d_model)
        # normal / sqrt(fan_in) with fan_in = d_model, as the reference
        assert 0.5 < float(proj.std()) * cfg.d_model ** 0.5 < 1.5
    else:
        assert not hasattr(model, "frontend")
    cache = models.init_decode_cache(cfg, 1, 8, device="cpu")
    if item == "item 8":
        assert cache["0"]["k"].shape == (cfg.num_layers, 1, 8,
                                         cfg.num_kv_heads,
                                         cfg.resolved_head_dim)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [10, 140])
def test_mamba_prefill_matches_reference(pair, S, cache_dtype):
    """The SSM state h in float32 within 1e-4 and the conv tail within
    one bfloat16 step; 140 tokens run the chunked scan (two chunks of
    128), 10 tokens the sequential one."""
    jcfg, params, cfg, model = pair(MAMBA)
    toks = _tokens(cfg, 2, S, seed=S)
    want_lg, want_c = jmodels.prefill(
        params, jcfg, {"tokens": jnp.asarray(toks)},
        cache_dtype=getattr(jnp, cache_dtype))
    got_lg, got_c = models.prefill(
        model, {"tokens": torch.as_tensor(toks)},
        cache_dtype=getattr(torch, cache_dtype))
    np.testing.assert_allclose(_np(got_lg), _np(want_lg), **TOL)
    assert sorted(got_c) == sorted(want_c)
    for pos in want_c:
        h, conv = got_c[pos]["h"], got_c[pos]["conv"]
        assert h.dtype == torch.float32
        assert conv.dtype == getattr(torch, cache_dtype)
        assert tuple(h.shape) == want_c[pos]["h"].shape
        assert tuple(conv.shape) == want_c[pos]["conv"].shape
        np.testing.assert_allclose(_np(h), _np(want_c[pos]["h"]), **TOL)
        tol = TOL if cache_dtype == "float32" else BF16_TOL
        np.testing.assert_allclose(_np(conv), _np(want_c[pos]["conv"]),
                                   **tol)


def test_mamba_decode_matches_reference(pair):
    """A few decode steps from the same (random) state in both
    packages, the port's converted by ``cache_from_numpy``; the port
    writes h and the shifted conv window in place."""
    jcfg, params, cfg, model = pair(MAMBA)
    rng = np.random.default_rng(6)
    jc = jax.device_get(jmodels.init_decode_cache(jcfg, 2, 8,
                                                  dtype=jnp.float32))
    jc = {pos: {n: jnp.asarray(rng.standard_normal(a.shape, np.float32))
                for n, a in c.items()} for pos, c in jc.items()}
    tc = convert.cache_from_numpy(cfg, jax.device_get(jc), device="cpu")
    views = {pos: dict(c) for pos, c in tc.items()}
    for t in range(4):
        toks = _tokens(cfg, 2, 1, seed=20 + t)
        pos = np.full((2,), t, np.int32)
        jl, jc = jmodels.decode_step(params, jcfg, jc, jnp.asarray(toks),
                                     jnp.asarray(pos))
        tl, tc = models.decode_step(model, tc, torch.as_tensor(toks),
                                    torch.as_tensor(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"step {t}")
        for p in jc:
            for name in ("h", "conv"):
                assert tc[p][name] is views[p][name]  # written in place
                np.testing.assert_allclose(_np(tc[p][name]),
                                           _np(jc[p][name]), **TOL)


def test_mamba_prompt_shorter_than_the_conv_window_raises(pair):
    _, _, cfg, model = pair(MAMBA)
    short = torch.as_tensor(_tokens(cfg, 1, cfg.mamba.d_conv - 2))
    with pytest.raises(ValueError, match="d_conv"):
        models.prefill(model, {"tokens": short})
    assert models.forward(model, {"tokens": short}).shape[1] == 2


def test_init_params_follows_the_reference_mamba_rules():
    cfg = get_smoke_arch(MAMBA)
    model = models.init_params(cfg, seed=1, device="cpu")
    mix = model.blocks[1]["0"].mixer
    st, dc = cfg.mamba.d_state, cfg.mamba.d_conv
    di = cfg.mamba.expand * cfg.d_model
    want_a = torch.log(torch.arange(1, st + 1, dtype=torch.float32))
    assert torch.equal(mix.A_log, want_a.expand(di, st))
    for ones in (mix.dt_b, mix.D, model.blocks[0]["0"].pre_norm.scale):
        assert torch.equal(ones, torch.ones_like(ones))
    assert torch.equal(mix.conv_b, torch.zeros_like(mix.conv_b))
    assert not hasattr(model.blocks[0]["0"], "ffn")
    for w, fan_in in ((mix.conv_w, dc), (mix.in_proj, cfg.d_model),
                      (mix.x_proj, di), (mix.out_proj, di)):
        std = float(w.std()) * fan_in ** 0.5
        assert 0.8 < std < 1.2, (w.shape, std)


def test_mamba_cache_from_numpy_checks_shapes(pair):
    _, _, cfg, _ = pair(MAMBA)
    di = cfg.mamba.expand * cfg.d_model
    st, dc = cfg.mamba.d_state, cfg.mamba.d_conv
    good = {"0": {"h": np.zeros((2, 1, di, st), np.float32),
                  "conv": np.zeros((2, 1, dc - 1, di), np.float32)}}
    out = convert.cache_from_numpy(cfg, good, device="cpu")
    assert out["0"]["h"].shape == (2, 1, di, st)
    bad = {"0": {"h": good["0"]["h"], "conv": np.zeros((2, 1, dc, di))}}
    with pytest.raises(ValueError, match="cache"):
        convert.cache_from_numpy(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="no leaf"):
        convert.cache_from_numpy(cfg, {"0": {"k": good["0"]["h"],
                                             "v": good["0"]["h"]}},
                                 device="cpu")


def test_remat_policy_raises(pair):
    """Every reference policy is ported (tests/test_torch_train.py holds
    each bit for bit to "none"); a name that is none of them raises."""
    _, _, cfg, model = pair("smollm-360m")
    toks = torch.as_tensor(_tokens(cfg, 1, 4))
    with pytest.raises(ValueError, match="remat_policy"):
        models.forward(model, {"tokens": toks}, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        models.prefill(model, {"tokens": toks}, remat_policy="dots")
    want = models.forward(model, {"tokens": toks})
    for policy in ("full", "dots_saveable"):
        assert torch.equal(models.forward(model, {"tokens": toks},
                                          remat_policy=policy), want)
