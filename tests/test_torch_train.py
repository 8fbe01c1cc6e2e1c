"""The port's training path against the live JAX reference on the CPU.

``models.loss_fn`` (loss, metrics, and ``make_eval_step``'s) and its
gradients leaf by leaf
(through ``convert.tree_to_numpy``) against ``jax.value_and_grad`` of
``repro.models.loss_fn``, at the smoke configs of smollm, gemma2,
falcon-mamba, qwen3-moe (and under the "topk" router, with its aux
loss), jamba, musicgen and llava, float32 activations; one
``make_train_step`` step against the jitted reference step at each
config, each under one of (adamw, adamw8bit) x (float32, bfloat16)
activations, every combination covered (in float32 the reference's
jitted clip and AdamW on its jitted gradients, the step's own parts); every remat policy bit for bit
"none"; the dispatch's gradient against ``jax.grad`` of the reference's
``midas_dispatch``; the kernel wrappers' refusal under autograd.

Tolerances (|diff| against the reference's value, per field):
- loss and ``ce``: 2e-6 relative; the MoE rates and ``moe_load_cv``
  2e-6 absolute; the gradient leaves 2e-5 of the leaf's largest |g|
  (both sum in float32, in other orders);
- a train step in float32: loss 2e-6 relative, grad_norm 1e-5
  relative, m and v 1e-4 of their leaf's largest value, int8 payloads
  within 1 with at most 1% differing, scales 1e-4 relative; params
  within 2.1 lr (Adam's first step moves a weight by about lr times the
  sign of its gradient, plus the decay, and a gradient near 0 may take
  either sign),
  at most 1% of them off by more than 1e-6;
- in bfloat16 activations the same fields at 2e-2 (loss, grad_norm) and
  10% of the leaf's largest value (m, v, scales, the dequantized 8-bit
  moments), params within 2.1 lr with at most 10% off by more than 1e-6
  (bfloat16 rounds at other places in XLA and PyTorch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models as jmodels  # noqa: E402
from repro.config import RunConfig as JRun  # noqa: E402
from repro.config import get_smoke_arch as jarch  # noqa: E402
from repro.kernels.midas_route import ref as jroute  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch import convert, models  # noqa: E402
from repro_torch.config import RunConfig, get_smoke_arch  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.kernels.midas_route import kernel as mr_kernel  # noqa
from repro_torch.kernels.midas_route import ops as mr_ops  # noqa: E402
from repro_torch.kernels.midas_route import ref as mr_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as cs_kernel  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as cs_ops  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.utils import tree_flatten_with_names  # noqa: E402

B, S = 2, 32
ARCHS = ["smollm-360m", "gemma2-2b", "falcon-mamba-7b",
         "qwen3-moe-235b-a22b", "jamba-v0.1-52b", "musicgen-large",
         "llava-next-mistral-7b"]
TOPK = "qwen3-moe-235b-a22b/topk"
# (optimizer, activation dtype) of each config's train step
# (the MoE configs in float32: in bfloat16 two gate logits tie often, and
# a tie broken the other way sends a token to another expert)
STEPS = {
    "smollm-360m": ("adamw", "float32"),
    "gemma2-2b": ("adamw8bit", "float32"),
    "falcon-mamba-7b": ("adamw", "bfloat16"),
    "qwen3-moe-235b-a22b": ("adamw8bit", "float32"),
    "jamba-v0.1-52b": ("adamw", "float32"),
    "musicgen-large": ("adamw", "bfloat16"),
    "llava-next-mistral-7b": ("adamw8bit", "bfloat16"),
}


def _configs(name):
    arch, _, router = name.partition("/")
    jc, tc = jarch(arch), get_smoke_arch(arch)
    if router:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                             router=router))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                             router=router))
    return jc, tc


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.normal(0, 0.02, (B, S, cfg.d_model)
                                     ).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S)
                                       ).astype(np.int32)}
    if cfg.frontend == "vlm_patches":
        P = cfg.frontend_tokens
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S - P)
                                       ).astype(np.int32),
                "patches": rng.normal(0, 0.02, (B, P, cfg.d_model)
                                      ).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                   ).astype(np.int32)}


@pytest.fixture(scope="module")
def reference():
    """Per config, made once on demand: the params (the port's random
    weights as the reference's tree), the batch, the reference's MoE
    state and the jitted ``jax.value_and_grad`` of its ``loss_fn``
    (float32 activations)."""
    cache = {}

    def get(name):
        if name not in cache:
            jc, tc = _configs(name)
            # the port's random weights, given to both (the reference's
            # init is slow to trace)
            params = convert.params_to_numpy(
                models.init_params(tc, 0, device="cpu"))
            batch = _batch(jc)
            moe = jmodels.init_moe_state(jc)
            fn = jax.jit(jax.value_and_grad(
                lambda p: jmodels.loss_fn(p, jc, batch, moe), has_aux=True))
            (loss, (new_moe, metrics)), grads = fn(params)
            cache[name] = dict(
                jc=jc, tc=tc, params=params, batch=batch,
                moe=jax.device_get(moe), loss=float(loss),
                new_moe=jax.device_get(new_moe),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=dict(tree_flatten_with_names(jax.device_get(grads))))
        return cache[name]

    return get


def _port_inputs(ref):
    params = convert.tree_from_numpy(ref["params"], "cpu")
    batch = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    moe = (convert.moe_state_from_numpy(ref["tc"], ref["moe"], device="cpu")
           if ref["moe"] else {})
    return params, batch, moe


def _close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() if got.size else 0.0
    assert got.shape == want.shape, what
    assert err <= atol, f"{what}: max |diff| {err:.3g} > {atol:.3g}"


@pytest.mark.parametrize("name", ARCHS + [TOPK])
def test_loss_and_gradients_match_reference(name, reference):
    ref = reference(name)
    params, batch, moe = _port_inputs(ref)
    run = RunConfig(activation_dtype="float32", remat_policy="none")
    (loss, (new_moe, metrics)), grads = tstep.value_and_grad(
        ref["tc"], run, params, moe, batch)
    _close(loss.item(), ref["loss"], 2e-6 * abs(ref["loss"]), "loss")
    assert sorted(metrics) == sorted(ref["metrics"])
    for k, want in ref["metrics"].items():
        tol = 2e-6 * abs(want) if k in ("ce", "aux_loss") else 2e-6
        _close(metrics[k].item(), want, tol, k)
    if name == TOPK:
        assert "aux_loss" in metrics
        _close(loss.item(), ref["metrics"]["ce"]
               + 0.01 * ref["metrics"]["aux_loss"], 1e-5, "ce + aux")
    for pos, want in ref["new_moe"].items():
        _close(new_moe[pos].numpy(), want, 1e-6, f"new_moe[{pos}]")
    evaluated = tstep.make_eval_step(ref["tc"], run)(params, moe, batch)
    _close(evaluated["ce"].item(), ref["metrics"]["ce"],
           2e-6 * abs(ref["metrics"]["ce"]), "eval_step ce")
    got = dict(tree_flatten_with_names(convert.tree_to_numpy(grads)))
    assert sorted(got) == sorted(ref["grads"])
    for leaf, want in ref["grads"].items():
        scale = float(np.abs(want).max())
        _close(got[leaf], want, 2e-5 * scale + 1e-12, f"grad {leaf}")


def _assert_state_close(got, want, dtype, lr, what):
    """Port TrainState against the reference's (numpy), per the
    module's tolerances."""
    f32 = dtype == "float32"
    rel = 1e-4 if f32 else 1e-1
    frac = 0.01 if f32 else 0.10
    g = dict(tree_flatten_with_names(convert.tree_to_numpy(got)))
    w = dict(tree_flatten_with_names(want))
    assert sorted(g) == sorted(w), what
    for name, wv in w.items():
        gv = g[name]
        assert gv.shape == wv.shape and gv.dtype == wv.dtype, name
        if name.startswith(".params"):
            d = np.abs(gv.astype(np.float64) - wv)
            assert d.max() <= 2.1 * lr, f"{what} {name}: {d.max():.3g}"
            assert (d > 1e-6).mean() <= frac, f"{what} {name}"
        elif wv.dtype == np.int8 and f32:
            d = np.abs(gv.astype(np.int32) - wv)
            assert d.max() <= 1, f"{what} {name}: payload off by {d.max()}"
            assert (d > 0).mean() <= frac, f"{what} {name}"
        elif wv.dtype == np.int8:  # the dequantized moment
            sc = name.replace("/.m/", "/.m_scale/").replace("/.v/",
                                                            "/.v_scale/")
            dq = gv.astype(np.float64) * g[sc]
            dw = wv.astype(np.float64) * w[sc]
            _close(dq, dw, rel * float(np.abs(dw).max()) + 1e-30,
                   f"{what} {name} dequantized")
        elif name == ".step" or name.startswith(".moe_state"):
            _close(gv, wv, 1e-6, f"{what} {name}")
        else:
            scale = float(np.abs(wv).max())
            _close(gv, wv, rel * scale + 1e-30, f"{what} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, reference):
    ref = reference(arch)
    optimizer, dtype = STEPS[arch]
    jrun = JRun(optimizer=optimizer, activation_dtype=dtype,
                remat_policy="none")
    run = RunConfig(optimizer=optimizer, activation_dtype=dtype,
                    remat_policy="none")
    eight = optimizer == "adamw8bit"
    jst = jstep.TrainState(
        params=ref["params"],
        opt=jax.device_get(jax.jit(
            lambda p: jopt.init_adam_state(p, eight_bit=eight))(
                ref["params"])),
        moe_state=ref["moe"], step=np.zeros((), np.int32))
    if dtype == "float32":
        # make_train_step's composition, its loss and gradients those of
        # the module fixture's jitted value_and_grad (the same function
        # in float32), saving a second compile of the model
        def opt_step(st, grads):
            grads, gnorm = jopt.clip_by_global_norm(grads, jrun.grad_clip)
            p, o = jopt.adamw_update(
                st.params, grads, st.opt, st.step, lr=jrun.learning_rate,
                beta1=jrun.beta1, beta2=jrun.beta2,
                weight_decay=jrun.weight_decay, eight_bit=eight)
            return jstep.TrainState(p, o, ref["new_moe"], st.step + 1), gnorm

        grads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(ref["params"]),
            [ref["grads"][n] for n, _ in
             tree_flatten_with_names(ref["params"])])
        new_j, gnorm = jax.jit(opt_step)(jst, grads)
        met_j = {"loss": ref["loss"], "grad_norm": gnorm}
    else:
        new_j, met_j = jax.jit(jstep.make_train_step(ref["jc"], jrun))(
            jst, ref["batch"])
    new_j, met_j = jax.device_get((new_j, met_j))

    params, batch, moe = _port_inputs(ref)
    st = tstep.TrainState(
        params=params, opt=convert.adam_state_from_numpy(jst.opt, "cpu"),
        moe_state=moe, step=torch.zeros((), dtype=torch.int32))
    new_t, met_t = tstep.make_train_step(ref["tc"], run)(st, batch)
    tol = 2e-6 if dtype == "float32" else 2e-2
    _close(met_t["loss"].item(), float(met_j["loss"]),
           tol * abs(float(met_j["loss"])), "loss")
    gtol = 1e-5 if dtype == "float32" else 2e-2
    _close(met_t["grad_norm"].item(), float(met_j["grad_norm"]),
           gtol * float(met_j["grad_norm"]), "grad_norm")
    _assert_state_close(new_t, new_j, dtype, run.learning_rate,
                        f"{arch} {optimizer} {dtype}")


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "qwen3-moe-235b-a22b",
                                  "musicgen-large"])
def test_remat_policies_are_bitwise_none(arch, reference):
    """Every policy changes no number: the loss and every gradient leaf
    equal "none"'s bit for bit, in bfloat16 activations too (a Mamba, an
    MoE with attention, and a plain-GELU audio model; jamba's eight
    layers a block cost several times these under a loaded CPU)."""
    ref = reference(arch)
    params, batch, moe = _port_inputs(ref)
    out = {}
    for policy in models.model.REMAT_POLICIES:
        run = RunConfig(remat_policy=policy)
        (loss, (new_moe, _)), grads = tstep.value_and_grad(
            ref["tc"], run, params, moe, batch)
        out[policy] = (loss, new_moe, tree_flatten_with_names(grads))
    loss0, moe0, g0 = out["none"]
    for policy, (loss, new_moe, g) in out.items():
        assert torch.equal(loss, loss0), policy
        assert all(torch.equal(new_moe[k], moe0[k]) for k in moe0), policy
        assert all(n == m and torch.equal(a, b)
                   for (n, a), (m, b) in zip(g, g0)), policy


@pytest.mark.parametrize("f_max", [1.0, 0.25])
def test_dispatch_gradient_matches_reference(f_max, monkeypatch):
    """d(sum(weights * w)) / d(gate_logits) of the port's dispatch, by
    autograd through the plain path and through the kernel path's
    autograd function (the kernels replaced by their plain versions on
    the CPU), against ``jax.grad`` of the reference's dispatch."""
    rng = np.random.default_rng(7)
    T, E, k, d = 64, 16, 2, 2
    logits = rng.normal(size=(T, E)).astype(np.float32)
    load = rng.uniform(0.2, 4.0, E).astype(np.float32)
    w = rng.normal(size=(T, k)).astype(np.float32)

    def jloss(x):
        _, wts, _ = jroute.midas_dispatch(x, load, k, d, f_max=f_max)
        return jnp.sum(wts * w)

    want = np.asarray(jax.grad(jloss)(logits))  # the ref is not jittable

    def port_grad():
        x = torch.tensor(logits, requires_grad=True)
        _, wts, _ = mr_ops.midas_dispatch(
            x, torch.as_tensor(load), k, d, f_max=f_max,
            impl="ref" if not patched else "cuda")
        (wts * torch.as_tensor(w)).sum().backward()
        return x.grad.numpy()

    patched = False
    plain = port_grad()
    np.testing.assert_allclose(plain, want, rtol=1e-6, atol=1e-7)
    # the kernel path's autograd function around the plain passes
    monkeypatch.setattr(mr_ops, "resolve_impl", lambda impl, dev: "cuda")
    monkeypatch.setattr(mr_kernel, "dispatch_fused",
                        lambda lg, ld, k_, d_, **kw: mr_ref.midas_dispatch(
                            lg, ld, k_, d_, f_max=1.0, **kw))
    monkeypatch.setattr(mr_kernel, "dispatch_candidates",
                        mr_ref.top_candidates)
    monkeypatch.setattr(mr_kernel, "dispatch_steer",
                        mr_ref.steer_from_candidates)
    patched = True
    np.testing.assert_allclose(port_grad(), want, rtol=1e-6, atol=1e-7)


def test_kernel_wrappers_refuse_or_differentiate_under_autograd():
    """Under autograd no kernel wrapper returns a tensor without a
    gradient path: chunk_scan and decode_attention raise
    NotImplementedError naming their ROADMAP queue (before any device
    check, so on CPU tensors too); the dispatch kernels point at
    ``ops.midas_dispatch``; flash_attention goes through its autograd
    function (whose forward then wants the card).  Without gradients
    the same calls reach the device checks."""
    x = torch.zeros((1, 4, 8), requires_grad=True)
    h0 = torch.zeros((1, 8, 2))
    A = torch.zeros((8, 2))
    Bm = torch.zeros((1, 4, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP §2.*chunk_scan"):
        cs_kernel.chunk_scan(h0, x, x, A, Bm, Bm)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        cs_kernel.chunk_scan(h0, x, x, A, Bm, Bm)
    q = torch.zeros((1, 4, 8), requires_grad=True)
    kc = torch.zeros((1, 16, 2, 8))
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="decoding only.*ROADMAP"):
        da_kernel.decode_attention(q, kc, kc, pos)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        da_kernel.decode_attention(q, kc, kc, pos)
    logits = torch.zeros((4, 16), requires_grad=True)
    with pytest.raises(NotImplementedError, match="ops.midas_dispatch"):
        mr_kernel.dispatch_fused(logits, torch.ones(16), 2, 2)
    with pytest.raises(NotImplementedError, match="ops.midas_dispatch"):
        mr_kernel.dispatch_candidates(logits, 4)
    with pytest.raises(NotImplementedError, match="ops.midas_dispatch"):
        mr_kernel.dispatch_steer(torch.zeros((4, 4), dtype=torch.int32),
                                 logits[:, :4], torch.ones(16), 2)
    qa = torch.zeros((1, 8, 4, 16), requires_grad=True)
    ka = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(qa, ka, ka)
    # the plain path differentiates on the CPU
    y, _ = cs_ops.selective_scan(x, x.detach().abs() + 0.1, -torch.ones(8, 2),
                                 Bm, Bm, torch.ones(8))
    y.sum().backward()
    assert x.grad is not None


def test_train_state_round_trips_through_numpy():
    """``convert``'s training-state pairs invert each other: params (from
    a model, blocks stacked), both AdamState kinds and the MoE state."""
    cfg = get_smoke_arch("jamba-v0.1-52b")
    model = models.init_params(cfg, 3, device="cpu")
    tree = convert.params_to_numpy(model)
    back = convert.params_from_numpy(cfg, tree, device="cpu")
    for (n, a), (m, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert n == m and torch.equal(a, b)
    params = convert.tree_from_numpy(tree, "cpu")
    for eight in (False, True):
        state = topt.init_adam_state(params, eight_bit=eight)
        again = convert.adam_state_from_numpy(
            convert.adam_state_to_numpy(state), "cpu")
        assert (again.m_scale is None) == (not eight)
        for a, b in zip(tree_flatten_with_names(state),
                        tree_flatten_with_names(again)):
            assert a[0] == b[0] and torch.equal(a[1], b[1])
    moe = models.init_moe_state(cfg, "cpu")
    again = convert.moe_state_from_numpy(
        cfg, convert.moe_state_to_numpy(moe), device="cpu")
    assert all(torch.equal(moe[k], again[k]) for k in moe)
