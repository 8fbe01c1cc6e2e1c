"""The port's serving path against the JAX reference on the CPU.

``MidasRouter`` must decide exactly as the reference's on the same
request stream.  The whole ``serve()`` loop runs at the smoke config
with the reference's weights converted; the reference launcher's loop
is replayed here with ``make_prefill_step`` and ``decode_step``, fed
the port's tokens (teacher forcing), and the port's greedy token must
be the reference's wherever the reference's top-2 logit margin exceeds
twice the logit tolerance of tests/test_torch_models.py (1e-4 relative
and absolute).  That covers the MoE smoke configs and jamba's hybrid,
whose routing can swap an expert on a last-bit difference of a gate
logit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.config import RunConfig as JRunConfig  # noqa: E402
from repro.config import get_smoke_arch as jget_smoke_arch  # noqa: E402
from repro.serve import MidasRouter as JRouter  # noqa: E402
from repro.serve.step import make_prefill_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import RunConfig, get_smoke_arch  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.serve import MidasRouter  # noqa: E402

ROUTER_KW = [
    dict(replicas=4, d=3, f_max=0.25),  # the launcher's router
    dict(replicas=7, d=2, delta_l=1.0, f_max=0.5, pin_ms=120.0),
    dict(replicas=5, policy="round_robin", prefix_cache=False),
    dict(replicas=2, d=4, alpha=0.5),
]


@pytest.mark.parametrize("kw", ROUTER_KW, ids=range(len(ROUTER_KW)))
def test_router_decides_as_the_reference(kw):
    rng = np.random.default_rng(11)
    jr, tr = JRouter(**kw), MidasRouter(**kw)
    now = 0.0
    for _ in range(400):
        now += float(rng.exponential(20.0))
        session = int(rng.zipf(1.3)) % 40
        prefix = None if rng.random() < 0.2 else int(rng.integers(0, 12))
        got = tr.route(session, now, prefix_hash=prefix)
        assert got == jr.route(session, now, prefix_hash=prefix)
        if rng.random() < 0.6:
            done = int(rng.integers(0, kw["replicas"]))
            n = int(rng.integers(1, 3))
            jr.complete(done, n)
            tr.complete(done, n)
        if rng.random() < 0.5:
            jr.ingest_telemetry()
            tr.ingest_telemetry()
        if rng.random() < 0.05 and prefix is not None:
            jr.invalidate_prefix(prefix)
            tr.invalidate_prefix(prefix)
    assert tuple(tr.stats()) == tuple(jr.stats())
    assert tr.queue_dispersion() == jr.queue_dispersion()
    if kw.get("policy", "midas") == "midas" and kw["replicas"] > 2:
        assert tr.stats().steered > 0


def _reference_loop(jcfg, params, forced, *, requests, prompt_len,
                    decode_len, replicas, seed=0):
    """The reference launcher's loop (``repro/launch/serve.py:main``),
    fed the port's tokens; returns its routes, stats, dispersion, and
    per position its greedy token and top-2 margin and top logit."""
    run = JRunConfig(arch=jcfg.name)
    prefill = jax.jit(make_prefill_step(jcfg, run,
                                        cache_len=prompt_len + decode_len))
    decode = jax.jit(jmodels.decode_step, static_argnums=1)
    router = JRouter(replicas=replicas, d=3, f_max=0.25)
    rng = np.random.default_rng(seed)
    routes = []
    logits = np.zeros((requests, decode_len + 1, jcfg.vocab_size),
                      np.float32)
    for req in range(requests):
        session = int(rng.zipf(1.4)) % 16
        route = router.route(session, req * 50.0, prefix_hash=session % 4)
        routes.append(route)
        prompt = jnp.asarray(
            rng.integers(0, jcfg.vocab_size, (1, prompt_len)), jnp.int32)
        lg, cache = prefill(params, {"tokens": prompt})
        cache = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16
            else a, cache)
        logits[req, 0] = np.asarray(lg[0, -1], np.float32)
        for t in range(decode_len):
            tok = jnp.asarray(forced[req, t:t + 1][None], jnp.int32)
            pos = jnp.asarray([prompt_len + t], jnp.int32)
            lg, cache = decode(params, jcfg, cache, tok, pos)
            logits[req, t + 1] = np.asarray(lg[0, -1], np.float32)
        router.complete(route[0])
        router.ingest_telemetry()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (routes, router.stats(), router.queue_dispersion(),
            logits.argmax(-1), top2[..., 1] - top2[..., 0], top2[..., 1])


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-2b",
                                  "stablelm-1.6b", "starcoder2-3b",
                                  "falcon-mamba-7b", "qwen3-moe-235b-a22b",
                                  "dbrx-132b", "jamba-v0.1-52b"])
def test_serve_loop_matches_the_reference_launcher(arch):
    kw = dict(requests=8, prompt_len=16, decode_len=8, replicas=4)
    jcfg, cfg = jget_smoke_arch(arch), get_smoke_arch(arch)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_numpy(cfg, jax.device_get(params),
                                      device="cpu")
    res = serve(cfg, RunConfig(arch=arch), seed=0, device="cpu",
                model=model, **kw)
    assert res.tokens.shape == (8, 9)
    routes, stats, disp, greedy, margin, top = _reference_loop(
        jcfg, params, res.tokens, **kw)
    assert res.routes == routes
    assert tuple(res.stats) == tuple(stats)
    assert res.queue_dispersion == disp
    decided = margin > 2 * (1e-4 + 1e-4 * np.abs(top))
    assert decided.mean() > 0.9  # near-ties are rare: the check has teeth
    np.testing.assert_array_equal(res.tokens[decided], greedy[decided])


def test_serve_from_a_seed_is_deterministic():
    cfg = get_smoke_arch("smollm-360m")
    kw = dict(requests=3, prompt_len=5, decode_len=3, replicas=4, seed=2,
              device="cpu")
    a = serve(cfg, RunConfig(), **kw)
    b = serve(cfg, RunConfig(), **kw)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.stats == b.stats and a.stats.routed == 3
    assert a.decode_tokens == 9 and a.device == "cpu"
    assert a.tokens_per_s() > 0 and a.decode_ms_per_token() > 0


def test_serve_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(get_smoke_arch("smollm-360m"), RunConfig(), requests=1,
              prompt_len=2, decode_len=1)
