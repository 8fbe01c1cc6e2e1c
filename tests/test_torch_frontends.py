"""The audio and vision frontends (MusicGen, LLaVA-NeXT) against the JAX
reference on the CPU, at both smoke configs, with the reference's
weights converted by ``convert.params_from_numpy``.

The oracle is the reference's model level (``models.forward``,
``prefill`` and ``decode_step`` with ``frames`` or ``patches`` and a
cache long enough for them), not its launcher, which builds no frames
for MusicGen and too short a cache for LLaVA's patches.  Tolerances are
tests/test_torch_models.py's: logits and float32 cache leaves within
1e-4 (relative and absolute); greedy tokens equal.  The sinusoidal
positions go through ``sin``, ``cos`` and ``pow``, whose last bit the
two libraries may round differently: within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.config import get_smoke_arch as jget_smoke_arch  # noqa: E402
from repro.models import stubs as jstubs  # noqa: E402
from repro_torch import convert, models  # noqa: E402
from repro_torch.config import RunConfig, get_smoke_arch  # noqa: E402
from repro_torch.launch import serve as serving  # noqa: E402
from repro_torch.models import stubs  # noqa: E402

ARCHS = ["musicgen-large", "llava-next-mistral-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)
S, DECODE = 10, 3


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


def _batch(cfg, B, seed=1):
    """numpy inputs: frames (audio) or patches and tokens (vision)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "patches": rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)}


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("S_,d", [(7, 16), (33, 64), (3, 5)])
def test_sinusoidal_positions(S_, d):
    if d % 2:  # the reference's cos slice does not fit an odd d
        with pytest.raises(ValueError):
            jstubs.sinusoidal_positions(S_, d)
        with pytest.raises(ValueError, match="broadcasting"):
            stubs.sinusoidal_positions(S_, d)
        return
    want = np.asarray(jstubs.sinusoidal_positions(S_, d))
    got = stubs.sinusoidal_positions(S_, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (S_, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(pair, arch):
    jcfg, params, cfg, model = pair(arch)
    batch = _batch(cfg, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    want, _, _ = jmodels.forward(params, jcfg, jb)
    got = models.forward(model, tb)
    n = S + (cfg.frontend_tokens if cfg.frontend == "vlm_patches" else 0)
    assert tuple(got.shape) == (2, n, cfg.vocab_size) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    L = n + DECODE
    want_lg, want_c = jmodels.prefill(params, jcfg, jb, cache_len=L,
                                      cache_dtype=jnp.float32)
    got_lg, got_c = models.prefill(model, tb, cache_len=L,
                                   cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(got_lg), _np(want_lg), **TOL)
    assert sorted(got_c) == sorted(want_c)
    for pos in want_c:
        for name in ("k", "v"):
            g, w = got_c[pos][name], want_c[pos][name]
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(_np(g), _np(w), **TOL,
                                       err_msg=f"cache[{pos}][{name}]")
    # greedy decoding after the prefix and the prompt: equal tokens
    jtok = jnp.argmax(want_lg[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(got_lg[:, -1], -1)[:, None].to(torch.int32)
    for t in range(DECODE):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        pos = np.full((2,), n + t, np.int32)
        jl, want_c = jmodels.decode_step(params, jcfg, want_c, jtok,
                                         jnp.asarray(pos))
        tl, got_c = models.decode_step(model, got_c, ttok,
                                       torch.as_tensor(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL,
                                   err_msg=f"{arch} step {t}")
        jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_both_frontends(pair, arch):
    """``serve()`` on the CPU: the first request's greedy tokens are the
    reference model's on the same host-drawn inputs, with the decode
    positions after the patches."""
    jcfg, params, cfg, model = pair(arch)
    kw = dict(requests=2, prompt_len=6, decode_len=DECODE, replicas=4)
    res = serving.serve(cfg, RunConfig(arch=arch), seed=0, device="cpu",
                        model=model, **kw)
    assert res.tokens.shape == (2, DECODE + 1)
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
    assert res.stats.routed == 2 and res.device == "cpu"
    rng = np.random.default_rng(0)
    rng.zipf(1.4)
    batch = serving.request_inputs(cfg, rng, kw["prompt_len"])
    start = serving.prefix_len(cfg) + kw["prompt_len"]
    assert start == kw["prompt_len"] + (cfg.frontend_tokens if arch ==
                                        "llava-next-mistral-7b" else 0)
    lg, cache = jmodels.prefill(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        cache_len=start + DECODE)
    cache = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), cache)
    tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    want = [int(tok[0, 0])]
    for t in range(DECODE):
        lg, cache = jmodels.decode_step(params, jcfg, cache, tok,
                                        jnp.asarray([start + t], jnp.int32))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        want.append(int(tok[0, 0]))
    np.testing.assert_array_equal(res.tokens[0], want)


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-large"])
def test_serve_midas_example_runs_on_the_cpu(arch, capsys):
    """``examples_torch/serve_midas.py --device cpu`` at a smoke config:
    every request routed, the router's decisions the reference
    router's on the same sessions."""
    import importlib.util
    from pathlib import Path

    from repro.serve import MidasRouter as JRouter

    path = Path(__file__).resolve().parents[1] / "examples_torch" / \
        "serve_midas.py"
    spec = importlib.util.spec_from_file_location("serve_midas", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    stats = example.main(["--arch", arch, "--device", "cpu", "--requests",
                          "24", "--decode-len", "3"])
    assert "routed=24" in capsys.readouterr().out
    rng, router, now = np.random.default_rng(0), JRouter(
        replicas=8, d=3, f_max=0.25), 0.0
    for _ in range(24):
        session = int(rng.zipf(1.4)) % 16
        replica, _, _ = router.route(session, now, prefix_hash=session % 4)
        router.complete(replica)
        now += 50.0
        router.ingest_telemetry()
    assert tuple(stats) == tuple(router.stats())


def test_serve_midas_example_imports_neither_jax_nor_repro():
    import ast
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples_torch" / \
        "serve_midas.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}
