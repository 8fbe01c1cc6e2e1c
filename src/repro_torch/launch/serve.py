"""Serving launcher: prefill + greedy decode behind the MIDAS router.

The counterpart of ``repro/launch/serve.py``.  :func:`serve` runs its
loop: for each request the router picks a replica, the prompt is
prefilled into a decode cache (the KV cache of a dense model, the SSM
state and conv tail of a Mamba model; rounded to
``run.decode_kv_dtype``, then read back in float32 as the reference
launcher does), ``decode_len`` greedy decode steps follow, and the
request completes.  One model stands for every replica group.  An
audio arch (MusicGen) prefills ``prompt_len`` frame embeddings, a
vision arch (LLaVA-NeXT) its ``frontend_tokens`` patch embeddings
before the prompt (:func:`request_inputs`); both then decode tokens.
``main()`` keeps the reference's CLI and defaults (the smoke config of
``--arch``) and runs on the card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --requests 32 --decode-len 16
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import models
from repro_torch.config import ArchConfig, RunConfig, get_smoke_arch
from repro_torch.kernels.common import resolve_device
from repro_torch.serve import MidasRouter
from repro_torch.serve.router import RouterStats
from repro_torch.serve.step import make_prefill_step, make_serve_step


class ServeResult(NamedTuple):
    tokens: np.ndarray  # (requests, decode_len + 1) int32: each request's
    # greedy token from the prefill, then one per decode step
    routes: List[Tuple[int, bool, bool]]  # (replica, steered, hit) each
    stats: RouterStats
    queue_dispersion: float
    prefill_s: float  # prefill (and the cache's float32 copy), all requests
    decode_s: float  # decode steps, all requests
    wall_s: float  # the whole loop, routing included
    device: str

    @property
    def decode_tokens(self) -> int:
        return self.tokens.shape[0] * (self.tokens.shape[1] - 1)

    def prefill_ms_per_request(self) -> float:
        return 1e3 * self.prefill_s / max(self.tokens.shape[0], 1)

    def decode_ms_per_token(self) -> float:
        return 1e3 * self.decode_s / max(self.decode_tokens, 1)

    def tokens_per_s(self) -> float:
        """Decode tokens per second of the whole loop, as the reference
        launcher reports."""
        return self.decode_tokens / self.wall_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefix_len(cfg: ArchConfig) -> int:
    """Cache rows a request's frontend fills before its prompt: the
    patches of a vision arch, none otherwise."""
    return cfg.frontend_tokens if cfg.frontend == "vlm_patches" else 0


def request_inputs(cfg: ArchConfig, rng: np.random.Generator,
                   prompt_len: int) -> Dict[str, np.ndarray]:
    """One request's prefill inputs, drawn from ``rng`` on the host (so
    the card and the CPU get the same): ``prompt_len`` random tokens
    (1, prompt_len); an audio arch prefills standard-normal frame
    embeddings (1, prompt_len, d_model) in their place, and a vision
    arch prefills standard-normal patch embeddings (1,
    frontend_tokens, d_model) before them, both float32 and drawn after
    the tokens."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, prompt_len))}
    if cfg.frontend == "audio_frames":
        batch = {"frames": rng.standard_normal(
            (1, prompt_len, cfg.d_model), dtype=np.float32)}
    elif cfg.frontend == "vlm_patches":
        batch["patches"] = rng.standard_normal(
            (1, cfg.frontend_tokens, cfg.d_model), dtype=np.float32)
    return batch


def _to_device(batch: Dict[str, np.ndarray], dev: torch.device):
    return {k: torch.as_tensor(v, dtype=torch.int32 if k == "tokens"
                               else torch.float32).to(dev)
            for k, v in batch.items()}


def _to_f32(cache):
    return {pos: {n: a.float() if a.dtype == torch.bfloat16 else a
                  for n, a in c.items()}
            for pos, c in cache.items()}


def serve(
    cfg: ArchConfig,
    run: RunConfig,
    *,
    requests: int = 32,
    prompt_len: int = 16,
    decode_len: int = 16,
    replicas: int = 4,
    seed: int = 0,
    device=None,
    impl: str = "auto",
    model: Optional[models.Model] = None,
) -> ServeResult:
    """Serve ``requests`` requests of ``prompt_len`` random prompt tokens
    (frames for an audio arch, patches and tokens for a vision arch:
    :func:`request_inputs`) and ``decode_len`` greedy decode steps
    each, on ``device`` (the card unless the caller passes
    ``device="cpu"``; without a card this raises).  The cache holds
    ``prefix_len(cfg) + prompt_len + decode_len`` rows, and decoding
    writes after the prefix and the prompt.  ``seed`` seeds the traffic
    (numpy, as the reference launcher's ``default_rng(0)``) and, when
    ``model`` is None, the weights
    (:func:`repro_torch.models.init_params`).  ``impl`` is an
    ``IMPLS`` choice for every kernel of the model path: the attention
    kernels, ``chunk_scan`` of a Mamba layer and the dispatch kernels of
    an MoE layer."""
    dev = resolve_device(device)
    if model is None:
        model = models.init_params(cfg, seed, device=dev)
    elif model.device.type != dev.type or dev.index not in (
            None, model.device.index):
        raise ValueError(f"the model is on {model.device}, not {dev}")
    start = prefix_len(cfg) + prompt_len  # the first decode position
    max_seq = start + decode_len
    prefill = make_prefill_step(cfg, run, cache_len=max_seq, impl=impl)
    decode = make_serve_step(cfg, run, impl=impl)
    router = MidasRouter(replicas=replicas, d=3, f_max=0.25)
    positions = torch.arange(start, max_seq, dtype=torch.int32,
                             device=dev)
    out = torch.zeros((requests, decode_len + 1), dtype=torch.int32,
                      device=dev)
    routes = []
    prefill_s = decode_s = 0.0

    rng = np.random.default_rng(seed)
    _sync(dev)
    t0 = time.perf_counter()
    for req in range(requests):
        session = int(rng.zipf(1.4)) % 16
        replica, steered, hit = router.route(session, req * 50.0,
                                             prefix_hash=session % 4)
        routes.append((replica, steered, hit))
        batch = _to_device(request_inputs(cfg, rng, prompt_len), dev)
        t1 = time.perf_counter()
        logits, cache = prefill(model, batch)
        cache = _to_f32(cache)
        tok = torch.argmax(logits[:, -1].float(), dim=-1)[:, None]
        tok = tok.to(torch.int32)
        out[req, 0] = tok[0, 0]
        _sync(dev)
        t2 = time.perf_counter()
        for t in range(decode_len):
            nxt, cache = decode(model, cache, tok, positions[t:t + 1])
            tok = nxt[:, None]
            out[req, t + 1] = nxt[0]
        _sync(dev)
        t3 = time.perf_counter()
        prefill_s += t2 - t1
        decode_s += t3 - t2
        router.complete(replica)
        router.ingest_telemetry()
    wall_s = time.perf_counter() - t0
    return ServeResult(
        tokens=out.cpu().numpy(),
        routes=routes,
        stats=router.stats(),
        queue_dispersion=router.queue_dispersion(),
        prefill_s=prefill_s,
        decode_s=decode_s,
        wall_s=wall_s,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-len", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=4)
    args = ap.parse_args()

    res = serve(get_smoke_arch(args.arch), RunConfig(arch=args.arch),
                requests=args.requests, prompt_len=args.prompt_len,
                decode_len=args.decode_len, replicas=args.replicas)
    s = res.stats
    print(f"served {args.requests} requests, {res.decode_tokens} tokens in "
          f"{res.wall_s:.1f}s ({res.tokens_per_s():.1f} tok/s on "
          f"{res.device})")
    print(f"router: steered={s.steered} prefix_hits={s.cache_hits} "
          f"queue_cv={res.queue_dispersion:.3f}")


if __name__ == "__main__":
    main()
