"""Serving step functions (prefill + greedy decode): the counterparts of
``repro/serve/step.py``."""

from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.config import ArchConfig, RunConfig


def _check_model(model: models.Model, cfg: ArchConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the model is {model.cfg.name}, the step was "
                         f"made for {cfg.name}")


def make_prefill_step(cfg: ArchConfig, run: RunConfig,
                      cache_len: int | None = None, *,
                      impl: str = "auto"):
    """``prefill_step(model, batch) -> (logits, cache)``, the K/V (or a
    Mamba layer's conv tail) in ``run.decode_kv_dtype``."""
    cache_dtype = getattr(torch, run.decode_kv_dtype)

    def prefill_step(model, batch):
        _check_model(model, cfg)
        return models.prefill(model, batch, cache_len=cache_len,
                              cache_dtype=cache_dtype, impl=impl)

    return prefill_step


def make_serve_step(cfg: ArchConfig, run: RunConfig, *,
                    impl: str = "auto"):
    """``serve_step(model, cache, tokens, pos) -> (next_token, cache)``:
    one greedy decode step (first index on ties, as ``jnp.argmax``)."""

    def serve_step(model, cache, tokens, pos):
        _check_model(model, cfg)
        logits, new_cache = models.decode_step(model, cache, tokens, pos,
                                               impl=impl)
        next_token = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_token.to(torch.int32), new_cache

    return serve_step
