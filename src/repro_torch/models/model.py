"""Architecture builder for the dense attention families.

The counterpart of ``repro/models/model.py``.  A model is a stack of
``num_blocks`` identical blocks; a block is a short pattern of layers
(``[attn]``, or gemma2's ``[attn-local, attn-global]``).  The reference
scans the stacked blocks with ``lax.scan``; here they are an
``nn.ModuleList`` walked in order, and the KV cache keeps the
reference's stacked layout (``{pos: {"k", "v"}}`` of shape
(num_blocks, B, S_max, KV, hd)), so block ``b`` reads and writes the
view ``cache[pos]["k"][b]``.

This slice builds dense, attention-only configs, with or without a
sliding window, softcap or alternating local/global layers.  MoE and
Mamba layers, the audio and vision frontends and rematerialisation
raise ``NotImplementedError`` naming their ROADMAP item.  There is no
loss and no backward yet: the functions here run without autograd.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L


class LayerSpec(NamedTuple):
    kind: str  # "attn" | "mamba"
    is_moe: bool
    is_local: bool


def block_pattern(cfg: ArchConfig) -> List[LayerSpec]:
    if cfg.family == "ssm":
        return [LayerSpec("mamba", False, False)]
    if cfg.family == "hybrid":
        out = []
        for i in range(cfg.attn_every):
            kind, is_moe = cfg.layer_kind(i)
            out.append(LayerSpec(kind, is_moe, False))
        return out
    if cfg.alt_local_global:
        return [LayerSpec("attn", cfg.moe is not None, True),
                LayerSpec("attn", cfg.moe is not None, False)]
    return [LayerSpec("attn", cfg.moe is not None, cfg.window_size > 0)]


def num_blocks(cfg: ArchConfig) -> int:
    pat = block_pattern(cfg)
    if cfg.num_layers % len(pat):
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                         f"split into blocks of {len(pat)}")
    return cfg.num_layers // len(pat)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not
    port."""
    for spec in block_pattern(cfg):
        if spec.kind == "mamba":
            raise NotImplementedError(
                f"{cfg.name}: Mamba layers are not ported yet "
                f"(ROADMAP §1 item 10)"
            )
        if spec.is_moe:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not ported yet "
                f"(ROADMAP §1 item 11)"
            )
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            f"(ROADMAP §1 item 8)"
        )


def _check_remat(remat_policy: str) -> None:
    if remat_policy != "none":
        raise NotImplementedError(
            f"remat_policy={remat_policy!r} is not ported yet; it comes "
            f"with training (ROADMAP §1 item 18)"
        )


class Layer(nn.Module):
    """Pre-norm attention and MLP with residuals (``_layer_apply``)."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.spec = spec
        self.pre_norm = L.Norm(cfg.d_model, cfg.norm, **kw)
        self.mixer = L.Attention(cfg, **kw)
        self.post_norm = L.Norm(cfg.d_model, cfg.norm, **kw)
        self.ffn = L.MLP(cfg, **kw)

    def forward(self, x: torch.Tensor, *, impl: str = "auto",
                return_kv: bool = False):
        out = self.mixer(self.pre_norm(x), is_local=self.spec.is_local,
                         impl=impl, return_kv=return_kv)
        mix, kv = out if return_kv else (out, None)
        x = x + mix
        x = x + self.ffn(self.post_norm(x))
        return (x, kv) if return_kv else x

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: torch.Tensor, *,
               impl: str = "auto") -> torch.Tensor:
        x = x + self.mixer.decode(self.pre_norm(x), cache_k, cache_v, pos,
                                  is_local=self.spec.is_local, impl=impl)
        return x + self.ffn(self.post_norm(x))


class Model(nn.Module):
    """Embedding, ``num_blocks`` blocks of ``block_pattern`` layers, the
    final norm and the LM head.  Parameter names mirror the reference's
    tree: ``blocks.<b>.<pos>.mixer.wq`` is ``params["blocks"][pos]
    ["mixer"]["wq"][b]``.  Weights are uninitialised: use
    :func:`init_params` or ``convert.params_from_numpy``."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.cfg = cfg
        self.pattern = block_pattern(cfg)
        self.embed = L.Embed(cfg, **kw)
        self.final_norm = L.Norm(cfg.d_model, cfg.norm, **kw)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({str(i): Layer(cfg, spec, **kw)
                           for i, spec in enumerate(self.pattern)})
            for _ in range(num_blocks(cfg))
        )

    @property
    def device(self) -> torch.device:
        return self.embed.tokens.device


_ZEROS = ("bias", "bq", "bk", "bv", "b1", "b2")


def init_params(cfg: ArchConfig, seed: int = 0, *, dtype=torch.float32,
                device=None) -> Model:
    """A model with random weights on ``device`` (the card when None).

    The reference's rules: norm scales are ones, biases zeros, and every
    other weight is normal / sqrt(fan_in), with fan_in the input width
    (H·hd for ``wo``, 1 for the embedding table).  The draws come from a
    CPU ``torch.Generator`` seeded with ``seed``, so a seed gives the
    same weights on every device (not the reference's: its threefry
    draws differ; parity tests convert the reference's weights with
    ``convert.params_from_numpy``)."""
    model = Model(cfg, device=device, dtype=dtype)
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf in _ZEROS:
                p.zero_()
            else:
                if leaf == "tokens":
                    fan_in = 1
                elif leaf == "wo":
                    fan_in = p.shape[0] * p.shape[1]
                else:
                    fan_in = p.shape[0]
                w = torch.randn(p.shape, generator=gen) * (
                    1.0 / fan_in ** 0.5)
                p.copy_(w.to(dtype))
    return model


# ---------------------------------------------------------------------------
# Forward (logits of a whole sequence)
# ---------------------------------------------------------------------------


@torch.no_grad()
def forward(model: Model, batch: Dict[str, torch.Tensor], *,
            impl: str = "auto", remat_policy: str = "none") -> torch.Tensor:
    """Full-sequence forward: logits (B, S, V) for ``batch["tokens"]``
    (B, S).  ``impl`` picks the attention implementation (an ``IMPLS``
    choice)."""
    _check_remat(remat_policy)
    x = model.embed(batch["tokens"])
    for block in model.blocks:
        for i in range(len(model.pattern)):
            x = block[str(i)](x, impl=impl)
    x = model.final_norm(x)
    return model.embed.logits(x)


# ---------------------------------------------------------------------------
# Prefill (forward + cache collection, logits for the last position only)
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zeroed stacked KV caches, one ``{"k", "v"}`` pair of shape
    (num_blocks, batch, max_seq, KV, hd) per block position, on
    ``device`` (the card when None)."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (num_blocks(cfg), batch, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {
        str(i): {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
        for i in range(len(block_pattern(cfg)))
    }


@torch.no_grad()
def prefill(model: Model, batch: Dict[str, torch.Tensor],
            cache_len: Optional[int] = None, cache_dtype=torch.bfloat16,
            *, impl: str = "auto", remat_policy: str = "none"):
    """Serving prefill: run the prompt, return the last position's
    logits (B, 1, V) and a decode-ready cache padded with zeros to
    ``cache_len`` rows, its K/V rounded to ``cache_dtype``."""
    _check_remat(remat_policy)
    cfg = model.cfg
    x = model.embed(batch["tokens"])
    B, S = x.shape[:2]
    cache_len = cache_len or S
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    cache = init_decode_cache(cfg, B, cache_len, cache_dtype, x.device)
    for b, block in enumerate(model.blocks):
        for i in range(len(model.pattern)):
            x, kv = block[str(i)](x, impl=impl, return_kv=True)
            cache[str(i)]["k"][b, :, :S] = kv["k"]
            cache[str(i)]["v"][b, :, :S] = kv["v"]
    x = model.final_norm(x[:, -1:])
    return model.embed.logits(x), cache


# ---------------------------------------------------------------------------
# Decode (single token with cache)
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(model: Model, cache: Dict[str, Any], tokens: torch.Tensor,
                pos: torch.Tensor, *, impl: str = "auto"):
    """One decode step.  tokens: (B, 1) int; pos: (B,) int32 write
    positions.  Returns (logits (B, 1, V), cache).  The reference
    returns a new cache; this one writes the new K/V into ``cache`` in
    place and returns it."""
    x = model.embed(tokens)
    for b, block in enumerate(model.blocks):
        for i in range(len(model.pattern)):
            c = cache[str(i)]
            x = block[str(i)].decode(x, c["k"][b], c["v"][b], pos,
                                     impl=impl)
    x = model.final_norm(x)
    return model.embed.logits(x), cache
