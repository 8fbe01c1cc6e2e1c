"""Architecture builder for the dense attention and pure-SSM families.

The counterpart of ``repro/models/model.py``.  A model is a stack of
``num_blocks`` identical blocks; a block is a short pattern of layers
(``[attn]``, gemma2's ``[attn-local, attn-global]``, or falcon-mamba's
``[mamba]``).  The reference scans the stacked blocks with
``lax.scan``; here they are an ``nn.ModuleList`` walked in order, and
the decode cache keeps the reference's stacked layout: an attention
position holds ``{"k", "v"}`` of shape (num_blocks, B, S_max, KV, hd),
a Mamba position ``{"h": (num_blocks, B, di, st) float32, "conv":
(num_blocks, B, d_conv - 1, di)}``, so block ``b`` reads and writes the
views ``cache[pos][name][b]``.

MoE layers (so Jamba too), the audio and vision frontends and
rematerialisation raise ``NotImplementedError`` naming their ROADMAP
item.  There is no loss and no backward yet: the functions here run
without autograd.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_lib


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


def _layer_has_ffn(cfg: ArchConfig) -> bool:
    return cfg.family != "ssm"


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not
    port."""
    for spec in block_pattern(cfg):
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
    """Pre-norm mixer (attention or Mamba) and, outside the SSM family,
    a post-norm MLP, with residuals (``_layer_apply``)."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.spec = spec
        self.pre_norm = L.Norm(cfg.d_model, cfg.norm, **kw)
        if spec.kind == "attn":
            self.mixer = L.Attention(cfg, **kw)
        else:
            self.mixer = mamba_lib.Mamba(cfg, **kw)
        self.has_ffn = _layer_has_ffn(cfg)
        if self.has_ffn:
            self.post_norm = L.Norm(cfg.d_model, cfg.norm, **kw)
            self.ffn = L.MLP(cfg, **kw)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ffn(self.post_norm(x)) if self.has_ffn else x

    def forward(self, x: torch.Tensor, *, impl: str = "auto",
                return_state: bool = False):
        """With ``return_state`` also the mixer's decode state: the
        attention's ``{"k", "v"}`` or the Mamba layer's ``{"h",
        "conv"}``."""
        h = self.pre_norm(x)
        if self.spec.kind == "attn":
            out = self.mixer(h, is_local=self.spec.is_local, impl=impl,
                             return_kv=return_state)
        else:
            out = self.mixer(h, impl=impl, return_state=return_state)
        mix, state = out if return_state else (out, None)
        x = self._ffn(x + mix)
        return (x, state) if return_state else x

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """One token, ``cache`` this layer's views (``{"k", "v"}`` or
        ``{"h", "conv"}``), written in place."""
        h = self.pre_norm(x)
        if self.spec.kind == "attn":
            mix = self.mixer.decode(h, cache["k"], cache["v"], pos,
                                    is_local=self.spec.is_local, impl=impl)
        else:
            mix = self.mixer.decode(h, cache["h"], cache["conv"])
        return self._ffn(x + mix)


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


_ZEROS = ("bias", "bq", "bk", "bv", "b1", "b2", "conv_b")
_ONES = ("scale", "dt_b", "D")


def init_params(cfg: ArchConfig, seed: int = 0, *, dtype=torch.float32,
                device=None) -> Model:
    """A model with random weights on ``device`` (the card when None).

    The reference's rules: norm scales, Mamba's ``dt_b`` and ``D`` are
    ones, biases zeros, ``A_log`` is log(1..d_state) on every channel,
    and every other weight is normal / sqrt(fan_in), with fan_in the
    input width (H·hd for ``wo``, d_conv for ``conv_w``, 1 for the
    embedding table).  The draws come from a CPU ``torch.Generator``
    seeded with ``seed``, one parameter at a time, so a seed gives the
    same weights on every device (not the reference's: its threefry
    draws differ; parity tests convert the reference's weights with
    ``convert.params_from_numpy``)."""
    model = Model(cfg, device=device, dtype=dtype)
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ONES:
                p.fill_(1.0)
            elif leaf in _ZEROS:
                p.zero_()
            elif leaf == "A_log":
                st = p.shape[-1]
                p.copy_(torch.log(torch.arange(1, st + 1,
                                               dtype=torch.float32))
                        .expand(p.shape).to(dtype))
            else:
                if leaf == "tokens":
                    fan_in = 1
                elif leaf == "wo":
                    fan_in = p.shape[0] * p.shape[1]
                elif leaf == "conv_w":
                    fan_in = p.shape[1]
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
    (B, S).  ``impl`` (an ``IMPLS`` choice) picks every kernel of the
    path: the attention kernels and the SSM scan's ``chunk_scan``."""
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
    """Zeroed stacked caches on ``device`` (the card when None), one per
    block position: an attention position gets ``{"k", "v"}`` of shape
    (num_blocks, batch, max_seq, KV, hd) in ``dtype``, a Mamba position
    ``{"h": (num_blocks, batch, di, st) float32, "conv": (num_blocks,
    batch, d_conv - 1, di) in dtype}``."""
    check_supported(cfg)
    dev = resolve_device(device)
    n = num_blocks(cfg)
    cache: Dict[str, Any] = {}
    for i, spec in enumerate(block_pattern(cfg)):
        if spec.kind == "attn":
            shape = (n, batch, max_seq, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            cache[str(i)] = {
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
        else:
            di, st, dc, _ = mamba_lib.dims(cfg)
            cache[str(i)] = {
                "h": torch.zeros((n, batch, di, st), dtype=torch.float32,
                                 device=dev),
                "conv": torch.zeros((n, batch, dc - 1, di), dtype=dtype,
                                    device=dev)}
    return cache


@torch.no_grad()
def prefill(model: Model, batch: Dict[str, torch.Tensor],
            cache_len: Optional[int] = None, cache_dtype=torch.bfloat16,
            *, impl: str = "auto", remat_policy: str = "none"):
    """Serving prefill: run the prompt, return the last position's
    logits (B, 1, V) and a decode-ready cache: K/V padded with zeros to
    ``cache_len`` rows and rounded to ``cache_dtype``; a Mamba layer's
    h in float32 and its conv tail rounded to ``cache_dtype``.  A prompt
    shorter than d_conv - 1 raises ``ValueError`` for a Mamba model."""
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
            x, st = block[str(i)](x, impl=impl, return_state=True)
            c = cache[str(i)]
            if model.pattern[i].kind == "attn":
                c["k"][b, :, :S] = st["k"]
                c["v"][b, :, :S] = st["v"]
            else:
                c["h"][b] = st["h"]
                c["conv"][b] = st["conv"]
    x = model.final_norm(x[:, -1:])
    return model.embed.logits(x), cache


# ---------------------------------------------------------------------------
# Decode (single token with cache)
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(model: Model, cache: Dict[str, Any], tokens: torch.Tensor,
                pos: torch.Tensor, *, impl: str = "auto"):
    """One decode step.  tokens: (B, 1) int; pos: (B,) int32 write
    positions (read by attention layers only).  Returns (logits (B, 1,
    V), cache).  The reference returns a new cache; this one writes the
    new K/V, or the new h and conv window, into ``cache`` in place and
    returns it."""
    x = model.embed(tokens)
    for b, block in enumerate(model.blocks):
        for i in range(len(model.pattern)):
            views = {name: a[b] for name, a in cache[str(i)].items()}
            x = block[str(i)].decode(x, views, pos, impl=impl)
    x = model.final_norm(x)
    return model.embed.logits(x), cache
