"""Core transformer layers: norms, RoPE, GQA attention, MLPs, embeddings.

The counterparts of ``repro/models/layers.py``, as ``nn.Module``s.
Weights keep the reference's layouts (``wq`` is (d, H, hd), ``wo`` is
(H, hd, d), the embedding table is (V, d)), so converting a reference
parameter tree is a plain copy.  Projections are ``torch.einsum`` (on
operands promoted to a common dtype, :func:`einsum`), as the reference
leaves them to XLA; attention goes through the ported kernels'
dispatchers.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa


def _param(shape, device, dtype) -> nn.Parameter:
    """An uninitialised weight; :func:`repro_torch.models.init_params`
    or ``convert.params_from_numpy`` fills it.  Serving needs no
    gradients, so none are tracked; training differentiates its own
    float32 masters (``train/step.py``)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands promoted to their common dtype,
    as ``jnp.einsum`` promotes them: under mixed precision a float32
    bias or activation meets a bfloat16 weight (MusicGen's MLP, the
    Mamba mixer's float32 conv output)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# Normalization (fp32 statistics)
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm or LayerNorm with eps 1e-6, float32 statistics and
    ``rsqrt``, cast back to the input dtype (``norm_apply``)."""

    def __init__(self, d: int, kind: str, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.kind = kind
        self.scale = _param((d,), device, dtype)
        if kind == "layernorm":
            self.bias = _param((d,), device, dtype)

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        xf = x.float()
        if self.kind == "layernorm":
            mu = xf.mean(-1, keepdim=True)
            var = xf.var(-1, keepdim=True, unbiased=False)
            out = (xf - mu) * torch.rsqrt(var + eps)
            out = out * self.scale.float() + self.bias.float()
        else:
            ms = xf.square().mean(-1, keepdim=True)
            out = xf * torch.rsqrt(ms + eps) * self.scale.float()
        return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (
        -torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  The
    head is split in halves (not interleaved)."""
    if theta <= 0.0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    ang = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def _window(cfg: ArchConfig, is_local: bool) -> int:
    return cfg.window_size if (is_local and cfg.window_size > 0) else 0


class Attention(nn.Module):
    """GQA self-attention (``attn_init`` / ``attn_apply`` /
    ``attn_decode``)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        self.cfg = cfg
        self.wq = _param((d, H, hd), device, dtype)
        self.wk = _param((d, KV, hd), device, dtype)
        self.wv = _param((d, KV, hd), device, dtype)
        self.wo = _param((H, hd, d), device, dtype)
        if cfg.qkv_bias:
            self.bq = _param((H, hd), device, dtype)
            self.bk = _param((KV, hd), device, dtype)
            self.bv = _param((KV, hd), device, dtype)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        q = einsum("bsd,dhk->bshk", x, self.wq)
        k = einsum("bsd,dhk->bshk", x, self.wk)
        v = einsum("bsd,dhk->bshk", x, self.wv)
        if self.cfg.qkv_bias:
            q = q + self.bq
            k = k + self.bk
            v = v + self.bv
        q = apply_rope(q, positions, self.cfg.rope_theta)
        k = apply_rope(k, positions, self.cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, *, is_local: bool,
                positions: Optional[torch.Tensor] = None,
                impl: str = "auto", return_kv: bool = False):
        """Full-sequence (prefill) attention.  x: (B, S, d_model)."""
        S = x.shape[1]
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = self.qkv(x, positions)
        out = fa.flash_attention(
            q, k, v, causal=True, window=_window(self.cfg, is_local),
            softcap=self.cfg.logit_softcap, impl=impl,
        )
        y = einsum("bshk,hkd->bsd", out, self.wo)
        if return_kv:
            return y, {"k": k, "v": v}
        return y

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: torch.Tensor, *,
               is_local: bool, impl: str = "auto") -> torch.Tensor:
        """Single-token decode.  x: (B, 1, d); caches (B, S_max, KV, hd);
        pos: (B,) positions of the new token.

        Unlike the reference, which returns new caches, this writes the
        new K/V into ``cache_k``/``cache_v`` in place.  As the reference
        does, it writes them at ``pos[0]`` for every batch row, clamped
        into [0, S_max - 1] as ``dynamic_update_slice`` clamps."""
        q, k, v = self.qkv(x, pos[:, None])
        row = pos[:1].clamp(0, cache_k.shape[1] - 1).long()
        cache_k.index_copy_(1, row, k.to(cache_k.dtype))
        cache_v.index_copy_(1, row, v.to(cache_v.dtype))
        out = da.decode_attention(
            q[:, 0], cache_k, cache_v, pos,
            window=_window(self.cfg, is_local),
            softcap=self.cfg.logit_softcap, impl=impl,
        )
        return einsum("bhk,hkd->bd", out, self.wo)[:, None, :]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """Gated (SiLU / GELU) or plain-GELU MLP (``mlp_init`` /
    ``mlp_apply``)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.act = cfg.act
        if cfg.act == "gelu_plain":
            self.w1 = _param((d, f), device, dtype)
            self.b1 = _param((f,), device, dtype)
            self.w2 = _param((f, d), device, dtype)
            self.b2 = _param((d,), device, dtype)
        else:
            self.w_gate = _param((d, f), device, dtype)
            self.w_up = _param((d, f), device, dtype)
            self.w_down = _param((f, d), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act == "gelu_plain":
            h = _gelu(einsum("bsd,df->bsf", x, self.w1) + self.b1)
            return einsum("bsf,fd->bsd", h, self.w2) + self.b2
        act = F.silu if self.act == "silu" else _gelu
        g = einsum("bsd,df->bsf", x, self.w_gate)
        u = einsum("bsd,df->bsf", x, self.w_up)
        return einsum("bsf,fd->bsd", act(g) * u, self.w_down)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    """Token embedding and LM head (``embed_apply`` /
    ``lm_head_apply``); a tied head contracts with ``tokens``."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.tokens = _param((cfg.vocab_size, cfg.d_model), device, dtype)
        if not cfg.tie_embeddings:
            self.head = _param((cfg.d_model, cfg.vocab_size), device, dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, self.tokens)  # int32 or int64 ids
        if self.cfg.name.startswith("gemma2"):
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            out = einsum("bsd,vd->bsv", x, self.tokens)
        else:
            out = einsum("bsd,dv->bsv", x, self.head)
        return softcap(out, self.cfg.final_softcap)

