"""Plain PyTorch single-token attention over a KV cache (GQA, sliding
window, tanh softcap): the counterpart of
``repro/kernels/decode_attention/ref.py:decode_attention``."""

from __future__ import annotations

import math

import torch

NEG_INF = -(2.0**30)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q: (B, H, D); caches: (B, S, KV, D); pos: (B,) index of the newest
    token (row b attends to cache[b, 0..pos[b]] inclusive).  Returns
    (B, H, D) in q's dtype."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    logits = logits / math.sqrt(D)
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    si = torch.arange(S, device=q.device)[None, :]
    pos = pos.to(device=q.device)[:, None]
    mask = si <= pos
    if window > 0:
        mask &= si > pos - window
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)
