"""Plain PyTorch attention over a whole sequence (causal, sliding
window, tanh softcap, GQA): the counterpart of
``repro/kernels/flash_attention/ref.py:mha``.  Logits and softmax in
float32, output cast back to the input dtype."""

from __future__ import annotations

import math

import torch

NEG_INF = -(2.0**30)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KV, D) with H % KV == 0; query head
    h reads KV head h // (H // KV).  Returns (B, S, H, D)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    logits = logits / math.sqrt(D)
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    si = torch.arange(S, device=q.device)[:, None]
    ti = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ti <= si
    if window > 0:
        mask &= ti > si - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def mha_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
):
    """(dq, dk, dv): the gradient of :func:`mha` at (q, k, v) against
    the output gradient ``dout``, by autograd (the plain version the
    backward kernel is held to)."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = mha(qq, kk, vv, causal=causal, window=window, softcap=softcap)
        return torch.autograd.grad(out, (qq, kk, vv), dout)
