"""Mamba-1 block (selective SSM) for falcon-mamba: the counterpart of
``repro/models/mamba.py``, as an ``nn.Module``.

Weights keep the reference's leaf names and layouts (``in_proj`` is
(d, 2·di), ``conv_w`` (di, d_conv), ``x_proj`` (di, dt_rank + 2·st),
``dt_w`` (dt_rank, di), ``A_log`` (di, st), ``out_proj`` (di, d)), so
converting a reference parameter tree is a plain copy.  The prefill's
scan goes through ``kernels/ssm_scan/ops.py`` (the CUDA ``chunk_scan``
on the card); the decode step is the plain ``selective_step``, as in
the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models.layers import _param, einsum


def dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, d_state, d_conv, dt_rank) of ``cfg``'s Mamba layers."""
    m = cfg.mamba
    di = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return di, m.d_state, m.d_conv, dt_rank


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, x: (B, S, DI), w: (DI,
    K): the reference's sum of K shifted products in the order
    i = 0..K-1, plus b.  Not ``F.conv1d``, which cuDNN runs in TF32 by
    default on the card."""
    K, S = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[:, 0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[:, i]
    return out + b


class Mamba(nn.Module):
    """The Mamba-1 mixer (``mamba_init`` / ``mamba_apply`` /
    ``mamba_decode``)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        di, st, dc, dtr = dims(cfg)
        self.cfg = cfg
        self.in_proj = _param((d, 2 * di), device, dtype)
        self.conv_w = _param((di, dc), device, dtype)
        self.conv_b = _param((di,), device, dtype)
        self.x_proj = _param((di, dtr + 2 * st), device, dtype)
        self.dt_w = _param((dtr, di), device, dtype)
        self.dt_b = _param((di,), device, dtype)
        self.A_log = _param((di, st), device, dtype)
        self.D = _param((di,), device, dtype)
        self.out_proj = _param((di, d), device, dtype)

    def _ssm_inputs(self, xc: torch.Tensor):
        _, st, _, dtr = dims(self.cfg)
        proj = einsum("...d,dk->...k", xc, self.x_proj)
        dt_r, Bm, Cm = proj.split([dtr, st, st], dim=-1)
        # F.softplus is linear above 20, jax.nn.softplus is
        # logaddexp(x, 0): equal there in float32
        dt = F.softplus(einsum("...r,rd->...d", dt_r, self.dt_w)
                        + self.dt_b)
        A = -torch.exp(self.A_log.float())
        return dt, A, Bm, Cm

    def forward(self, x: torch.Tensor, *, impl: str = "auto",
                return_state: bool = False):
        """Full-sequence path, x: (B, S, d_model).  With
        ``return_state`` also the decode-ready state: ``h`` float32
        (B, di, st) and ``conv``, the last d_conv - 1 pre-activation
        rows (B, d_conv - 1, di)."""
        dc = self.cfg.mamba.d_conv
        if return_state and x.shape[1] < dc - 1:
            raise ValueError(
                f"a prompt of {x.shape[1]} tokens is shorter than "
                f"d_conv - 1 = {dc - 1}; the decode step needs that many "
                f"rows of the conv window"
            )
        xz = einsum("bsd,dk->bsk", x, self.in_proj)
        xc_pre, z = xz.chunk(2, dim=-1)
        xc = F.silu(_causal_conv(xc_pre, self.conv_w, self.conv_b))
        dt, A, Bm, Cm = self._ssm_inputs(xc)
        y, h = ssm_ops.selective_scan(xc, dt, A, Bm, Cm, self.D, impl=impl)
        y = y * F.silu(z)
        out = einsum("bsk,kd->bsd", y, self.out_proj)
        if return_state:
            return out, {"h": h, "conv": xc_pre[:, x.shape[1] - (dc - 1):]}
        return out

    def decode(self, x: torch.Tensor, cache_h: torch.Tensor,
               cache_conv: torch.Tensor) -> torch.Tensor:
        """Single-token step, x: (B, 1, d_model); cache_h (B, di, st)
        float32, cache_conv (B, d_conv - 1, di).

        Unlike the reference, which returns a new state, this writes the
        new h and the shifted conv window into ``cache_h`` and
        ``cache_conv`` in place.  The window is built by ``cat`` before
        the write, so the shift never reads a row it overwrote."""
        xz = einsum("bsd,dk->bsk", x, self.in_proj)
        xc, z = xz.chunk(2, dim=-1)
        xc = xc[:, 0]  # (B, DI)
        window = torch.cat([cache_conv, xc[:, None].to(cache_conv.dtype)],
                           dim=1)  # (B, dc, DI)
        conv = (einsum("bkd,dk->bd", window.to(xc.dtype), self.conv_w)
                + self.conv_b)
        xcs = F.silu(conv)
        dt, A, Bm, Cm = self._ssm_inputs(xcs)
        y, h = ssm_ops.selective_step(xcs, dt, A, Bm, Cm, self.D, cache_h)
        y = y * F.silu(z[:, 0])
        out = einsum("bk,kd->bd", y, self.out_proj)[:, None]
        cache_h.copy_(h)
        cache_conv.copy_(window[:, 1:])
        return out
