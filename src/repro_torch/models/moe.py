"""Mixture-of-Experts layer with capacity-bounded dispatch: the
counterpart of ``repro/models/moe.py`` on one device.

Routers: "topk" (vanilla top-k gating, the baseline) and "midas" (the
paper's power-of-d steering over the top-(k+d) gate candidates, from
stale per-expert load telemetry, ``kernels/midas_route``).  Dispatch
scatters each kept (token, slot) pair into an (E, C, d) buffer of
capacity ``C = ceil(k·T/E)·capacity_factor``; pairs over capacity are
dropped, and the drop rate is the metadata-hotspot analogue.

The weights keep the reference's leaf names and layouts (``router``
(d, E), ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d)).  The
expert products are batched matrix products over the whole buffer,
as the reference's ``einsum`` (the reference's shard_map path,
``moe_apply_sharded``, is not ported: ROADMAP §1 item 19).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.core import xla
from repro_torch.kernels.midas_route import ops as route_ops
from repro_torch.models.layers import _gelu, _param, einsum


class MoEAux(NamedTuple):
    load: torch.Tensor  # (E,) this batch's expert token share (mean 1)
    drop_rate: torch.Tensor  # () fraction of (token, slot) pairs dropped
    steer_rate: torch.Tensor  # () fraction of slots steered (midas only)
    aux_loss: torch.Tensor  # () switch-style load-balance loss


def positions_within_expert(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """pos[i] = #{j < i : e_j == e_i} (int64), by a stable sort."""
    n = flat_e.shape[0]
    flat_e = flat_e.long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(
        sorted_e, torch.arange(E, device=flat_e.device))
    pos_sorted = torch.arange(n, device=flat_e.device) - start[sorted_e]
    return torch.empty_like(pos_sorted).index_copy_(0, order, pos_sorted)


def capacity(cfg: ArchConfig, T: int) -> int:
    """Slots per expert for T tokens, as the reference computes them."""
    mo = cfg.moe
    k, E = mo.experts_per_token, mo.num_experts
    C = max(int(-(-k * T // E) * mo.capacity_factor), 1)
    return min(C, T)


def dispatch(cfg: ArchConfig, gate_logits: torch.Tensor,
             load_ewma: Optional[torch.Tensor], *, impl: str = "auto"):
    """(experts (T, k) int32, weights (T, k) float32, steered (T, k)
    bool) of (T, E) float32 gate logits under ``cfg``'s router.  A
    midas router without telemetry (``load_ewma`` None) sees a balanced
    load of ones."""
    mo = cfg.moe
    k = mo.experts_per_token
    if mo.router == "midas":
        if load_ewma is None:
            load_ewma = torch.ones((mo.num_experts,), dtype=torch.float32,
                                   device=gate_logits.device)
        return route_ops.midas_dispatch(
            gate_logits, load_ewma, k, mo.midas_d,
            delta_l=float(mo.midas_delta_l), f_max=mo.midas_fmax, impl=impl)
    experts, weights = route_ops.topk_dispatch(gate_logits, k)
    return experts, weights, torch.zeros_like(experts, dtype=torch.bool)


def _recip(n: int) -> float:
    """The float32 reciprocal of a count: XLA compiles ``jnp.mean`` to
    the sum times it."""
    return float(np.float32(1.0) / np.float32(n))


def _mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """float32 mean as XLA compiles ``jnp.mean``."""
    if dim is None:
        return x.float().sum() * _recip(x.numel())
    return x.float().sum(dim) * _recip(x.shape[dim])


class MoE(nn.Module):
    """The MoE feed-forward layer (``moe_init`` / ``moe_apply``)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        mo = cfg.moe
        d, f, E = cfg.d_model, mo.d_ff_expert, mo.num_experts
        self.cfg = cfg
        self.router = _param((d, E), device, dtype)
        self.w_gate = _param((E, d, f), device, dtype)
        self.w_up = _param((E, d, f), device, dtype)
        self.w_down = _param((E, f, d), device, dtype)

    def forward(self, x: torch.Tensor,
                load_ewma: Optional[torch.Tensor] = None, *,
                impl: str = "auto") -> Tuple[torch.Tensor, MoEAux]:
        """x: (B, S, d); load_ewma: (E,) stale telemetry (midas router)
        or None.  ``impl`` picks the dispatch kernel.  Returns (y (B, S,
        d), :class:`MoEAux`)."""
        cfg, mo = self.cfg, self.cfg.moe
        B, S, d = x.shape
        E, k = mo.num_experts, mo.experts_per_token
        T = B * S
        xt = x.reshape(T, d)
        gate_logits = einsum("td,de->te", xt, self.router).float()
        experts, weights, steered = dispatch(cfg, gate_logits, load_ewma,
                                             impl=impl)

        # ---- capacity-bounded dispatch: row e·C + pos of the buffer,
        # dropped pairs into one spare row past the end
        C = capacity(cfg, T)
        flat_e = experts.reshape(T * k).long()
        flat_w = weights.reshape(T * k)
        pos = positions_within_expert(flat_e, E)
        keep = pos < C
        row = torch.where(keep, flat_e * C + pos, E * C)
        tok = torch.arange(T, device=x.device).repeat_interleave(k)
        buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=x.device)
        buf.index_add_(0, row, xt[tok])
        buf = buf[:E * C].view(E, C, d)

        # ---- expert FFN (gated)
        act = F.silu if cfg.act == "silu" else _gelu
        g = einsum("ecd,edf->ecf", buf, self.w_gate)
        u = einsum("ecd,edf->ecf", buf, self.w_up)
        out = einsum("ecf,efd->ecd", act(g) * u, self.w_down).reshape(
            E * C, d)

        # ---- combine, summed over the k slots in float32
        gathered = out[row.clamp(max=E * C - 1)]
        gathered = torch.where(keep[:, None], gathered, 0.0)
        y = (gathered.float() * flat_w[:, None]).view(T, k, d).sum(dim=1)
        y = y.to(x.dtype).view(B, S, d)

        # ---- aux
        load = route_ops.expert_load(experts, E)
        # 1 - mean(keep), the product and the subtraction fused by XLA
        drop_rate = xla.fma(-keep.float().sum(), _recip(T * k), 1.0)
        probs = torch.softmax(gate_logits, dim=-1)
        aux_loss = E * (load * (1.0 / E) * _mean(probs, 0)).sum()
        return y, MoEAux(load=load, drop_rate=drop_rate,
                         steer_rate=_mean(steered), aux_loss=aux_loss)


def update_load_ewma(load_ewma: torch.Tensor, batch_load: torch.Tensor,
                     alpha: float = 0.2) -> torch.Tensor:
    """The paper's fast-loop EWMA over (stale) telemetry, ``(1 - alpha)
    * load_ewma + alpha * batch_load`` with the one rounding of the
    fused multiply-add XLA compiles it to (``core.xla.fma``)."""
    return xla.fma(1.0 - alpha, load_ewma, alpha * batch_load)
