"""AdamW with float32 or 8-bit (block-quantized) moments, and
global-norm clipping: the counterpart of ``repro/train/optimizer.py``.

Trees are the reference's (nested dicts of tensors, the blocks stacked
along a leading axis), so the 8-bit state's blocks of 256 run over the
same flattened leaves.  The math is float32 and rounds where the
reference's jitted step rounds on the CPU: XLA fuses a multiply into
the add or subtract that consumes it (one rounding, ``core.xla.fma``),
divides where the reference divides, and rounds half to even.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import xla
from repro_torch.utils import (global_norm, tree_leaves, tree_map,
                               tree_unflatten_like)


class AdamState(NamedTuple):
    m: Any
    v: Any
    # 8-bit mode keeps per-block scales alongside int8 payloads
    m_scale: Any = None
    v_scale: Any = None


BLOCK = 256  # quantization block for 8-bit state


def _f32(x: float) -> float:
    """A Python float rounded to float32, as XLA takes a weak constant."""
    return float(np.float32(x))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (through float64: PyTorch's
    float32 sqrt on the CPU is not)."""
    return torch.sqrt(x.double()).float()


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload (n_blocks, 256), float32 scales (n_blocks, 1)) of
    ``x`` flattened and zero-padded to whole blocks: scale = max|block|
    / 127 + 1e-12, payload = round half to even of x / scale clipped to
    +-127."""
    flat = x.reshape(-1).float()
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # XLA multiplies by the constant's reciprocal, fused into the add
    scale = xla.fma(amax, _f32(1.0 / 127.0), 1e-12)
    q = torch.round(blocks / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    flat = (q.float() * scale).reshape(-1)
    return flat[:n].reshape(shape)


def init_adam_state(params, *, eight_bit: bool = False) -> AdamState:
    """Zero moments shaped like ``params`` (float32, or int8 payloads
    with their scales)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    if not eight_bit:
        return AdamState(m=tree_map(zeros, params),
                         v=tree_map(zeros, params))
    q = tree_map(lambda p: _quantize(zeros(p))[0], params)
    s = tree_map(lambda p: _quantize(zeros(p))[1], params)
    return AdamState(m=q, v=tree_map(torch.clone, q), m_scale=s,
                     v_scale=tree_map(torch.clone, s))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    g = global_norm(grads)
    factor = torch.clamp(xla.div(max_norm, g + _f32(1e-9)), max=1.0)
    return tree_map(lambda x: (x.float() * factor).to(x.dtype), grads), g


def adamw_update(params, grads, state: AdamState, step: torch.Tensor, *,
                 lr: float, beta1: float = 0.9, beta2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 eight_bit: bool = False):
    """Returns (new_params, new_state).  Params stay in their stored dtype
    (float32 masters); the math is float32.  ``beta ** t`` is the C
    library's ``powf``, as XLA's CPU backend calls it (``xla.libm``), on
    the host: t is the step count, a scalar."""
    t = np.float32(int(step) + 1)
    c1 = _f32(1.0) - float(xla.libm("powf", np.float32(beta1), t))
    c2 = _f32(1.0) - float(xla.libm("powf", np.float32(beta2), t))
    c1, c2 = float(np.float32(c1)), float(np.float32(c2))

    def upd(p, g, m, v, ms, vs):
        g = g.float()
        if eight_bit:
            m_f = _dequantize(m, ms, p.shape)
            v_f = _dequantize(v, vs, p.shape)
        else:
            m_f, v_f = m, v
        # beta m + (1 - beta) g: the left product fused into the add
        m_f = xla.fma(beta1, m_f, g * _f32(1.0 - beta1))
        v_f = xla.fma(beta2, v_f, (g * g) * _f32(1.0 - beta2))
        vh = xla.div(v_f, c2)
        pf = p.float()
        # (m / c1) / den: XLA's simplifier rewrites a quotient of a
        # quotient as one division by the product, m / (den * c1)
        ratio = m_f / ((_sqrt(vh) + _f32(eps)) * c1)
        pf = xla.fma(-_f32(lr), xla.fma(weight_decay, pf, ratio), pf)
        if eight_bit:
            mq, msn = _quantize(m_f)
            vq, vsn = _quantize(v_f)
            return pf.to(p.dtype), mq, vq, msn, vsn
        return pf.to(p.dtype), m_f, v_f, None, None

    ms = state.m_scale if eight_bit else state.m
    vs = state.v_scale if eight_bit else state.v
    out = [upd(*a) for a in zip(*(tree_leaves(t) for t in (
        params, grads, state.m, state.v, ms, vs)))]

    def pick(i):
        return tree_unflatten_like(params, [o[i] for o in out])

    if eight_bit:
        return pick(0), AdamState(pick(1), pick(2), pick(3), pick(4))
    return pick(0), AdamState(pick(1), pick(2))
