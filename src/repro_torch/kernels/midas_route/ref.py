"""Plain PyTorch versions of the MIDAS routing kernels.

``route_select`` is the simulator's wave routing; ``topk_dispatch``,
``steer_from_candidates``, ``midas_dispatch`` and ``expert_load`` are
the MoE dispatch (the counterparts of
``repro/kernels/midas_route/ref.py``).  The CPU tests run them, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
They are also what ``impl="ref"`` runs.

The MoE dispatch maps the paper's routing onto experts: the top-(k+d)
gate candidates of a token are its feasible set, slot i's primary is
its i-th ranked expert, and a slot steers to the least-loaded unused
alternate when the stale load telemetry clears the Δ_L margin and the
alternate's logit is within ``gate_slack`` of the primary's; with
``f_max < 1`` only the most beneficial fraction of the batch's tokens
steers in each slot.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

ROUTE_MODES = ("power_of_d", "midas", "chbl")
C_LOAD = 1.25  # CHBL capacity factor: cap = c * (mean load + 1)


def check_mode(mode: str) -> None:
    if mode not in ROUTE_MODES:
        raise ValueError(
            f"unknown route mode {mode!r}; available: "
            f"{', '.join(ROUTE_MODES)}"
        )


def route_select(
    feas: torch.Tensor,
    load: torch.Tensor,
    p50: torch.Tensor,
    sampled: torch.Tensor,
    tie: torch.Tensor,
    scalars: torch.Tensor,
    *,
    mode: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wave-routing core: per-request best feasible server.

    feas: (R, d_max) int32 feasible sets (slot 0 = primary, ids in
    [0, m)); load/p50: (m,) float32 telemetry views; sampled: (R,
    d_max) bool power-of-d sampling mask (ignored by chbl); tie: (R,
    d_max) float32 tie-break scores; scalars: (4,) float32
    [delta_l, delta_t, cap, unused].  Returns ``(assign (R,) int32,
    ok_any (R,) bool)``; ``ok_any`` is midas's "any eligible candidate"
    flag (False in the other modes).  Argmins take the first index on
    ties, as ``jnp.argmin`` does.
    """
    check_mode(mode)
    idx = feas.long()
    lf = load[idx]
    ok_any = torch.zeros(feas.shape[:1], dtype=torch.bool,
                         device=feas.device)
    if mode == "power_of_d":
        slot = torch.argmin(torch.where(sampled, lf, torch.inf) + tie, 1)
    elif mode == "midas":
        p50f = p50[idx]
        ok = (
            sampled
            & (lf <= lf[:, :1] - scalars[0])
            & (p50f <= p50f[:, :1] - scalars[1])
        )
        slot = torch.argmin(torch.where(ok, lf, torch.inf) + tie, 1)
        ok_any = ok.any(1)
    else:  # chbl
        under = lf <= scalars[2]
        first_under = torch.argmax(under.to(torch.uint8), 1)
        slot = torch.where(under.any(1), first_under, torch.argmin(lf, 1))
    assign = torch.gather(feas, 1, slot[:, None])[:, 0]
    return assign, ok_any


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------


def top_candidates(
    gate_logits: torch.Tensor, kd: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``kd`` largest logits of each row of (T, E) ``gate_logits``,
    largest first: (ids (T, kd) int32, values (T, kd) float32).  Equal
    logits rank by the lowest expert id, as ``jax.lax.top_k`` and the
    reference kernel's iterated argmax rank them; ``torch.topk`` leaves
    that order unspecified, so this is a stable descending sort."""
    vals, ids = torch.sort(gate_logits.float(), dim=-1, descending=True,
                           stable=True)
    return (ids[:, :kd].to(torch.int32).contiguous(),
            vals[:, :kd].contiguous())


def topk_dispatch(
    gate_logits: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vanilla top-k routing: experts (T, k) int32, and weights (T, k)
    float32, the softmax over the chosen logits."""
    experts, vals = top_candidates(gate_logits, k)
    return experts, torch.softmax(vals, dim=-1)


@functools.lru_cache(maxsize=1024)
def quantile_plan(n: int, q: float) -> Tuple[int, int, float, float]:
    """The host-side part of :func:`quantile` for ``n`` values: the
    ranks ``(low, high)`` of the two order statistics it interpolates,
    clamped to ``[0, n - 1]``, and their weights ``(w_high, w_low)``.
    They depend on n and q alone and are float32 scalars on the host,
    as XLA folds them: the position ``float32(q) * float32(n - 1)`` in
    float32.  The CUDA ``dispatch_steer`` takes the same plan."""
    pos = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    w_high = pos - low
    w_low = np.float32(1.0) - w_high
    return (int(min(max(low, 0), n - 1)), int(min(max(high, 0), n - 1)),
            float(w_high), float(w_low))


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` of a 1-D float32 tensor (linear
    interpolation), rounded as the reference computes it on the CPU:
    the position from :func:`quantile_plan` and the interpolation
    ``high * w_high + low * w_low`` with one fused multiply-add
    (``core.xla.fma``).  A last-bit difference here can flip a
    steer."""
    # imported here: repro_torch.core imports this module through the
    # routing policies
    from repro_torch.core.xla import fma

    low, high, w_high, w_low = quantile_plan(x.shape[0], q)
    s = torch.sort(x).values
    return fma(s[high], w_high, s[low] * w_low)


def steer_from_candidates(
    cand: torch.Tensor,
    vals: torch.Tensor,
    load: torch.Tensor,
    k: int,
    *,
    delta_l: float = 2.0,
    gate_slack: float = 1.0,
    f_max: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Margin and f_max-capped steering over precomputed candidates.

    ``cand``/``vals`` are the (T, k+d) gate-ranked candidate ids
    (int32) and logits (float32): slots 0..k-1 are the primaries, k..
    the d alternates.  Slots steer in order, each alternate at most
    once.  The plain path runs it on the candidates of
    :func:`top_candidates`; its CUDA counterpart is ``dispatch_steer``,
    which the kernel path runs on those of ``dispatch_candidates``.
    With ``f_max < 1`` the threshold is the batch-wide quantile of the
    per-token benefit (:func:`quantile`), so it runs over the whole
    (T,) vector.  Returns (experts (T, k) int32, weights (T, k)
    float32, steered (T, k) bool)."""
    T = cand.shape[0]
    d_eff = cand.shape[1] - k
    loadf = load.float()
    ids = cand.long()
    alt_ids = ids[:, k:]
    alt_vals = vals[:, k:]
    alt_load = loadf[alt_ids]  # (T, d)
    cols = torch.arange(d_eff, device=cand.device)
    alt_used = torch.zeros((T, d_eff), dtype=torch.bool, device=cand.device)
    floor = float(np.float32(delta_l - 1e-9))
    chosen, chosen_vals, flags = [], [], []
    for i in range(k):
        prim = ids[:, i]
        prim_val = vals[:, i]
        prim_load = loadf[prim]
        ok = (
            ~alt_used
            & (alt_load <= (prim_load - delta_l)[:, None])
            & (alt_vals >= (prim_val - gate_slack)[:, None])
        )
        masked = torch.where(ok, alt_load, torch.inf)
        best = torch.argmin(masked, dim=-1)  # the first index on ties
        has = ok.any(dim=-1)
        benefit = torch.where(has, prim_load - masked.amin(dim=-1),
                              -torch.inf)
        if f_max >= 1.0:
            steer = has & (benefit >= delta_l)
        elif f_max <= 0.0:
            steer = torch.zeros_like(has)
        else:
            finite = torch.where(torch.isfinite(benefit), benefit, -1e9)
            q = quantile(finite, 1.0 - f_max)
            steer = has & (benefit > q.clamp(min=floor))
        pick = best[:, None]
        e_i = torch.where(steer, torch.gather(alt_ids, 1, pick)[:, 0], prim)
        v_i = torch.where(steer, torch.gather(alt_vals, 1, pick)[:, 0],
                          prim_val)
        alt_used = alt_used | (steer[:, None] & (cols == pick))
        chosen.append(e_i)
        chosen_vals.append(v_i)
        flags.append(steer)
    experts = torch.stack(chosen, dim=1).to(torch.int32)
    weights = torch.softmax(torch.stack(chosen_vals, dim=1).float(), dim=-1)
    return experts, weights, torch.stack(flags, dim=1)


def midas_dispatch(
    gate_logits: torch.Tensor,
    load: torch.Tensor,
    k: int,
    d: int,
    *,
    delta_l: float = 2.0,
    gate_slack: float = 1.0,
    f_max: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Power-of-d steering over the top-(k+d) gate candidates.

    gate_logits: (T, E) float32; load: (E,) the stale per-expert token
    share, normalised so a balanced system has load 1 everywhere.
    Returns (experts (T, k) int32, weights (T, k) float32, steered
    (T, k) bool).  ``f_max=1.0`` is the margin-governed variant, the
    default of the kernel and of ``ops`` too.  With ``d_eff = min(d,
    E - k) <= 0`` there is no alternate and this is plain top-k."""
    E = gate_logits.shape[1]
    d_eff = min(d, E - k)
    if d_eff <= 0:
        experts, weights = topk_dispatch(gate_logits, k)
        return experts, weights, torch.zeros_like(experts, dtype=torch.bool)
    cand, vals = top_candidates(gate_logits, k + d_eff)
    return steer_from_candidates(cand, vals, load, k, delta_l=delta_l,
                                 gate_slack=gate_slack, f_max=f_max)


def expert_load(experts: torch.Tensor, E: int) -> torch.Tensor:
    """Per-expert token share of (T, k) ``experts``, mean 1 (balanced is
    ones): ``counts * E / (T * k)`` rounded as XLA compiles it inside
    the reference's model, where the division by the constant T·k is
    folded into one float32 constant, ``E * (1 / (T * k))``, and the
    counts are multiplied by it.  (The reference's eager ``ref`` call
    divides instead, and can differ from this in the last bit.)"""
    T, k = experts.shape
    counts = torch.bincount(experts.reshape(-1).long(), minlength=E)
    scale = np.float32(E) * (np.float32(1.0) / np.float32(T * k))
    return counts.float() * float(scale)
