"""Public wrappers for MIDAS routing: the engine's wave routing and the
MoE layer's expert dispatch, each dispatching on a resolved impl."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import resolve_impl
from repro_torch.kernels.midas_route import kernel, ref

topk_dispatch = ref.topk_dispatch
expert_load = ref.expert_load
# a tick of the midas, power_of_d or chbl policy in one launch, its dV
# included (given (G, m) views, fleet routing's, each wave on its own
# row); its plain version is the engine's loop over the waves
# (core/sim.py:_route_waves), which runs route_waves once a wave
route_tick = kernel.route_tick


class _DispatchGrad(torch.autograd.Function):
    """The dispatch kernels' result with a gradient for the weights:
    ``weights = softmax`` of the chosen experts' gate logits over the k
    slots, so the gate logits' gradient is the softmax's gradient
    scattered to the chosen experts (zero elsewhere), as ``jax.grad``
    of the reference's dispatch gives it through ``top_k`` and
    ``take_along_axis``.  The experts and flags carry no gradient."""

    @staticmethod
    def forward(ctx, gate_logits, run):
        experts, weights, steered = run(gate_logits.detach())
        ctx.save_for_backward(experts, weights)
        ctx.shape = gate_logits.shape
        ctx.mark_non_differentiable(experts, steered)
        return experts, weights, steered

    @staticmethod
    def backward(ctx, _g_experts, g_weights, _g_steered):
        experts, weights = ctx.saved_tensors
        g_weights = g_weights.float()
        dot = (g_weights * weights).sum(dim=-1, keepdim=True)
        g_chosen = weights * (g_weights - dot)
        grad = torch.zeros(ctx.shape, dtype=torch.float32,
                           device=weights.device)
        # the k experts of a token differ: each cell is written once
        grad.scatter_(1, experts.long(), g_chosen)
        return grad, None


def midas_dispatch(
    gate_logits: torch.Tensor,
    load: torch.Tensor,
    k: int,
    d: int,
    *,
    delta_l: float = 2.0,
    gate_slack: float = 1.0,
    f_max: float = 1.0,
    impl: str = "auto",
):
    """MoE expert dispatch, as :func:`ref.midas_dispatch` (the same
    defaults in ref, kernel and here).

    ``impl`` is an ``IMPLS`` choice: "auto" launches the CUDA kernels
    for tensors on the card and runs the plain version on the CPU;
    "cuda" on CPU tensors raises.  On the kernel path ``f_max >= 1``
    is one launch of ``dispatch_fused``; ``f_max < 1`` is one launch of
    ``dispatch_candidates`` followed by one of ``dispatch_steer``, the
    batch-wide quantile and the steering of ``ref.steer_from_candidates``
    (which the plain path runs).  With ``d_eff = min(d, E - k) <= 0``
    there is nothing to steer and every impl runs plain top-k, as the
    reference kernel does.

    Under autograd the plain path differentiates as it is and the kernel
    path through :class:`_DispatchGrad`: the weights' gradient reaches
    ``gate_logits`` at the chosen experts (``load`` gets none, as in the
    reference, where it only steers)."""
    impl = resolve_impl(impl, gate_logits.device)
    E = gate_logits.shape[-1]
    d_eff = min(d, E - k)
    kw = dict(delta_l=delta_l, gate_slack=gate_slack)
    if impl == "ref" or d_eff <= 0:
        return ref.midas_dispatch(gate_logits, load, k, d, f_max=f_max, **kw)
    loadf = load.detach().float().contiguous()

    def run(logits):
        logits = logits.float().contiguous()
        if f_max >= 1.0:
            return kernel.dispatch_fused(logits, loadf, k, d_eff, **kw)
        cand, vals = kernel.dispatch_candidates(logits, k + d_eff)
        return kernel.dispatch_steer(cand, vals, loadf, k, f_max=f_max,
                                     **kw)

    if torch.is_grad_enabled() and gate_logits.requires_grad:
        return _DispatchGrad.apply(gate_logits, run)
    return run(gate_logits)


def route_waves(
    feas: torch.Tensor,
    load: torch.Tensor,
    p50: torch.Tensor,
    sampled: torch.Tensor,
    tie: torch.Tensor,
    scalars: torch.Tensor,
    *,
    mode: str,
    impl: str,
):
    """Batched feasible-set routing for the engine's wave step.

    Any leading batch axes on ``feas``/``sampled``/``tie`` (waves ×
    requests) are flattened into one request axis and restored on
    return.  ``impl`` is a resolved route implementation: "ref" runs
    the plain PyTorch version, "cuda" the hand-written kernel (which
    raises for tensors off the card).  See
    :func:`repro_torch.kernels.midas_route.ref.route_select`.
    """
    lead = feas.shape[:-1]
    d_max = feas.shape[-1]
    R = math.prod(lead)
    args = (
        feas.reshape(R, d_max),
        load,
        p50,
        sampled.reshape(R, d_max),
        tie.reshape(R, d_max),
        scalars.reshape(4),
    )
    if impl == "cuda":
        assign, ok_any = kernel.route_select(*args, mode=mode)
    elif impl == "ref":
        assign, ok_any = ref.route_select(*args, mode=mode)
    else:
        raise ValueError(
            f"unknown route impl {impl!r}; resolve it with "
            f"kernels.common.resolve_impl"
        )
    return assign.reshape(lead), ok_any.reshape(lead)
