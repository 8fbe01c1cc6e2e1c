"""Public wrappers for MIDAS routing: the engine's wave routing and the
MoE layer's expert dispatch, each dispatching on a resolved impl."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import resolve_impl
from repro_torch.kernels.midas_route import kernel, ref

topk_dispatch = ref.topk_dispatch
expert_load = ref.expert_load
# a tick of the midas policy in one launch (given (G, m) views, fleet
# routing's, each wave on its own row); its plain version is the
# engine's loop over the waves (core/sim.py:_route_waves), which runs
# route_waves once a wave
route_tick = kernel.route_tick


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
    reference kernel does."""
    impl = resolve_impl(impl, gate_logits.device)
    E = gate_logits.shape[-1]
    d_eff = min(d, E - k)
    kw = dict(delta_l=delta_l, gate_slack=gate_slack)
    if impl == "ref" or d_eff <= 0:
        return ref.midas_dispatch(gate_logits, load, k, d, f_max=f_max, **kw)
    logits = gate_logits.float().contiguous()
    loadf = load.float().contiguous()
    if f_max >= 1.0:
        return kernel.dispatch_fused(logits, loadf, k, d_eff, **kw)
    cand, vals = kernel.dispatch_candidates(logits, k + d_eff)
    return kernel.dispatch_steer(cand, vals, loadf, k, f_max=f_max, **kw)


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
