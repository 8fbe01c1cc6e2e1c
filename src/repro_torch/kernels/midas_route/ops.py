"""Public wrapper for the engine's wave routing: dispatch on impl."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.midas_route import kernel, ref


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
