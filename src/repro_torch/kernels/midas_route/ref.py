"""Plain PyTorch version of the ``route_select`` kernel.

The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel
against it on the card.  It is also what ``route_impl="ref"`` runs.
"""

from __future__ import annotations

from typing import Tuple

import torch

ROUTE_MODES = ("power_of_d", "midas", "chbl")


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
