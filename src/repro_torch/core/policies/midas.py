"""Full MIDAS routing: margins + pinning + exact sliding-window leaky bucket.

Faithfulness notes:
  * Proxies act on *stale* telemetry -- the EWMA view from the last
    fast-loop ingest -- never on instantaneous queue state.
  * MIDAS steering needs BOTH margins:  L̂_j ≤ L̂_p − Δ_L  and
    p̃50_j ≤ p̃50_p − Δ_t;  winner is argmin L̂ with random tie-break.
  * Steered keys are pinned to their chosen server for C ms.
  * A sliding-window leaky bucket caps steered/eligible ≤ f_max exactly.

The pin tables are (N,) per-key arrays and are updated in place.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.policies.base import (
    Policy,
    RouteStats,
    TickRoute,
    WaveDraws,
    register,
    sample_ranks,
    steering_dv,
)
from repro_torch.core.xla import set_last
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.midas_route import ops as route_ops


class MidasState(NamedTuple):
    pin_server: torch.Tensor  # (N,) int32 pinned server per key (-1 none)
    pin_expiry: torch.Tensor  # (N,) float32 absolute pin expiry (ms)
    steer_hist: torch.Tensor  # (W,) float32 per-tick steered counts
    elig_hist: torch.Tensor  # (W,) float32 per-tick eligible counts
    hist_idx: torch.Tensor  # () int32


def init_midas(N: int, w_ticks: int, device=None) -> MidasState:
    """Empty pins and steering history on ``device`` (the card when
    None)."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return MidasState(
        pin_server=torch.full((N,), -1, dtype=torch.int32, device=device),
        pin_expiry=torch.zeros((N,), **f32),
        steer_hist=torch.zeros((w_ticks,), **f32),
        elig_hist=torch.zeros((w_ticks,), **f32),
        hist_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


class MidasTickStats(NamedTuple):
    eligible: torch.Tensor  # () number of steer-eligible requests
    steered: torch.Tensor  # () number actually steered


def _pick(hist: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``hist[i]`` for a 0-d index tensor, without a host read."""
    return hist.index_select(0, i.view(1))[0]


def route_midas(
    rs: MidasState,
    draws: WaveDraws,
    keys: torch.Tensor,
    feas: torch.Tensor,
    L_view: torch.Tensor,
    p50_view: torch.Tensor,
    mask: torch.Tensor,
    d,
    delta_l,
    delta_t,
    f_max,
    now_ms,
    pin_c_ms,
    w_ticks: int,
    impl: str = "ref",
) -> Tuple[MidasState, torch.Tensor, MidasTickStats]:
    """Full MIDAS routing for one request batch (Alg. 1 lines 36-47).

    The margin-eligibility + tie-broken argmin core is the
    ``route_select`` kernel (``impl="cuda"``) or its plain version
    (``impl="ref"``), fed the same sampling mask and tie scores, so the
    two are bitwise identical.  Pins, the leaky bucket and the window
    histories are sequential scalar state around it.
    """
    primary = feas[:, 0]
    sampled = draws.rank < d
    sampled[:, 0] = False  # candidates exclude the primary
    z = torch.zeros((), dtype=torch.float32, device=feas.device)
    scalars = torch.stack([delta_l, delta_t, z, z])
    best, ok_any = route_ops.route_waves(
        feas, L_view, p50_view, sampled, draws.tie, scalars,
        mode="midas", impl=impl,
    )
    has_candidate = ok_any & mask

    # honor active pins: pinned keys go to their pinned server, no steering
    pin_s = rs.pin_server[keys]
    pinned = (rs.pin_expiry[keys] > now_ms) & (pin_s >= 0) & mask
    # leaky bucket (exact sliding window): allow at most
    #   f_max * (eligible in window incl. now) - (steered in window)
    i = (rs.hist_idx % w_ticks).long()
    want = has_candidate & ~pinned
    elig_now = want.sum()
    elig_win = rs.elig_hist.sum() - _pick(rs.elig_hist, i) + elig_now
    steer_win = rs.steer_hist.sum() - _pick(rs.steer_hist, i)
    budget = torch.floor(f_max * elig_win) - steer_win
    order_rank = torch.cumsum(want.to(torch.int32), 0) - 1
    allowed = want & (order_rank < budget)

    assign = torch.where(
        pinned, pin_s, torch.where(allowed, best, primary)
    )
    assign = torch.where(mask, assign, -1)

    # pin steered keys for C ms; a key steered twice in one wave keeps
    # its last steer, as the reference's scatter does
    set_last(rs.pin_server, keys, best, allowed)
    set_last(rs.pin_expiry, keys, now_ms + pin_c_ms, allowed)

    steered = allowed.sum().to(torch.float32)
    eligible = elig_now.to(torch.float32)
    rs.steer_hist.index_copy_(0, i.view(1), steered.view(1))
    rs.elig_hist.index_copy_(0, i.view(1), eligible.view(1))
    new = rs._replace(hist_idx=rs.hist_idx + 1)
    return new, assign, MidasTickStats(eligible=eligible, steered=steered)


@register("midas")
class Midas(Policy):
    """Margined power-of-d with pinning and a leaky steering bucket,
    driven by the adaptive control knobs (d, Δ_L, Δ_t, f_max)."""

    adaptive = True  # consumes warmup-derived control targets (§III-B)

    def init(self, cfg, ring, device=None) -> MidasState:
        return init_midas(cfg.N, cfg.w_ticks, device)

    def draws(self, keys, shape) -> WaveDraws:
        tie = prng.uniform(prng.fold_in(keys, 2), shape) * 1e-3
        return WaveDraws(
            rank=sample_ranks(prng.uniform(keys, shape)), tie=tie
        )

    def route(self, state: MidasState, ctx):
        k = ctx.knobs
        state, assign, stats = route_midas(
            state,
            ctx.draws,
            ctx.keys,
            ctx.feas,
            ctx.L_view,
            ctx.p50_view,
            ctx.mask,
            k.d,
            k.delta_l,
            k.delta_t,
            k.f_max,
            ctx.now_ms,
            k.pin_ms,
            state.steer_hist.shape[0],
            impl=ctx.route_impl,
        )
        return state, assign, RouteStats(
            steered=stats.steered,
            eligible=stats.eligible,
            dV=steering_dv(ctx, assign),
        )

    def route_tick(self, state: MidasState, ctx):
        """The tick's G waves in one launch of the ``route_tick`` kernel:
        route_select's test, the pins, the leaky bucket and the history
        ring of :func:`route_midas` for every wave in order, and the
        waves' dV summed as :func:`steering_dv` sums each wave.  A (G, m)
        ``ctx.L_view`` is fleet routing's per-wave views: wave g routes
        on row g alone, with no sends shared within the tick."""
        k = ctx.knobs
        assign, _, arrivals, steered, eligible, dv, hist_idx = (
            route_ops.route_tick(
                ctx.keys, ctx.mask, ctx.feas, ctx.draws.rank,
                ctx.draws.tie, ctx.L_view, ctx.p50_view, state.pin_server,
                state.pin_expiry, state.steer_hist, state.elig_hist,
                state.hist_idx, d=k.d, delta_l=k.delta_l,
                delta_t=k.delta_t, f_max=k.f_max, pin_ms=k.pin_ms,
                now_ms=ctx.now_ms, mode="midas",
            ))
        stats = RouteStats(steered=steered, eligible=eligible, dV=dv)
        return state._replace(hist_idx=hist_idx), TickRoute(
            assign=assign, arrivals=arrivals, stats=stats)
