"""Telemetry: EWMA smoothing, the latency sketch, imbalance.

Proxies observe *server-reported* telemetry -- in-flight queue length
and recent latency quantiles -- with at most one fast interval of delay
(paper §IV-E assumption 1).  :class:`LatencySketch` is a per-server
ring buffer of recent latency observations; quantiles are computed over
the valid window.  :func:`ewma_series` and :func:`weighted_quantiles`
are host-side numpy, shared with the warmup pass and ``SimResult``.

The device functions never read a value back to the host, so the
engine can call them every tick without a synchronisation.
:class:`HistSketch` is the streaming histogram of the summary metrics
(``metrics="summary"``): O(HIST_BINS) on the device however many
samples stream through, read on the host by :func:`hist_quantile`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.xla import fma, reduce_sum
from repro_torch.kernels.common import resolve_device


def ewma(prev: torch.Tensor, x: torch.Tensor, alpha: float) -> torch.Tensor:
    """x̂_t = (1-α)·x̂_{t-1} + α·x_t  (paper eq., α=0.2 fast loop), with
    the multiply-add fused as the reference engine computes it."""
    return fma(1.0 - alpha, prev, alpha * x)


def ewma_series(
    x: np.ndarray, alpha: float, block: int = 512, init: float = 0.0
) -> np.ndarray:
    """EWMA-smooth a (T, ...) series along axis 0 (host-side, float64).

    Closed form per block: with decay ρ = 1-α and p_t = ρ^(t+1),
    x̂_t = p_t · (x̂_init + Σ_{j≤t} α·x_j / p_j), so one cumsum replaces
    the per-step recurrence.  Blocks bound the rescaling's dynamic range
    to ρ^(-block), and the block is shortened so ρ^block stays above the
    float64 underflow floor.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 0 or x.shape[0] == 0:
        return x.copy()
    rho = 1.0 - alpha
    if rho <= 0.0:
        return alpha * x
    block = min(block, max(int(-575.0 / np.log(rho)), 1))
    out = np.empty_like(x)
    acc = np.full(x.shape[1:], float(init), np.float64)
    for s in range(0, x.shape[0], block):
        xb = x[s : s + block]
        n = xb.shape[0]
        p = rho ** np.arange(1, n + 1, dtype=np.float64)
        pb = p.reshape((n,) + (1,) * (x.ndim - 1))
        out[s : s + n] = pb * (acc + np.cumsum(alpha * xb / pb, axis=0))
        acc = out[s + n - 1]
    return out


def staggered_phases(P: int, period_ticks: int, device=None) -> torch.Tensor:
    """(P,) int32 ingest phases spreading P proxies evenly over one fast
    interval.  Independent proxies poll server telemetry on their own
    clocks; staggering is what makes their smoothed views diverge
    (fleet mode, §IV-E assumption 1 per proxy)."""
    p = torch.arange(P, dtype=torch.int32, device=resolve_device(device))
    return (p * period_ticks) // P


def ewma_staggered(
    views: torch.Tensor,
    obs: torch.Tensor,
    tick: int,
    period_ticks: int,
    alpha: float,
) -> torch.Tensor:
    """Update the (P, m) per-proxy EWMA views: proxy p ingests ``obs``
    only on its own staggered phase at (host) tick ``tick``; other views
    keep aging."""
    P = views.shape[0]
    phases = staggered_phases(P, period_ticks, views.device)
    due = phases == int(tick) % period_ticks
    return torch.where(due[:, None], ewma(views, obs[None, :], alpha), views)


def weighted_quantiles(
    values: np.ndarray, weights: np.ndarray, qs: Sequence[float]
) -> Tuple[float, ...]:
    """Exact weight-CDF quantiles of ``values`` (host-side numpy).

    Sorts by value and returns, for each q, the first value whose
    normalized cumulative weight reaches q/100; the index is clipped
    because fp rounding can leave the final cumulative weight below 1.
    Zero (or negative) total weight returns 0.0 for every q.
    """
    v = np.asarray(values, np.float64).reshape(-1)
    w = np.asarray(weights, np.float64).reshape(-1)
    total = w.sum()
    if total <= 0:
        return tuple(0.0 for _ in qs)
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    cum = np.cumsum(w) / total
    last = v.size - 1
    return tuple(
        float(v[min(int(np.searchsorted(cum, q / 100.0)), last)])
        for q in qs
    )


class LatencySketch(NamedTuple):
    buf: torch.Tensor  # (m, K) float32 latency observations (ms)
    idx: torch.Tensor  # () int32 next write slot (shared across servers)
    count: torch.Tensor  # () int32 total observations so far


def make_sketch(m: int, K: int = 64, device=None) -> LatencySketch:
    """An empty sketch on ``device`` (the card when None)."""
    device = resolve_device(device)
    z = torch.zeros((), dtype=torch.int32, device=device)
    return LatencySketch(
        buf=torch.zeros((m, K), dtype=torch.float32, device=device),
        idx=z,
        count=z,
    )


def sketch_add(sk: LatencySketch, obs: torch.Tensor) -> LatencySketch:
    """Add one observation per server (obs: (m,) ms); writes the ring
    buffer in place."""
    K = sk.buf.shape[1]
    col = (sk.idx % K).long().view(1)
    sk.buf.index_copy_(1, col, obs.view(-1, 1))
    return LatencySketch(buf=sk.buf, idx=sk.idx + 1, count=sk.count + 1)


def sketch_quantiles(
    sk: LatencySketch,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p50, p99) per server over the valid window; zeros when empty."""
    K = sk.buf.shape[1]
    n = torch.clamp(sk.count, max=K)
    valid = torch.arange(K, device=sk.buf.device) < n
    srt = torch.sort(torch.where(valid, sk.buf, torch.inf), dim=1).values
    nn = torch.clamp(n, min=1)
    i50 = torch.clamp((nn - 1) / 2, 0, K - 1)
    i99 = torch.clamp(torch.ceil(0.99 * (nn.float() - 1)), 0, K - 1)

    def take(frac_idx):
        lo = torch.floor(frac_idx).to(torch.int32)
        hi = torch.minimum(lo + 1, nn - 1)
        w = frac_idx - lo
        s_lo = srt.index_select(1, lo.long().view(1))[:, 0]
        s_hi = srt.index_select(1, hi.long().view(1))[:, 0]
        # w is 0 or 1/2 for both quantiles: exact with or without a fma
        return (1 - w) * s_lo + w * s_hi

    p50 = torch.where(n > 0, take(i50.float()), 0.0)
    p99 = torch.where(n > 0, take(i99.float()), 0.0)
    return p50, p99


def imbalance(L_hat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """B(t) = std(L̂)/(mean(L̂)+ε)  -- the paper's smoothed imbalance,
    rounded as the reference's jitted ``imbalance`` on the CPU.

    The sums take XLA's order (:func:`xla.reduce_sum`): mean = sum ·
    (1/m), std = sqrt(sum((x − mean)²) · (1/m)).  Up to m = 32 XLA folds
    each square into its add and rounds the denominator twice (mean,
    then + ε); above 32 it rounds the squares before their windowed sum
    and fuses the denominator into one ``fma(sum, 1/m, ε)``.  Bit for
    bit at every m from 1 to 259 (``tests/test_torch_xla_sums.py``).
    The square root is taken in float64 and rounded once, so it is
    correctly rounded as XLA's is (PyTorch's float32 ``sqrt`` on the CPU
    is not)."""
    m = L_hat.shape[0]
    inv = float(np.float32(1.0 / m))
    total = reduce_sum(L_hat)
    var = reduce_sum(L_hat - total * inv, squares=True) * inv
    sd = torch.sqrt(var.double()).float()
    if m <= 32:
        return sd / (total * inv + eps)
    return sd / fma(total, inv, eps)


def imbalance_masked(
    L_hat: torch.Tensor, live: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """:func:`imbalance` over the detected-live servers only, so that a
    crashed server's frozen queue does not pin B(t) for the whole
    outage.  With every server live it equals the reference's
    ``imbalance_masked`` at all-ones weights (not :func:`imbalance`:
    the live count is divided by, not multiplied by 1/m).

    Rounded as the reference's jitted version on the CPU: XLA turns the
    weight products into selects, sums them in :func:`xla.reduce_sum`'s
    order with every square rounded before its add (at every m, unlike
    :func:`imbalance`), divides by the live count, and takes a
    correctly rounded square root."""
    n = torch.clamp(reduce_sum(live.to(torch.float32)), min=1.0)
    mu = reduce_sum(torch.where(live, L_hat, 0.0)) / n
    dev = L_hat - mu
    var = reduce_sum(torch.where(live, dev * dev, 0.0)) / n
    sd = torch.sqrt(var.double()).float()
    return sd / (mu + eps)


CONSENSUS_REDUCERS = ("mean", "median", "max")


def reduce_views(views_p: torch.Tensor, reducer: str = "mean") -> torch.Tensor:
    """Collapse a (P, m) stack of per-proxy views along the proxy axis,
    as the reference computes it on the CPU: ``mean`` sums the P rows
    in order and multiplies by 1/P; ``median`` interpolates the two
    middle order statistics with one fused multiply-add (jnp.median's
    linear rule); ``max`` is exact."""
    P = views_p.shape[0]
    if reducer == "mean":
        rows = views_p.unbind(0)
        total = rows[0]
        for r in rows[1:]:
            total = total + r
        return total * float(np.float32(1.0 / P))
    if reducer == "median":
        pos = np.float32(0.5) * np.float32(P - 1)
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        w_hi = float(pos - np.float32(lo))
        s = torch.sort(views_p, dim=0).values
        return fma(s[hi], w_hi, s[lo] * float(np.float32(1.0) - w_hi))
    if reducer == "max":
        return views_p.amax(0)
    raise ValueError(
        f"unknown consensus reducer {reducer!r}; available: "
        f"{', '.join(CONSENSUS_REDUCERS)}"
    )


# ---------------------------------------------------------------------------
# Streaming histogram sketch (metrics="summary" accumulator)
# ---------------------------------------------------------------------------

HIST_BINS = 512
HIST_LO = 1e-2
HIST_HI = 1e6


@functools.lru_cache(maxsize=None)
def _hist_edges() -> np.ndarray:
    """Log-spaced bin edges shared by every sketch (host constant,
    float64)."""
    return np.geomspace(HIST_LO, HIST_HI, HIST_BINS + 1)


@functools.lru_cache(maxsize=None)
def _edges_on(device: torch.device) -> torch.Tensor:
    """The edges as the reference's ``jnp.asarray`` holds them: the
    float64 grid rounded to float32, copied to ``device`` once."""
    return torch.from_numpy(_hist_edges().astype(np.float32)).to(device)


class HistSketch(NamedTuple):
    """Streaming weighted histogram over a fixed log-spaced grid.

    ``counts[0]`` is the underflow bin (values below HIST_LO, the exact
    zeros of a queue timeline among them) and ``counts[-1]`` the
    overflow bin (values at or above HIST_HI).  Quantiles are
    bin-resolution approximations (geometric bin midpoints); the exact
    ones are :func:`weighted_quantiles` over a full timeline."""

    counts: torch.Tensor  # (HIST_BINS + 2,) float32 weighted bin counts


def make_hist(device=None) -> HistSketch:
    """An empty sketch on ``device`` (the card when None)."""
    return HistSketch(counts=torch.zeros(
        (HIST_BINS + 2,), dtype=torch.float32,
        device=resolve_device(device)))


def hist_add(
    sk: HistSketch, values: torch.Tensor, weights: torch.Tensor
) -> HistSketch:
    """Add ``weights`` at the bins of ``values`` (any shape).

    The bin is the reference's ``searchsorted(edges, v, side="right")``:
    the edges increase strictly, so the upper bound
    ``torch.searchsorted(..., right=True)`` finds the same bin as jnp's
    fixed-step bisection.  The scatter is ``index_add`` with atomics on
    the card, so the order of the adds varies; the engine's weights are
    ones (queue samples) and arrival counts, so every partial sum is an
    integer below 2**24 and exact in any order."""
    b = torch.searchsorted(_edges_on(values.device), values.reshape(-1),
                           right=True)
    counts = sk.counts.index_add(0, b, weights.reshape(-1).float())
    return HistSketch(counts=counts)


def hist_quantile(counts: np.ndarray, q: float) -> float:
    """Approximate weight-CDF quantile from sketch counts (host-side):
    the geometric midpoint of the first bin whose cumulative weight
    reaches q/100.  Zero total weight returns 0.0."""
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    if total <= 0:
        return 0.0
    edges = _hist_edges()
    reps = np.concatenate(
        ([0.0], np.sqrt(edges[:-1] * edges[1:]), [edges[-1]])
    )
    cum = np.cumsum(counts)
    idx = int(np.searchsorted(cum, (q / 100.0) * total))
    return float(reps[min(idx, reps.size - 1)])
