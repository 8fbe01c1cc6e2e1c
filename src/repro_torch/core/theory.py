"""Closed-form results the paper leans on (§V) and a fast simulator to
check them: the counterpart of ``repro/core/theory.py``.

* Balls-into-bins: uniform placement of n = m balls has a max load about
  ln m / ln ln m above the mean; power-of-d about ln ln m / ln d + O(1)
  (Azar et al.; Mitzenmacher).
* M/M/1: E[T] = 1/(μ − λ) for λ < μ.

:func:`balls_into_bins` draws with the port's bitwise threefry, so a
key gives the reference's loads bit for bit; the reference's ``vmap``
over trials is a leading trial axis of the keys here.  The simulator
runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.xla import div, reduce_sum
from repro_torch.kernels.common import resolve_device


def uniform_maxload_gap_theory(m: int) -> float:
    """Expected max-above-mean for n=m balls, uniform: ≈ ln m / ln ln m."""
    lm = math.log(m)
    return lm / math.log(lm) if lm > 1 else 1.0


def power_of_d_maxload_gap_theory(m: int, d: int) -> float:
    """≈ ln ln m / ln d + O(1)."""
    lm = math.log(max(m, 3))
    return math.log(max(lm, math.e)) / math.log(d)


def mm1_latency(lam: float, mu: float) -> float:
    """E[T] = 1/(μ−λ), λ<μ (paper §V-B)."""
    if lam >= mu:
        return float("inf")
    return 1.0 / (mu - lam)


def balls_into_bins(key: torch.Tensor, n_balls: int, m: int,
                    d: int) -> torch.Tensor:
    """Sequential balls-into-bins with d choices: the final float32
    loads (..., m) for ``key`` (..., 2), on the key's device.

    Ball i draws its d candidates (``randint`` over the m bins) and tie
    scores (``uniform(fold_in(k_i, 1)) * 1e-3``) from the i-th key of
    ``split(key, n_balls)`` and lands on the first candidate whose load
    plus tie is least.  The draws do not depend on the loads, so every
    ball's are made at once; the placement is the loop over balls."""
    keys = prng.split(key, n_balls)  # (..., n_balls, 2)
    cand = prng.randint(keys, (d,), 0, m).long()  # (..., n_balls, d)
    tie = prng.uniform(prng.fold_in(keys, 1), (d,)) * 1e-3
    loads = torch.zeros(key.shape[:-1] + (m,), dtype=torch.float32,
                        device=key.device)
    one = torch.ones(key.shape[:-1] + (1,), dtype=torch.float32,
                     device=key.device)
    for i in range(n_balls):
        c = cand[..., i, :]
        j = torch.argmin(loads.gather(-1, c) + tie[..., i, :], dim=-1,
                         keepdim=True)  # the first least, as jnp.argmin
        loads.scatter_add_(-1, c.gather(-1, j), one)
    return loads


def maxload_gap_empirical(n_balls: int, m: int, d: int, trials: int = 20,
                          seed: int = 0, device=None) -> Tuple[float, float]:
    """(mean gap above average load, std) across trials, the trials
    run side by side on ``device`` (the card when None).  The mean and
    the std take XLA's sum order and roundings (``jnp.mean``,
    ``jnp.std``: the squares fused into the adds up to 32 trials), with
    a correctly rounded float32 sqrt, as the reference's eager calls
    compute them."""
    dev = resolve_device(device)
    keys = prng.split(prng.PRNGKey(seed, dev), trials)
    loads = balls_into_bins(keys, n_balls, m, d)
    gaps = loads.amax(dim=-1) - float(np.float32(n_balls / m))
    # jnp.mean's division becomes a multiply by the reciprocal; jnp.var
    # divides
    mean = reduce_sum(gaps) * float(np.float32(1.0 / trials))
    var = div(reduce_sum(gaps - mean, squares=True), float(trials))
    std = torch.sqrt(var.double()).float()
    return float(mean), float(std)
