"""Workload spec protocol, build parameters, and the workload registry.

A *workload* is the traffic side of the MIDAS evaluation: a ``(T, R)``
grid of request keys with a validity mask and a write flag.  Keys index
a namespace of ``N`` objects; the key→server map comes from the
consistent-hash ring, so key skew creates server hotspots.

Random draws: every draw but one goes through the port's threefry
(:mod:`repro_torch.core.prng`), and the Zipf tables, their search and
the rate curves are rounded and taken as the reference takes them on
the CPU (:mod:`repro_torch.core.xla`), so keys, write flags and burst
phases equal the reference's bit for bit at a given mask.  The
exception is the per-tick arrival count: the reference draws it with
``jax.random.poisson``, which is not reproduced; here it is
``torch.poisson`` with a ``torch.Generator`` seeded from the workload
seed, on the CPU, so the counts do not depend on the device.  Engine parity tests therefore feed
the reference's realized grids to the port
(:func:`repro_torch.convert.workload_from_numpy`).

Rates are fractions of aggregate service capacity
``cap = m * dt_ms / service_ms`` requests per tick.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Tuple, Type

import torch

from repro_torch.core import prng, xla
from repro_torch.core import registry as registry_lib
from repro_torch.core.hashring import hash2
from repro_torch.kernels.common import resolve_device


class Workload(NamedTuple):
    """A realized traffic grid; what ``simulate`` consumes."""

    keys: torch.Tensor      # (T, R) int32 in [0, N)
    mask: torch.Tensor      # (T, R) bool
    is_write: torch.Tensor  # (T, R) bool (metadata-mutating ops)
    name: str
    N: int


@dataclasses.dataclass(frozen=True)
class WorkloadParams:
    """Grid shape + capacity context handed to ``WorkloadSpec.build``."""

    T: int
    m: int
    seed: int = 0
    dt_ms: float = 50.0
    service_ms: float = 100.0
    N: int = 4096
    R: int = 0
    write_frac: float = 0.05
    device: torch.device = torch.device("cpu")

    @property
    def cap(self) -> float:
        """Aggregate service capacity in requests per tick."""
        return self.m * self.dt_ms / self.service_ms

    @property
    def sec(self) -> torch.Tensor:
        """(T,) float32 wall-clock seconds at each tick (on the CPU)."""
        t = torch.arange(self.T, dtype=torch.float32)
        return t * self.dt_ms / 1000.0

    @property
    def rng(self) -> torch.Tensor:
        return prng.PRNGKey(self.seed, self.device)

    def make(self, name: str, **overrides) -> Workload:
        """Build another registered workload under these params -- the
        composition hook scenarios use.  ``R`` and the device are passed
        through, so component grids always align."""
        kw: Dict[str, Any] = dict(
            T=self.T,
            m=self.m,
            seed=self.seed,
            dt_ms=self.dt_ms,
            service_ms=self.service_ms,
            N=self.N,
            R=self.R,
            write_frac=self.write_frac,
            device=self.device,
        )
        kw.update(overrides)
        return make_workload(name, **kw)


class WorkloadSpec:
    """Base class for registered workload generators."""

    name: str = "?"

    def build(self, p: WorkloadParams) -> Workload:
        raise NotImplementedError


REGISTRY = registry_lib.Registry("workload")


def register(name: str):
    """Class decorator adding a WorkloadSpec subclass under ``name``."""
    return REGISTRY.register(name)


def unregister(name: str) -> None:
    REGISTRY.unregister(name)


def available() -> Tuple[str, ...]:
    return REGISTRY.available()


def get_class(name: str) -> Type[WorkloadSpec]:
    return REGISTRY.get_class(name)


def make_workload(
    name: str,
    *,
    T: int,
    m: int,
    seed: int = 0,
    dt_ms: float = 50.0,
    service_ms: float = 100.0,
    N: int = 4096,
    R: int = 0,
    write_frac: float = 0.05,
    device=None,
    **spec_kw,
) -> Workload:
    """Resolve ``name`` through the registry and build its grid on
    ``device`` (the CUDA device unless the caller asks for the CPU).

    ``R`` defaults to ``4 * cap + 8`` slots per tick.
    """
    cls = get_class(name)
    cap = m * dt_ms / service_ms
    p = WorkloadParams(
        T=T,
        m=m,
        seed=seed,
        dt_ms=dt_ms,
        service_ms=service_ms,
        N=N,
        R=R or int(4 * cap) + 8,
        write_frac=write_frac,
        device=resolve_device(device),
    )
    wl = cls(**spec_kw).build(p)
    return wl._replace(name=name)


# ---------------------------------------------------------------------------
# Shared samplers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _zipf_cdf(N: int, alpha: float) -> torch.Tensor:
    ranks = torch.arange(1, N + 1, dtype=torch.float32)
    w = xla.libm("powf", ranks, -alpha)
    return xla.cumsum(w) / xla.reduce_sum(w)


def zipf_cdf(N: int, alpha: float, device=None) -> torch.Tensor:
    """Zipf(alpha) CDF over N ranks in float32, computed on the CPU as
    the reference computes it there (the C library's ``powf``, XLA's
    orders of the cumulative sum and the sum, bit for bit), so the keys
    drawn from it do not depend on the device; then moved to ``device``
    (the card when None)."""
    return _zipf_cdf(N, float(alpha)).to(resolve_device(device))


def sample_keys(key, shape, N: int, alpha: float, perm_salt: int = 3):
    """Zipf(alpha) keys (alpha=0 → uniform), rank→id decorrelated by
    hashing so hot keys land on "random" servers."""
    if alpha <= 0.0:
        return prng.randint(key, shape, 0, N)
    cdf = zipf_cdf(N, alpha, key.device)
    ranks = xla.searchsorted(cdf, prng.uniform(key, shape))
    return (hash2(ranks, perm_salt) % N).to(torch.int32)


def hot_subset_keys(
    key,
    shape,
    epoch_idx: torch.Tensor,
    N: int,
    *,
    subset: int,
    alpha: float,
    salt: int,
) -> torch.Tensor:
    """Zipf(alpha) keys over a small hot subset that rotates per epoch
    (each burst is a different job hitting different directories)."""
    cdf = zipf_cdf(subset, alpha, key.device)
    ranks = xla.searchsorted(cdf, prng.uniform(key, shape))
    epochs = epoch_idx[:, None].to(torch.int64)
    mixed = hash2((ranks + subset * epochs) & prng.MASK, salt)
    return (mixed % N).to(torch.int32)


def assemble(
    key,
    rate_per_tick: torch.Tensor,
    R: int,
    N: int,
    alpha: float,
    write_frac: float,
    name: str,
    hot_subset: int = 0,
    *,
    seed: int = 0,
) -> Workload:
    """Poisson arrivals at rate_per_tick (torch's generator, seeded with
    ``seed``); keys zipf(alpha), optionally over a hot subset."""
    T = rate_per_tick.shape[0]
    _, k2, k3 = prng.split(key, 3).unbind(0)
    gen = torch.Generator().manual_seed(seed)
    counts = torch.poisson(rate_per_tick.cpu(), generator=gen)
    counts = torch.clamp(counts.to(torch.int32), max=R).to(key.device)
    mask = torch.arange(R, device=key.device)[None, :] < counts[:, None]
    keys = sample_keys(k2, (T, R), hot_subset or N, alpha)
    is_write = prng.uniform(k3, (T, R)) < write_frac
    return Workload(
        keys=keys, mask=mask, is_write=is_write & mask, name=name, N=N
    )
