"""Pluggable routing-policy registry (PyTorch port).

``SimConfig.policy`` resolves through this registry: ``midas`` (the
main path), ``hash`` (the warmup pass), and the paper's baselines
``power_of_d``, ``round_robin``, ``rr_request``, ``uniform``, ``jsq``
and ``chbl``.  Unknown names raise a ``ValueError`` listing what is
registered.
"""

from repro_torch.core.policies.base import (
    Policy,
    RouteContext,
    RouteStats,
    WaveDraws,
    available,
    get,
    get_class,
    register,
    sample_candidates,
    sample_ranks,
    slice_draws,
    steering_dv,
    unregister,
)

# Built-in policies self-register on import.
from repro_torch.core.policies import (  # noqa: F401, E402
    bounded_load,
    jsq,
    midas,
    power_of_d,
    round_robin,
    static_hash,
    uniform,
)

__all__ = [
    "Policy",
    "RouteContext",
    "RouteStats",
    "WaveDraws",
    "available",
    "get",
    "get_class",
    "register",
    "sample_candidates",
    "sample_ranks",
    "slice_draws",
    "steering_dv",
    "unregister",
]
