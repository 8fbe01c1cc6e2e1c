"""Pluggable routing-policy registry (PyTorch port).

``SimConfig.policy`` resolves through this registry.  The port carries
``midas`` (the main path), ``power_of_d`` and ``hash`` (the warmup
pass); ``chbl``, ``jsq``, ``round_robin``, ``rr_request`` and
``uniform`` come later (ROADMAP §1 item 5).  Unknown names raise a
``ValueError`` listing what is registered.
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
    steering_dv,
    unregister,
)

# Built-in policies self-register on import.
from repro_torch.core.policies import (  # noqa: F401, E402
    midas,
    power_of_d,
    static_hash,
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
    "steering_dv",
    "unregister",
]
