"""Pluggable workload registry (PyTorch port).

``make_workload(name, ...)`` resolves through the registry; unknown
names raise a ``ValueError`` listing every alternative.  The port
carries ``light`` and ``bursty`` (:mod:`.fig2`).
"""

from repro_torch.core.workloads.base import (
    Workload,
    WorkloadParams,
    WorkloadSpec,
    assemble,
    available,
    get_class,
    hot_subset_keys,
    make_workload,
    register,
    sample_keys,
    unregister,
    zipf_cdf,
)

# Built-in generators self-register on import.
from repro_torch.core.workloads import fig2  # noqa: F401, E402

__all__ = [
    "Workload",
    "WorkloadParams",
    "WorkloadSpec",
    "assemble",
    "available",
    "get_class",
    "hot_subset_keys",
    "make_workload",
    "register",
    "sample_keys",
    "unregister",
    "zipf_cdf",
]
