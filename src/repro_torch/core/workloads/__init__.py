"""Pluggable workload registry (PyTorch port).

``make_workload(name, ...)`` resolves through the registry; unknown
names raise a ``ValueError`` listing every alternative.  The port
carries the paper's seven Fig. 2 generators (:mod:`.fig2`).
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
from repro_torch.core.workloads.fig2 import WORKLOADS  # noqa: E402

__all__ = [
    "WORKLOADS",
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
