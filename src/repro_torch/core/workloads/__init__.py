"""Pluggable workload registry + combinators (PyTorch port).

``make_workload(name, ...)`` resolves through the registry; unknown
names raise a ``ValueError`` listing every alternative.  The modules,
as in the reference package:

``base``         Workload grid, WorkloadSpec protocol, params, registry
``fig2``         the paper's seven Fig. 2 generators
``combinators``  mix / concat / scale_rate / shift_hotset on realized grids
``scenarios``    job_startup, rename_storm, flash_crowd, multi_tenant
``trace``        trace replay from recorded (t_ms, key, is_write) ``.npz``
``adversary``    parametric controller-adversarial burst trains
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
from repro_torch.core.workloads.combinators import (
    concat,
    mix,
    scale_rate,
    shift_hotset,
)

# Built-in generators and scenarios self-register on import.
from repro_torch.core.workloads.adversary import (  # noqa: E402
    AdversaryParams,
    perturb,
    random_params,
    save_trace,
    to_events,
)
from repro_torch.core.workloads.fig2 import WORKLOADS  # noqa: E402
from repro_torch.core.workloads.scenarios import SCENARIOS  # noqa: E402
from repro_torch.core.workloads.trace import (  # noqa: E402
    load_trace,
    rebucket,
)

__all__ = [
    "AdversaryParams",
    "SCENARIOS",
    "WORKLOADS",
    "Workload",
    "WorkloadParams",
    "WorkloadSpec",
    "assemble",
    "available",
    "concat",
    "get_class",
    "hot_subset_keys",
    "load_trace",
    "make_workload",
    "mix",
    "perturb",
    "random_params",
    "rebucket",
    "register",
    "sample_keys",
    "save_trace",
    "scale_rate",
    "shift_hotset",
    "to_events",
    "unregister",
    "zipf_cdf",
]
