# The paper's primary contribution, ported to PyTorch: namespace-aware
# power-of-d routing over consistent hashing (policies), the cooperative
# cache with leases and adaptive TTLs (middleware), and the
# self-stabilizing control loop (controllers), driven by the
# queue-network simulator (sim); fault events compile into per-tick
# schedules through the fault registry (faults); grids of runs are
# declared and executed by the sweep engine (sweep).  See
# repro_torch/__init__.py.
from repro_torch.core import (cache, control, controllers,  # noqa: F401
                              faults, fleet, hashring, middleware,
                              policies, prng, registry, sim, sweep,
                              telemetry, workloads)
from repro_torch.core.faults import FaultEvent  # noqa: F401
from repro_torch.core.sim import (SimConfig, SimResult,  # noqa: F401
                                  SummaryResult, simulate, simulate_sweep,
                                  summarize)
from repro_torch.core.sweep import (SweepResult, SweepSpec,  # noqa: F401
                                    run_sweep)
from repro_torch.core.workloads import (WORKLOADS,  # noqa: F401
                                        make_workload)
