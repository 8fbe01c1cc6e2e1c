# The fault registry: typed fault events compiled on the host into
# time-indexed schedules that the engine uploads once per run, and that
# cost nothing when no event fires.  See base.py for the schema and
# events.py for the built-in vocabulary.
from repro_torch.core.faults import events  # noqa: F401  (registration)
from repro_torch.core.faults.base import (  # noqa: F401
    AVAIL_FULL,
    DETECT_TIMEOUT_MS,
    STORM_LANES,
    CompiledFaults,
    FaultEvent,
    FaultSpec,
    FaultTickInfo,
    FaultXs,
    Schedule,
    apply_traffic,
    available,
    compile_faults,
    detect_available,
    detect_ticks,
    feasible_by_epoch,
    get,
    get_class,
    make_xs,
    moved_mask,
    normalize,
    parse_fault,
    register,
    tick_info,
    unregister,
    validate_events,
)
from repro_torch.core.faults.events import storm_from_pool  # noqa: F401
from repro_torch.core.faults.programs import (  # noqa: F401
    CascadeEvent,
    detection_tick,
    overlap,
    resolve,
    rolling,
    sequence,
)
