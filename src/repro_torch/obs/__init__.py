# Flight-recorder observability plane, host-side only, so the engine's
# results are the same bit for bit with recording on or off:
#
# * ``repro_torch.obs.trace``   -- spans around the engine's warmup,
#   execute and host phases, as a JSONL event log and a Chrome-trace
#   export (the reference's schema, so the reference's ``repro-report``
#   reads the port's traces);
# * ``repro_torch.obs.windows`` -- the warmup/stable/cooldown windowing
#   contract the E-series runners share.
from repro_torch.obs import trace, windows  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    RECORDER,
    Recorder,
    configure,
    instant,
    span,
)
from repro_torch.obs.windows import (  # noqa: F401
    Window,
    cell_block,
    detect,
    q_mean_series,
)
