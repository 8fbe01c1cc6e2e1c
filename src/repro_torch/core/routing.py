"""Compatibility shim: routing policies live in ``repro_torch.core.policies``.

The counterpart of ``repro/core/routing.py``, with the same names.  Each
policy is a self-contained registered module (see
``repro_torch/core/policies/__init__.py``); the functional routers
(``route_*``) and the per-policy state containers are re-exported here
unchanged: ``MidasState`` / ``init_midas`` (pins and the leaky bucket)
and ``RRState`` / ``init_rr`` (per-proxy counters).  The port's routers
take a wave's pre-made draws where the reference's take a PRNG key (the
engine makes every draw of a horizon at once; see
``repro_torch/core/policies/base.py``).  New code should import from the
policy modules directly.
"""

from __future__ import annotations

from repro_torch.core.policies.base import (  # noqa: F401
    RouteStats,
    sample_candidates,
    steering_dv,
)
from repro_torch.core.policies.bounded_load import (  # noqa: F401
    route_bounded_load,
)
from repro_torch.core.policies.jsq import route_jsq  # noqa: F401
from repro_torch.core.policies.midas import (  # noqa: F401
    MidasState,
    MidasTickStats,
    init_midas,
    route_midas,
)
from repro_torch.core.policies.power_of_d import (  # noqa: F401
    route_power_of_d,
)
from repro_torch.core.policies.round_robin import (  # noqa: F401
    RRState,
    init_rr,
    route_round_robin,
    route_rr_per_request,
)
from repro_torch.core.policies.static_hash import route_hash  # noqa: F401
from repro_torch.core.policies.uniform import route_uniform  # noqa: F401
