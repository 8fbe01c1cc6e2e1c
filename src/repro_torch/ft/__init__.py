"""The training port's failure detection and elastic plans
(``repro/ft``)."""

from repro_torch.ft.failures import (  # noqa: F401
    FailureDetector,
    HostState,
    elastic_plan,
)
