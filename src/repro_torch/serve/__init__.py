from repro_torch.serve.router import MidasRouter  # noqa: F401
from repro_torch.serve.step import (  # noqa: F401
    make_prefill_step,
    make_serve_step,
)
