"""Model substrate of the port: dense attention and pure-SSM families
(see ``model.py`` for what this slice covers)."""

from repro_torch.models.model import (  # noqa: F401
    Model,
    block_pattern,
    decode_step,
    forward,
    init_decode_cache,
    init_params,
    num_blocks,
    prefill,
)
