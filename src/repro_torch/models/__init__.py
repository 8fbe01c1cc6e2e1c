"""Model substrate of the port: the dense attention, MoE, pure-SSM
and hybrid families (see ``model.py`` for what the port covers)."""

from repro_torch.models.model import (  # noqa: F401
    Model,
    block_pattern,
    decode_step,
    forward,
    init_decode_cache,
    init_moe_state,
    init_params,
    loss_fn,
    num_blocks,
    prefill,
    remat_context,
)
