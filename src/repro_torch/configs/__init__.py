"""Architecture configs (one module per assigned architecture).

Importing this package registers every architecture into
``repro_torch.config.ARCH_REGISTRY`` (full config) and the smoke registry
(reduced config of the same family, used by CPU smoke tests).
"""
from repro_torch.configs import (  # noqa: F401
    starcoder2_3b,
    gemma2_2b,
    stablelm_1_6b,
    smollm_360m,
    musicgen_large,
    dbrx_132b,
    qwen3_moe_235b_a22b,
    jamba_v0_1_52b,
    llava_next_mistral_7b,
    falcon_mamba_7b,
)
