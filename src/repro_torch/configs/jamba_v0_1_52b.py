"""Jamba-v0.1-52B — hybrid Mamba+attention (1:7 interleave), MoE 16e top-2
every other layer. [arXiv:2403.19887; hf]

Sub-quadratic (attention only every 8th layer) -> long_500k applies.
"""
from repro_torch.config import (
    ArchConfig,
    MambaConfig,
    MoEConfig,
    register_arch,
)

FULL = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(num_experts=16, experts_per_token=2, d_ff_expert=14336,
                  router="midas", midas_d=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    attn_every=8,                 # 1 attention layer per 8 (1:7 attn:mamba)
    moe_every=2,                  # MoE FFN every other layer
    applicable_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ArchConfig(
    name="jamba-v0.1-52b-smoke",
    family="hybrid",
    num_layers=8,                 # one full attn_every period
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff_expert=128,
                  router="midas", midas_d=2),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
    attn_every=8,
    moe_every=2,
    applicable_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

register_arch(FULL, SMOKE)
