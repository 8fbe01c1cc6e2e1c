"""Falcon-Mamba-7B — pure Mamba-1 (attention-free SSM), 64 layers.
[arXiv:2410.05355; unverified]

Attention-free -> O(1) decode state, sub-quadratic -> long_500k applies.
"""
from repro_torch.config import ArchConfig, MambaConfig, register_arch

FULL = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,                  # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                       # no FFN: mamba block is the whole layer
    vocab_size=65024,
    norm="rmsnorm",
    act="silu",
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    applicable_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ArchConfig(
    name="falcon-mamba-7b-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=256,
    norm="rmsnorm",
    act="silu",
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
    applicable_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

register_arch(FULL, SMOKE)
