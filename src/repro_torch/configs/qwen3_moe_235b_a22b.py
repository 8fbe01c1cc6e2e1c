"""Qwen3-MoE-235B-A22B — 128 experts top-8, GQA (kv=4), 94 layers.
[hf:Qwen/Qwen3-30B-A3B; hf]

The 128-expert regime is where the paper's balls-into-bins analysis bites:
max-load gap ln(ln 128)/ln d. router="midas" applies power-of-d dispatch.
"""
from repro_torch.config import ArchConfig, MoEConfig, register_arch

FULL = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,                    # per-expert ffn hidden (fine-grained)
    vocab_size=151936,
    head_dim=128,
    rope_theta=1000000.0,
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(num_experts=128, experts_per_token=8, d_ff_expert=1536,
                  router="midas", midas_d=2),
    notes="long_500k skipped: pure full attention (quadratic).",
)

SMOKE = ArchConfig(
    name="qwen3-moe-235b-a22b-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    head_dim=16,
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=64,
                  router="midas", midas_d=2),
)

register_arch(FULL, SMOKE)
