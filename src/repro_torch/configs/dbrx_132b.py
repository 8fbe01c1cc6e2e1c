"""DBRX-132B — fine-grained MoE, 16 experts top-4, GQA (kv=8).
[hf:databricks/dbrx-base; unverified]

MIDAS integration: expert dispatch uses the paper's power-of-d routing over
the top-d gate candidates with capacity-aware steering (router="midas").
"""
from repro_torch.config import ArchConfig, MoEConfig, register_arch

FULL = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,                   # per-expert ffn hidden
    vocab_size=100352,
    head_dim=128,
    rope_theta=500000.0,
    norm="layernorm",
    act="silu",
    moe=MoEConfig(num_experts=16, experts_per_token=4, d_ff_expert=10752,
                  router="midas", midas_d=2),
    notes="long_500k skipped: pure full attention (quadratic).",
)

SMOKE = ArchConfig(
    name="dbrx-132b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    norm="layernorm",
    act="silu",
    moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff_expert=128,
                  router="midas", midas_d=2),
)

register_arch(FULL, SMOKE)
