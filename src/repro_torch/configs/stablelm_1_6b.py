"""StableLM-2-1.6B — dense, MHA (kv=32), LayerNorm, SiLU-gated MLP.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.config import ArchConfig, register_arch

FULL = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    head_dim=64,
    rope_theta=10000.0,
    norm="layernorm",
    act="silu",
    qkv_bias=True,
    notes="long_500k skipped: pure full attention (quadratic).",
)

SMOKE = ArchConfig(
    name="stablelm-1.6b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=176,
    vocab_size=256,
    head_dim=16,
    norm="layernorm",
    act="silu",
    qkv_bias=True,
)

register_arch(FULL, SMOKE)
