"""StarCoder2-3B — dense decoder, GQA (kv=2), RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.config import ArchConfig, register_arch

FULL = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    rope_theta=999999.0,          # starcoder2 long-context rope base
    norm="layernorm",
    act="gelu_plain",             # 4x non-gated MLP
    qkv_bias=True,
    notes="long_500k skipped: pure full attention (quadratic).",
)

SMOKE = ArchConfig(
    name="starcoder2-3b-smoke",
    family="dense",
    num_layers=2,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    d_ff=384,
    vocab_size=256,
    head_dim=16,
    rope_theta=999999.0,
    norm="layernorm",
    act="gelu_plain",
    qkv_bias=True,
)

register_arch(FULL, SMOKE)
