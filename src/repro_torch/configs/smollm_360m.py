"""SmolLM-360M — llama-arch small dense, GQA (kv=5).
[hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.config import ArchConfig, register_arch

FULL = ArchConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    rope_theta=10000.0,
    tie_embeddings=True,
    norm="rmsnorm",
    act="silu",
    notes="long_500k skipped: pure full attention (quadratic).",
)

SMOKE = ArchConfig(
    name="smollm-360m-smoke",
    family="dense",
    num_layers=3,
    d_model=60,
    num_heads=3,
    num_kv_heads=1,
    d_ff=160,
    vocab_size=256,
    head_dim=20,
    tie_embeddings=True,
    norm="rmsnorm",
    act="silu",
)

register_arch(FULL, SMOKE)
