"""LLaVA-NeXT (Mistral-7B backbone) — VLM with anyres tiling.
Backbone only per spec: the vision tower is a stub; ``input_specs()``
supplies precomputed patch embeddings prepended to the token stream.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.config import ArchConfig, register_arch

FULL = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1000000.0,
    norm="rmsnorm",
    act="silu",
    frontend="vlm_patches",
    frontend_tokens=576,          # 24x24 CLIP-ViT-L/14 base-tile patches
    notes="long_500k skipped: pure full attention (quadratic).",
)

SMOKE = ArchConfig(
    name="llava-next-mistral-7b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    norm="rmsnorm",
    act="silu",
    frontend="vlm_patches",
    frontend_tokens=16,
)

register_arch(FULL, SMOKE)
