"""Gemma2-2B — dense, GQA (kv=4), alternating local/global attention,
logit softcapping, tied embeddings. [arXiv:2408.00118; hf]"""
from repro_torch.config import ArchConfig, register_arch

FULL = ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,                 # gemma2 decouples head_dim from d_model
    rope_theta=10000.0,
    window_size=4096,             # local layers use 4k sliding window
    alt_local_global=True,
    logit_softcap=50.0,           # attention logit softcap
    final_softcap=30.0,           # final LM-head logit softcap
    tie_embeddings=True,
    norm="rmsnorm",
    act="gelu",                   # GeGLU
    notes=("long_500k skipped: alternating stack still contains global "
           "full-attention layers (not sub-quadratic)."),
)

SMOKE = ArchConfig(
    name="gemma2-2b-smoke",
    family="dense",
    num_layers=4,                 # keep even so local/global alternation shows
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=256,
    head_dim=32,
    window_size=16,
    alt_local_global=True,
    logit_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    norm="rmsnorm",
    act="gelu",
)

register_arch(FULL, SMOKE)
