"""MusicGen-Large — decoder-only transformer over EnCodec tokens.
Backbone only; the EnCodec frontend is a stub providing precomputed frame
embeddings per spec. [arXiv:2306.05284; hf]"""
from repro_torch.config import ArchConfig, register_arch

FULL = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,              # EnCodec codebook size
    head_dim=64,
    norm="layernorm",
    act="gelu_plain",
    frontend="audio_frames",
    notes="long_500k skipped: pure full attention (quadratic).",
)

SMOKE = ArchConfig(
    name="musicgen-large-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=128,
    head_dim=16,
    norm="layernorm",
    act="gelu_plain",
    frontend="audio_frames",
)

register_arch(FULL, SMOKE)
