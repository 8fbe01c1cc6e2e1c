"""Config system: architectures, shapes, meshes, run options.

A plain-Python copy of ``repro/config.py``, so the port and the
reference know the same architectures by the same names.  Everything is
a frozen dataclass, so configs are hashable and safely shareable.
Architectures register themselves into ``ARCH_REGISTRY`` via
:func:`register_arch`; input shapes are global and paired per-arch
through ``applicable_shapes``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    experts_per_token: int = 0          # top-k
    d_ff_expert: int = 0                # per-expert hidden dim
    router: str = "topk"                # "topk" | "midas"
    capacity_factor: float = 1.25
    # MIDAS dispatch knobs (paper Alg. 1 adapted to expert dispatch)
    midas_d: int = 2            # power-of-d sample among top-d gate
                                # candidates
    midas_delta_l: int = 2              # queue margin (Lyapunov-stable >= 2)
    midas_fmax: float = 0.25            # steering cap (fraction of tokens)
    midas_ewma_alpha: float = 0.2       # EWMA on per-expert load telemetry


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                     # d_inner = expand * d_model
    dt_rank: int = 0                    # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    # attention flavor
    rope_theta: float = 10000.0
    window_size: int = 0                # 0 = global; >0 = sliding window
    alt_local_global: bool = False      # gemma2: alternate local/global layers
    logit_softcap: float = 0.0          # gemma2 attn/final softcap
    final_softcap: float = 0.0
    tie_embeddings: bool = False
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    act: str = "silu"           # silu (gated) | gelu (gated) | gelu_plain
    qkv_bias: bool = False
    # MoE / hybrid / ssm
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    attn_every: int = 1         # jamba: 1 attn layer per `attn_every`
    moe_every: int = 1          # jamba: MoE layer every `moe_every`
    # modality frontend stub
    frontend: str = "none"              # none | audio_frames | vlm_patches
    frontend_tokens: int = 0    # extra prepended embedding tokens (vlm)
    # which shapes apply (long_500k only for sub-quadratic archs)
    applicable_shapes: Tuple[str, ...] = (
        "train_4k", "prefill_32k", "decode_32k")
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        attn = (d * self.num_heads * hd  # q
                + 2 * d * self.num_kv_heads * hd  # k,v
                + self.num_heads * hd * d)  # o
        total = emb + head
        for i in range(L):
            kind, is_moe = self.layer_kind(i)
            total += 2 * d  # norms
            if kind == "attn":
                total += attn
            else:  # mamba
                m = self.mamba
                d_in = m.expand * d
                dt_rank = m.dt_rank or -(-d // 16)
                total += (d * 2 * d_in        # in_proj
                          + d_in * m.d_conv   # conv
                          + d_in * (dt_rank + 2 * m.d_state)  # x_proj
                          + dt_rank * d_in + d_in             # dt_proj
                          + d_in * m.d_state  # A
                          + d_in              # D
                          + d_in * d)         # out_proj
            if kind == "attn" or self.family != "ssm":
                if is_moe:
                    mo = self.moe
                    total += (d * mo.num_experts                      # router
                              + mo.num_experts * 3 * d * mo.d_ff_expert)
                elif kind != "mamba":
                    mult = 3 if self.act in ("silu", "gelu") else 2
                    total += mult * d * self.d_ff
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.n_params()
        total = self.n_params()
        mo = self.moe
        n_moe_layers = sum(1 for i in range(self.num_layers)
                           if self.layer_kind(i)[1])
        inactive = (n_moe_layers * (mo.num_experts - mo.experts_per_token)
                    * 3 * self.d_model * mo.d_ff_expert)
        return total - inactive

    def layer_kind(self, i: int) -> Tuple[str, bool]:
        """Return (mixer_kind, is_moe_ffn) for layer i.

        mixer_kind in {"attn", "mamba"}; is_moe_ffn selects MoE vs dense FFN.
        """
        if self.family == "ssm":
            return ("mamba", False)
        if self.family == "hybrid":
            # Jamba: 1 attention layer per `attn_every` (position attn_every-1
            # within each period); MoE every `moe_every` layers (odd layers).
            last = i % self.attn_every == self.attn_every - 1
            kind = "attn" if last else "mamba"
            is_moe = (self.moe is not None
                      and i % self.moe_every == self.moe_every - 1)
            return (kind, is_moe)
        is_moe = self.moe is not None
        return ("attn", is_moe)

    def layer_is_local(self, i: int) -> bool:
        """Gemma2-style alternating local/global: even layers local."""
        if not self.alt_local_global:
            return self.window_size > 0
        return i % 2 == 0


# ---------------------------------------------------------------------------
# Input shapes (assigned set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                           # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Mesh / run config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (("pod", "data", "model") if self.multi_pod
                else ("data", "model"))

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class RunConfig:
    """Training/serving runtime options — the hillclimb levers live here."""
    arch: str = "smollm-360m"
    shape: str = "train_4k"
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # numerics
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    # optimizer
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    # distribution levers
    remat_policy: str = "dots_saveable"  # none | dots_saveable | full
    fsdp: bool = True                    # shard params/opt-state over DP axes
    seq_shard_long: bool = True          # SP for long-context decode
    grad_compression: str = "none"       # none | int8
    scan_layers: bool = True
    # serving
    decode_kv_dtype: str = "bfloat16"
    # sharding rule-set name (see sharding/rules.py)
    sharding_rules: str = "default"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_REGISTRY: Dict[str, ArchConfig] = {}
_SMOKE_REGISTRY: Dict[str, ArchConfig] = {}


def register_arch(cfg: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    _SMOKE_REGISTRY[cfg.name] = smoke
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_configs_loaded()
    if name not in ARCH_REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def get_smoke_arch(name: str) -> ArchConfig:
    _ensure_configs_loaded()
    return _SMOKE_REGISTRY[name]


def list_archs() -> List[str]:
    _ensure_configs_loaded()
    return sorted(ARCH_REGISTRY)


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> List[Tuple[str, str]]:
    """All (arch, shape) cells, incl. inapplicable (caller filters)."""
    _ensure_configs_loaded()
    return [(a, s) for a in list_archs() for s in SHAPES]


def applicable_cells() -> List[Tuple[str, str]]:
    _ensure_configs_loaded()
    out = []
    for a in list_archs():
        cfg = ARCH_REGISTRY[a]
        for s in SHAPES:
            if s in cfg.applicable_shapes:
                out.append((a, s))
    return out


_configs_loaded = False


def _ensure_configs_loaded() -> None:
    global _configs_loaded
    if _configs_loaded:
        return
    _configs_loaded = True
    from repro_torch import configs as _configs  # noqa: F401  (registration)


def override(cfg, **kw):
    """Functional update helper for any frozen dataclass config."""
    return replace(cfg, **kw)
