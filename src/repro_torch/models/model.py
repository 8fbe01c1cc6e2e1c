"""Model assembly for the dense, MoE, pure-SSM and hybrid
families.

The counterpart of ``repro/models/model.py``.  A model is a stack of
``num_blocks`` identical blocks; a block is a short pattern of layers
(``[attn]``, gemma2's ``[attn-local, attn-global]``, falcon-mamba's
``[mamba]``, or jamba's eight: Mamba with attention at position 7 and
MoE on the odd positions).  The reference scans the stacked blocks
with ``lax.scan``; here they are an ``nn.ModuleList`` walked in order,
and the decode cache keeps the reference's stacked layout: an attention
position holds ``{"k", "v"}`` of shape (num_blocks, B, S_max, KV, hd),
a Mamba position ``{"h": (num_blocks, B, di, st) float32, "conv":
(num_blocks, B, d_conv - 1, di)}``, so block ``b`` reads and writes the
views ``cache[pos][name][b]``.  MoE positions carry per-expert load
telemetry in the same stacked layout, ``{pos: (num_blocks, E)}``
(:func:`init_moe_state`).

The audio and vision archs (MusicGen, LLaVA-NeXT) embed their inputs
through the frontends of ``stubs.py``: ``batch["frames"]`` (B, S,
d_model) plus sinusoidal positions in place of token embeddings, or
``batch["patches"]`` (B, P, d_model) projected and prepended to the
token embeddings; decoding embeds tokens for both.

Training: :func:`forward` runs under autograd (prefill and decode do
not), :func:`loss_fn` is the reference's next-token cross entropy with
the MoE metrics and aux loss, and ``remat_policy`` checkpoints each
block as the reference's ``jax.checkpoint`` wraps its scan body
(:func:`remat_context`).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.config import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import stubs


class LayerSpec(NamedTuple):
    kind: str  # "attn" | "mamba"
    is_moe: bool
    is_local: bool


def block_pattern(cfg: ArchConfig) -> List[LayerSpec]:
    if cfg.family == "ssm":
        return [LayerSpec("mamba", False, False)]
    if cfg.family == "hybrid":
        out = []
        for i in range(cfg.attn_every):
            kind, is_moe = cfg.layer_kind(i)
            out.append(LayerSpec(kind, is_moe, False))
        return out
    if cfg.alt_local_global:
        return [LayerSpec("attn", cfg.moe is not None, True),
                LayerSpec("attn", cfg.moe is not None, False)]
    return [LayerSpec("attn", cfg.moe is not None, cfg.window_size > 0)]


def num_blocks(cfg: ArchConfig) -> int:
    pat = block_pattern(cfg)
    if cfg.num_layers % len(pat):
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                         f"split into blocks of {len(pat)}")
    return cfg.num_layers // len(pat)


def _layer_has_ffn(cfg: ArchConfig) -> bool:
    return cfg.family != "ssm"


REMAT_POLICIES = ("none", "full", "dots_saveable",
                  "dots_with_no_batch_dims_saveable")
# the ops the reference's einsums lower to: jax.checkpoint_policies'
# dots_saveable keeps every dot's output, dots_with_no_batch_dims_saveable
# those without batch dimensions (the batched ones are bmm)
_DOTS = {
    "dots_saveable": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default),
    "dots_with_no_batch_dims_saveable": (torch.ops.aten.mm.default,
                                         torch.ops.aten.addmm.default),
}


def _save_dots(saved, ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context(remat_policy: str):
    """None for "none" (keep every activation), else the checkpoint's
    ``context_fn``: "full" saves only the block's inputs and recomputes
    the rest in the backward; the dots policies save the outputs of the
    matrix products (:data:`_DOTS`) and recompute the rest (selective
    checkpointing).  Raises ``ValueError`` on another name."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; "
                         f"available: {', '.join(REMAT_POLICIES)}")
    if remat_policy == "none":
        return None
    if remat_policy == "full":
        return ckpt.noop_context_fn
    policy = functools.partial(_save_dots, _DOTS[remat_policy])
    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy)


class Layer(nn.Module):
    """Pre-norm mixer (attention or Mamba) and, outside the SSM family,
    a post-norm MLP or MoE, with residuals (``_layer_apply``)."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.spec = spec
        self.pre_norm = L.Norm(cfg.d_model, cfg.norm, **kw)
        if spec.kind == "attn":
            self.mixer = L.Attention(cfg, **kw)
        else:
            self.mixer = mamba_lib.Mamba(cfg, **kw)
        self.has_ffn = _layer_has_ffn(cfg)
        if self.has_ffn:
            self.post_norm = L.Norm(cfg.d_model, cfg.norm, **kw)
            self.ffn = moe_lib.MoE(cfg, **kw) if spec.is_moe else L.MLP(
                cfg, **kw)

    def _ffn(self, x: torch.Tensor, moe_load, impl: str):
        """x plus the feed-forward output, and the MoE's aux values (None
        for an MLP or no FFN)."""
        if not self.has_ffn:
            return x, None
        h = self.post_norm(x)
        if self.spec.is_moe:
            y, aux = self.ffn(h, moe_load, impl=impl)
            return x + y, aux
        return x + self.ffn(h), None

    def forward(self, x: torch.Tensor, *, impl: str = "auto",
                moe_load: Optional[torch.Tensor] = None,
                return_state: bool = False):
        """Returns (x, state, aux): with ``return_state`` the mixer's
        decode state (the attention's ``{"k", "v"}`` or the Mamba
        layer's ``{"h", "conv"}``, else None), and an MoE layer's
        :class:`~repro_torch.models.moe.MoEAux` under the telemetry
        ``moe_load`` (None for balanced; aux None without MoE)."""
        h = self.pre_norm(x)
        if self.spec.kind == "attn":
            out = self.mixer(h, is_local=self.spec.is_local, impl=impl,
                             return_kv=return_state)
        else:
            out = self.mixer(h, impl=impl, return_state=return_state)
        mix, state = out if return_state else (out, None)
        x, aux = self._ffn(x + mix, moe_load, impl)
        return x, state, aux

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
        """One token, ``cache`` this layer's views (``{"k", "v"}`` or
        ``{"h", "conv"}``), written in place.  An MoE layer sees balanced
        telemetry, as the reference's decode passes none."""
        h = self.pre_norm(x)
        if self.spec.kind == "attn":
            mix = self.mixer.decode(h, cache["k"], cache["v"], pos,
                                    is_local=self.spec.is_local, impl=impl)
        else:
            mix = self.mixer.decode(h, cache["h"], cache["conv"])
        return self._ffn(x + mix, None, impl)[0]


class Block(nn.ModuleDict):
    """One block: the layers of ``block_pattern`` by position ("0",
    "1", ...), applied in order."""

    def forward(self, x: torch.Tensor, loads: Dict[str, torch.Tensor],
                impl: str):
        """(x, {pos: MoEAux}) of the block's layers on x, an MoE layer
        under the telemetry ``loads[pos]`` (balanced when absent)."""
        auxes = {}
        for i in range(len(self)):
            x, _, aux = self[str(i)](x, impl=impl,
                                     moe_load=loads.get(str(i)))
            if aux is not None:
                auxes[str(i)] = aux
        return x, auxes


class Model(nn.Module):
    """Embedding, ``num_blocks`` blocks of ``block_pattern`` layers, the
    final norm and the LM head.  Parameter names mirror the reference's
    tree: ``blocks.<b>.<pos>.mixer.wq`` is ``params["blocks"][pos]
    ["mixer"]["wq"][b]``.  Weights are uninitialised: use
    :func:`init_params` or ``convert.params_from_numpy``."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.cfg = cfg
        self.pattern = block_pattern(cfg)
        self.embed = L.Embed(cfg, **kw)
        self.final_norm = L.Norm(cfg.d_model, cfg.norm, **kw)
        self.blocks = nn.ModuleList(
            Block({str(i): Layer(cfg, spec, **kw)
                   for i, spec in enumerate(self.pattern)})
            for _ in range(num_blocks(cfg))
        )
        # the vision projector, registered last so the other weights
        # draw the same random numbers as before it was ported
        fe = stubs.frontend_init(cfg, **kw)
        if fe is not None:
            self.frontend = fe

    @property
    def device(self) -> torch.device:
        return self.embed.tokens.device


_ZEROS = ("bias", "bq", "bk", "bv", "b1", "b2", "conv_b")
_ONES = ("scale", "dt_b", "D")
_EXPERTS = ("w_gate", "w_up", "w_down")


def init_params(cfg: ArchConfig, seed: int = 0, *, dtype=torch.float32,
                device=None) -> Model:
    """A model with random weights on ``device`` (the card when None).

    The reference's rules: norm scales, Mamba's ``dt_b`` and ``D`` are
    ones, biases zeros, ``A_log`` is log(1..d_state) on every channel,
    and every other weight is normal / sqrt(fan_in), with fan_in the
    input width (H·hd for ``wo``, d_conv for ``conv_w``, 1 for the
    embedding table, d for the MoE ``router``, ``w_gate`` and ``w_up``,
    d_ff_expert for its ``w_down``, d_model for the vision ``proj``).  The draws come from a CPU
    ``torch.Generator`` seeded with ``seed``, one parameter at a time,
    so a seed gives the same weights on every device (not the
    reference's: its threefry draws differ; parity tests convert the
    reference's weights with ``convert.params_from_numpy``)."""
    model = Model(cfg, device=device, dtype=dtype)
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ONES:
                p.fill_(1.0)
            elif leaf in _ZEROS:
                p.zero_()
            elif leaf == "A_log":
                st = p.shape[-1]
                p.copy_(torch.log(torch.arange(1, st + 1,
                                               dtype=torch.float32))
                        .expand(p.shape).to(dtype))
            else:
                if leaf == "tokens":
                    fan_in = 1
                elif leaf == "wo":
                    fan_in = p.shape[0] * p.shape[1]
                elif leaf == "conv_w" or (leaf in _EXPERTS
                                          and p.dim() == 3):
                    # conv_w (di, d_conv); experts (E, d, f) and (E, f, d)
                    fan_in = p.shape[1]
                else:
                    fan_in = p.shape[0]
                w = torch.randn(p.shape, generator=gen) * (
                    1.0 / fan_in ** 0.5)
                p.copy_(w.to(dtype))
    return model


# ---------------------------------------------------------------------------
# MoE telemetry state
# ---------------------------------------------------------------------------


def init_moe_state(cfg: ArchConfig, device=None) -> Dict[str, torch.Tensor]:
    """Stale per-expert load telemetry of each MoE block position,
    stacked over blocks: ``{pos: (num_blocks, E)}`` float32 ones
    (balanced) on ``device`` (the card when None); empty without
    MoE."""
    if cfg.moe is None:
        return {}
    dev = resolve_device(device)
    n = num_blocks(cfg)
    return {str(i): torch.ones((n, cfg.moe.num_experts),
                               dtype=torch.float32, device=dev)
            for i, spec in enumerate(block_pattern(cfg)) if spec.is_moe}


# ---------------------------------------------------------------------------
# Forward (logits of a whole sequence)
# ---------------------------------------------------------------------------


def _embed_inputs(model: Model, batch: Dict[str, torch.Tensor]):
    """The layers' input (B, S, d_model): the frames plus positions
    (audio), the projected patches before the token embeddings (vision),
    or the token embeddings."""
    cfg = model.cfg
    if cfg.frontend == "audio_frames":
        return stubs.audio_frontend(cfg, batch["frames"])
    tok = model.embed(batch["tokens"])
    if cfg.frontend == "vlm_patches":
        return stubs.vlm_frontend(model.frontend, cfg, batch["patches"],
                                  tok)
    return tok


def forward(model: Model, batch: Dict[str, torch.Tensor], *,
            moe_state: Optional[Dict[str, torch.Tensor]] = None,
            return_moe: bool = False, impl: str = "auto",
            remat_policy: str = "none"):
    """Full-sequence forward of ``batch["tokens"]`` (B, S) (with
    ``batch["patches"]`` (B, P, d_model) before them for a vision arch,
    or ``batch["frames"]`` (B, S, d_model) in their place for an audio
    arch; the logits then cover the P + S positions).

    Returns the logits (B, S, V); with ``return_moe=True`` returns
    ``(logits, new_moe_state, aux)`` as the reference's ``forward``
    does: ``new_moe_state[pos]`` is the EWMA of ``moe_state[pos]``
    (balanced ones when None, :func:`init_moe_state`) towards this
    batch's expert load, and ``aux[pos]`` an
    :class:`~repro_torch.models.moe.MoEAux` whose fields are stacked
    over blocks (load (num_blocks, E), the rates (num_blocks,)); both
    are empty without MoE.  ``impl`` (an ``IMPLS`` choice) picks every
    kernel of the path: the attention kernels, the SSM scan's
    ``chunk_scan`` and the MoE dispatch.

    It runs under autograd when gradients are enabled and a weight or
    input requires one; ``remat_policy`` (:data:`REMAT_POLICIES`) then
    checkpoints each block (:func:`remat_context`), which changes no
    number of the forward or of the gradients."""
    context_fn = remat_context(remat_policy)
    x = _embed_inputs(model, batch)
    auxes: Dict[str, list] = {}
    for b in range(len(model.blocks)):
        loads = {pos: s[b] for pos, s in (moe_state or {}).items()}
        block = model.blocks[b]
        if context_fn is None:
            x, block_aux = block(x, loads, impl)
        else:
            # the recompute runs in the backward, maybe outside the
            # caller's functional_call: it rebinds the weights it saw
            x, block_aux = ckpt.checkpoint(
                torch.func.functional_call, block,
                dict(block.named_parameters()), (x, loads, impl),
                use_reentrant=False, context_fn=context_fn)
        for pos, aux in block_aux.items():
            auxes.setdefault(pos, []).append(aux)
    x = model.final_norm(x)
    logits = model.embed.logits(x)
    if not return_moe:
        return logits
    if moe_state is None:
        moe_state = init_moe_state(model.cfg, x.device)
    aux_out = {pos: moe_lib.MoEAux(*(torch.stack(f) for f in zip(*a)))
               for pos, a in auxes.items()}
    new_state = {pos: moe_lib.update_load_ewma(moe_state[pos], a.load)
                 for pos, a in aux_out.items()}
    return logits, new_state, aux_out


def loss_fn(model: Model, batch: Dict[str, torch.Tensor],
            moe_state: Optional[Dict[str, torch.Tensor]] = None, *,
            remat_policy: str = "none", aux_coef: float = 0.01,
            impl: str = "auto"):
    """Next-token cross entropy in float32 (logsumexp minus the label's
    logit, averaged), plus the switch aux loss times ``aux_coef`` under
    the "topk" router: the reference's ``loss_fn``.  The labels are
    ``batch["labels"]`` shifted by one (audio), the tokens after the P
    patches (vision: logits ``[:, P:-1]`` against ``tokens[:, 1:]``), or
    the tokens shifted by one.  Returns ``(loss, (new_moe_state,
    metrics))``: ``metrics["ce"]`` and, with MoE layers, the drop and
    steer rates and the load's standard deviation (``moe_drop_rate``,
    ``moe_steer_rate``, ``moe_load_cv``) averaged over positions and
    blocks, and ``aux_loss`` under "topk"."""
    cfg = model.cfg
    logits, new_state, aux = forward(model, batch, moe_state=moe_state,
                                     return_moe=True, impl=impl,
                                     remat_policy=remat_policy)
    if cfg.frontend == "audio_frames":
        shift_logits, labels = logits[:, :-1], batch["labels"][:, 1:]
    elif cfg.frontend == "vlm_patches":
        P = batch["patches"].shape[1]
        shift_logits, labels = logits[:, P:-1], batch["tokens"][:, 1:]
    else:
        shift_logits, labels = logits[:, :-1], batch["tokens"][:, 1:]
    lg = shift_logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, labels.long()[..., None])[..., 0]
    ce = (lse - picked).mean()
    metrics = {"ce": ce}
    loss = ce
    if aux:
        def avg(values):
            return torch.stack(list(values)).mean()

        metrics.update(
            moe_drop_rate=avg(a.drop_rate.mean() for a in aux.values()),
            moe_steer_rate=avg(a.steer_rate.mean() for a in aux.values()),
            moe_load_cv=avg(a.load.std(dim=-1, unbiased=False).mean()
                            for a in aux.values()))
        if cfg.moe is not None and cfg.moe.router == "topk":
            aux_l = avg(a.aux_loss.mean() for a in aux.values())
            loss = loss + aux_coef * aux_l
            metrics["aux_loss"] = aux_l
    return loss, (new_state, metrics)


# ---------------------------------------------------------------------------
# Prefill (forward + cache collection, logits for the last position only)
# ---------------------------------------------------------------------------


def init_decode_cache(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zeroed stacked caches on ``device`` (the card when None), one per
    block position: an attention position gets ``{"k", "v"}`` of shape
    (num_blocks, batch, max_seq, KV, hd) in ``dtype``, a Mamba position
    ``{"h": (num_blocks, batch, di, st) float32, "conv": (num_blocks,
    batch, d_conv - 1, di) in dtype}``."""
    dev = resolve_device(device)
    n = num_blocks(cfg)
    cache: Dict[str, Any] = {}
    for i, spec in enumerate(block_pattern(cfg)):
        if spec.kind == "attn":
            shape = (n, batch, max_seq, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            cache[str(i)] = {
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
        else:
            di, st, dc, _ = mamba_lib.dims(cfg)
            cache[str(i)] = {
                "h": torch.zeros((n, batch, di, st), dtype=torch.float32,
                                 device=dev),
                "conv": torch.zeros((n, batch, dc - 1, di), dtype=dtype,
                                    device=dev)}
    return cache


@torch.no_grad()
def prefill(model: Model, batch: Dict[str, torch.Tensor],
            cache_len: Optional[int] = None, cache_dtype=torch.bfloat16,
            *, impl: str = "auto", remat_policy: str = "none"):
    """Serving prefill: run the prompt (its inputs as :func:`forward`
    takes them: a vision arch's patches come first and take the first
    P rows of the cache), return the last position's logits (B, 1, V)
    and a decode-ready cache: K/V padded with zeros to
    ``cache_len`` rows and rounded to ``cache_dtype``; a Mamba layer's
    h in float32 and its conv tail rounded to ``cache_dtype``.  A prompt
    shorter than d_conv - 1 raises ``ValueError`` for a Mamba model.
    MoE layers see balanced telemetry, as in the reference, whose
    prefill passes ``init_moe_state`` at every call.  ``remat_policy``
    changes nothing without gradients, as the reference's checkpoint
    changes nothing outside a differentiated function."""
    remat_context(remat_policy)  # the name is checked
    cfg = model.cfg
    x = _embed_inputs(model, batch)
    B, S = x.shape[:2]
    cache_len = cache_len or S
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} < prompt length {S}")
    cache = init_decode_cache(cfg, B, cache_len, cache_dtype, x.device)
    for b, block in enumerate(model.blocks):
        for i in range(len(model.pattern)):
            x, st, _ = block[str(i)](x, impl=impl, return_state=True)
            c = cache[str(i)]
            if model.pattern[i].kind == "attn":
                c["k"][b, :, :S] = st["k"]
                c["v"][b, :, :S] = st["v"]
            else:
                c["h"][b] = st["h"]
                c["conv"][b] = st["conv"]
    x = model.final_norm(x[:, -1:])
    return model.embed.logits(x), cache


# ---------------------------------------------------------------------------
# Decode (single token with cache)
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(model: Model, cache: Dict[str, Any], tokens: torch.Tensor,
                pos: torch.Tensor, *, impl: str = "auto"):
    """One decode step.  tokens: (B, 1) int; pos: (B,) int32 write
    positions (read by attention layers only).  Returns (logits (B, 1,
    V), cache).  The reference returns a new cache; this one writes the
    new K/V, or the new h and conv window, into ``cache`` in place and
    returns it."""
    x = model.embed(tokens)
    for b, block in enumerate(model.blocks):
        for i in range(len(model.pattern)):
            views = {name: a[b] for name, a in cache[str(i)].items()}
            x = block[str(i)].decode(x, views, pos, impl=impl)
    x = model.final_norm(x)
    return model.embed.logits(x), cache
