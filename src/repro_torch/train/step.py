"""Train step: mixed-precision loss and gradients, then clipping and
AdamW: the counterpart of ``repro/train/step.py``.

The training state keeps the reference's trees: ``params`` is its
parameter tree of float32 masters (each block leaf stacked along a
leading ``num_blocks`` axis, ``convert.params_tree``), the optimizer
state and the MoE telemetry are shaped alike, so a checkpoint of
either package restores into the other.  The loss runs the port's
``Model`` through ``torch.func.functional_call`` on cast copies of the
masters: float32 masters with more than one axis are cast to the
activation dtype, one-axis ones (norm scales, biases) stay float32, and
float32 batch leaves with three or more axes (frames, patches) are
cast, as the reference casts them.  The gradient reaches the masters
through the casts and the per-block views (``unbind``).  Not
``torch.autocast``: it casts per op and would compute something else.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple

import torch
from torch import nn

from repro_torch import models
from repro_torch.config import ArchConfig, RunConfig
from repro_torch.convert import params_tree
from repro_torch.kernels.common import resolve_device
from repro_torch.train import optimizer as opt
from repro_torch.utils import (tree_flatten_with_names, tree_leaves,
                               tree_unflatten_like)


class TrainState(NamedTuple):
    params: Any
    opt: opt.AdamState
    moe_state: Dict[str, torch.Tensor]
    step: torch.Tensor


def init_train_state(cfg: ArchConfig, run: RunConfig, seed: int = 0,
                     device=None) -> TrainState:
    """Weights from ``models.init_params(cfg, seed)`` (not the
    reference's: its threefry draws differ; the parity tests convert
    the reference's state instead), zero moments, balanced MoE
    telemetry and step 0, on ``device`` (the card when None)."""
    dev = resolve_device(device)
    params = params_tree(models.init_params(cfg, seed, device=dev))
    return TrainState(
        params=params,
        opt=opt.init_adam_state(params,
                                eight_bit=run.optimizer == "adamw8bit"),
        moe_state=models.init_moe_state(cfg, dev),
        step=torch.zeros((), dtype=torch.int32, device=dev))


class _Loss(nn.Module):
    """``models.loss_fn`` as a module, so ``functional_call`` can run it
    on the cast masters (the model's own weights are on the meta
    device: every one is replaced)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.model = models.Model(cfg, device="meta")

    def forward(self, batch, moe_state, remat_policy, impl):
        return models.loss_fn(self.model, batch, moe_state,
                              remat_policy=remat_policy, impl=impl)


@functools.lru_cache(maxsize=None)
def _loss_module(cfg: ArchConfig) -> _Loss:
    return _Loss(cfg)


def compute_params(params, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The names and tensors ``functional_call`` gives the model: each
    float32 leaf of more than one axis cast to ``dtype``, and a block
    leaf unbound into its blocks' views (``model.blocks.<b>.<pos>...``)."""
    out = {}
    for path, p in tree_flatten_with_names(params):
        if p.dtype == torch.float32 and p.dim() > 1:
            p = p.to(dtype)
        parts = path.split("/")
        if parts[0] == "blocks":
            rest = ".".join(parts[1:])
            for b, view in enumerate(p.unbind(0)):
                out[f"model.blocks.{b}.{rest}"] = view
        else:
            out["model." + ".".join(parts)] = p
    return out


def cast_batch(batch: Dict[str, torch.Tensor], dtype: torch.dtype):
    """float32 batch leaves of three or more axes cast to ``dtype``."""
    return {k: (v.to(dtype) if v.dtype == torch.float32 and v.dim() >= 3
                else v) for k, v in batch.items()}


def value_and_grad(cfg: ArchConfig, run: RunConfig, params, moe_state,
                   batch, *, impl: str = "auto"):
    """(loss, (new_moe_state, metrics)) of ``models.loss_fn`` on the
    cast masters, and the gradient tree of the float32 masters (zeros
    for a leaf the loss does not reach, as ``jax.grad`` gives)."""
    act = getattr(torch, run.activation_dtype)
    leaves = tree_leaves(params)
    masters = [p.detach().requires_grad_(True) for p in leaves]
    tree = tree_unflatten_like(params, masters)
    with torch.enable_grad():
        loss, aux = torch.func.functional_call(
            _loss_module(cfg), compute_params(tree, act),
            (cast_batch(batch, act), moe_state, run.remat_policy, impl))
        grads = torch.autograd.grad(loss, masters, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    new_moe, metrics = aux
    new_moe = {k: v.detach() for k, v in new_moe.items()}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), (new_moe, metrics)), tree_unflatten_like(
        params, grads)


def make_train_step(cfg: ArchConfig, run: RunConfig, *, impl: str = "auto"):
    """``train_step(state, batch) -> (new_state, metrics)``: the loss and
    gradients, clipping to ``run.grad_clip``, AdamW (``run.optimizer``
    "adamw" or "adamw8bit"); metrics are ``loss_fn``'s plus ``loss`` and
    ``grad_norm`` (before clipping).  ``impl`` picks every kernel of the
    model (``models.forward``)."""
    if run.optimizer not in ("adamw", "adamw8bit"):
        raise ValueError(f"unknown optimizer {run.optimizer!r}; "
                         f"available: adamw, adamw8bit")
    models.remat_context(run.remat_policy)  # the name is checked
    eight_bit = run.optimizer == "adamw8bit"

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        (loss, (new_moe, metrics)), grads = value_and_grad(
            cfg, run, state.params, state.moe_state, batch, impl=impl)
        grads, gnorm = opt.clip_by_global_norm(grads, run.grad_clip)
        new_params, new_opt = opt.adamw_update(
            state.params, grads, state.opt, state.step,
            lr=run.learning_rate, beta1=run.beta1, beta2=run.beta2,
            weight_decay=run.weight_decay, eight_bit=eight_bit)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(params=new_params, opt=new_opt,
                          moe_state=new_moe, step=state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ArchConfig, run: RunConfig, *, impl: str = "auto"):
    """``eval_step(params, moe_state, batch) -> metrics`` of the cast
    masters without gradients (the batch uncast, as the reference's)."""
    act = getattr(torch, run.activation_dtype)

    @torch.no_grad()
    def eval_step(params, moe_state, batch):
        _, (_, metrics) = torch.func.functional_call(
            _loss_module(cfg), compute_params(params, act),
            (batch, moe_state, "none", impl))
        return metrics

    return eval_step
