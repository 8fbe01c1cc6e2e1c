"""Carry state, workload grids, weights and caches from the JAX
reference into the port.

The parity tests start both engines from the same state and feed both
the same realized grids, and run both models with the same weights.
The reference's arrays arrive here as numpy (the caller runs
``jax.device_get``); this module never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import ArchConfig
from repro_torch.core.sim import SimConfig, SimState, init_state
from repro_torch.core.workloads import Workload
from repro_torch.kernels.common import resolve_device
from repro_torch.models import (Model, block_pattern, init_moe_state,
                                num_blocks)
from repro_torch.models.mamba import dims as mamba_dims


def _like(template: Any, value: Any, path: str) -> Any:
    """``value`` (numpy leaves, nested tuples/NamedTuples) converted to
    the structure, dtypes and device of ``template``."""
    if torch.is_tensor(template):
        arr = np.array(value)
        if arr.shape != tuple(template.shape):
            raise ValueError(
                f"{path}: shape {arr.shape}, expected "
                f"{tuple(template.shape)}"
            )
        if arr.dtype == np.uint32:  # threefry keys
            arr = arr.astype(np.int64)
        return torch.as_tensor(arr).to(
            dtype=template.dtype, device=template.device
        ).clone()
    if isinstance(template, tuple):
        if len(value) != len(template):
            raise ValueError(
                f"{path}: {len(value)} fields, expected {len(template)}"
            )
        fields = getattr(template, "_fields", None)
        items = [
            _like(t, v, f"{path}.{fields[i] if fields else i}")
            for i, (t, v) in enumerate(zip(template, value))
        ]
        return type(template)(*items) if fields else tuple(items)
    raise TypeError(f"{path}: unsupported template leaf {template!r}")


def state_from_numpy(tree: Any, cfg: SimConfig, device=None) -> SimState:
    """The reference's ``SimState`` (numpy leaves) as the port's
    ``SimState`` on ``device``, field for field."""
    template = init_state(cfg, device=resolve_device(device))
    return _like(template, tree, "SimState")


def workload_from_numpy(
    keys, mask, is_write, N: int, device=None, name: str = ""
) -> Workload:
    """A realized (T, R) grid as the port's ``Workload`` on ``device``."""
    dev = resolve_device(device)
    return Workload(
        keys=torch.as_tensor(np.array(keys, np.int32), device=dev),
        mask=torch.as_tensor(np.array(mask, bool), device=dev),
        is_write=torch.as_tensor(np.array(is_write, bool), device=dev),
        name=name,
        N=int(N),
    )


def _tensor(arr: Any) -> torch.Tensor:
    """A numpy array as a CPU tensor; bfloat16 arrays (``ml_dtypes``,
    as ``jax.device_get`` returns them) keep their bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _leaf(tree: Any, path) -> Any:
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            raise ValueError(f"params: no leaf {'/'.join(path)}")
        node = node[key]
    return node


def _count_leaves(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def params_from_numpy(cfg: ArchConfig, tree: Any, device=None,
                      dtype=torch.float32) -> Model:
    """The reference's parameter tree (numpy leaves, the blocks stacked
    along a leading ``num_blocks`` axis, as ``init_params`` makes it) as
    the port's :class:`~repro_torch.models.Model` on ``device``.  Raises
    on a missing, extra or mis-shaped leaf."""
    model = Model(cfg, device=device, dtype=dtype)
    n = num_blocks(cfg)
    names = dict(model.named_parameters())
    stacked = {}  # a block leaf, read once for all n blocks
    with torch.no_grad():
        for name, p in names.items():
            parts = name.split(".")
            if parts[0] == "blocks":
                b, path = int(parts[1]), ["blocks", *parts[2:]]
                key = "/".join(path)
                if key not in stacked:
                    arr = _tensor(_leaf(tree, path))
                    want = (n, *p.shape)
                    if tuple(arr.shape) != want:
                        raise ValueError(f"params: {key} has shape "
                                         f"{tuple(arr.shape)}, expected "
                                         f"{want}")
                    stacked[key] = arr
                src = stacked[key][b]
            else:
                key = "/".join(parts)
                src = _tensor(_leaf(tree, parts))
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"params: {key} has shape "
                                     f"{tuple(src.shape)}, expected "
                                     f"{tuple(p.shape)}")
            p.copy_(src.to(dtype))
    want = len(names) - (n - 1) * len(stacked)
    if _count_leaves(tree) != want:
        raise ValueError(f"params: the tree has {_count_leaves(tree)} "
                         f"leaves, the model {want}")
    return model


def cache_from_numpy(cfg: ArchConfig, tree: Any,
                     device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's decode cache (numpy leaves: ``{pos: {"k", "v"}}``
    of shape (num_blocks, B, S, KV, hd) at attention positions,
    ``{pos: {"h", "conv"}}`` of shape (num_blocks, B, di, st) and
    (num_blocks, B, d_conv - 1, di) at Mamba positions) as the port's,
    in the same dtypes, on ``device``.  Raises on a missing or
    mis-shaped leaf."""
    dev = resolve_device(device)
    n = num_blocks(cfg)
    out = {}
    for i, spec in enumerate(block_pattern(cfg)):
        if spec.kind == "attn":
            names = ("k", "v")
            tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
            want = (f"(num_blocks={n}, B, S, {tail[0]}, {tail[1]}) each")
        else:
            di, st, dc, _ = mamba_dims(cfg)
            names = ("h", "conv")
            want = (f"(num_blocks={n}, B, {di}, {st}) and (num_blocks={n},"
                    f" B, {dc - 1}, {di})")
        a, b = (_tensor(_leaf(tree, [str(i), name])) for name in names)
        if spec.kind == "attn":
            ok = (a.dim() == 5 and (a.shape[0], *a.shape[3:]) == (n, *tail)
                  and a.shape == b.shape)
        else:
            ok = (a.dim() == 4 and b.dim() == 4
                  and (a.shape[0], *a.shape[2:]) == (n, di, st)
                  and (b.shape[0], *b.shape[2:]) == (n, dc - 1, di)
                  and a.shape[1] == b.shape[1])
        if not ok:
            raise ValueError(
                f"cache[{i}]: {names[0]} {tuple(a.shape)} and {names[1]} "
                f"{tuple(b.shape)}, expected {want}"
            )
        out[str(i)] = {names[0]: a.to(dev), names[1]: b.to(dev)}
    if _count_leaves(tree) != 2 * len(out):
        raise ValueError(f"cache: the tree has {_count_leaves(tree)} "
                         f"leaves, expected {2 * len(out)}")
    return out


def moe_state_from_numpy(cfg: ArchConfig, tree: Any,
                         device=None) -> Dict[str, torch.Tensor]:
    """The reference's MoE telemetry state (numpy leaves, ``{pos:
    (num_blocks, E)}`` at the MoE block positions, as its
    ``init_moe_state`` and ``forward`` make it) as the port's, float32
    on ``device``.  Raises on a missing, extra or mis-shaped leaf."""
    template = init_moe_state(cfg, resolve_device(device))
    if sorted(tree) != sorted(template):
        raise ValueError(f"moe_state: positions {sorted(tree)}, expected "
                         f"{sorted(template)}")
    out = {}
    for pos, t in template.items():
        arr = _tensor(tree[pos])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"moe_state[{pos}]: shape {tuple(arr.shape)}, "
                             f"expected {tuple(t.shape)}")
        out[pos] = arr.to(dtype=torch.float32, device=t.device)
    return out


# ---------------------------------------------------------------------------
# Training state: the reference's trees, both ways
# ---------------------------------------------------------------------------


def params_tree(model: Model) -> Dict[str, Any]:
    """The model's weights as the reference's parameter tree of tensors
    (new tensors on the model's device, detached): nested dicts with the
    reference's leaf names, each block leaf stacked along a leading
    ``num_blocks`` axis, as its ``init_params`` makes the tree.  The
    training state keeps its float32 masters so (``train/step.py``)."""
    tree: Dict[str, Any] = {}
    blocks: Dict[str, list] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            blocks.setdefault("/".join(parts[2:]), []).append(p.detach())
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = p.detach().clone()
    for path, leaves in blocks.items():
        node = tree.setdefault("blocks", {})
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = torch.stack(leaves)
    return tree


def _numpy(t) -> np.ndarray:
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # jax's dependency; only for bfloat16 leaves

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def tree_to_numpy(tree: Any) -> Any:
    """A tree of tensors or numpy arrays (dicts, tuples, NamedTuples;
    None kept) as numpy leaves on the host, the structure the reference's checkpoints and
    ``jax.device_get`` hold."""
    from repro_torch.utils import tree_map

    return tree_map(_numpy, tree)


def tree_from_numpy(tree: Any, device=None) -> Any:
    """A tree of numpy leaves as tensors on ``device`` (the card when
    None), the structure kept; bfloat16 leaves keep their bits."""
    from repro_torch.utils import tree_map

    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a).to(dev), tree)


def params_to_numpy(model: Model) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the model's weights as
    the reference's parameter tree of numpy arrays (blocks stacked)."""
    return tree_to_numpy(params_tree(model))


def adam_state_from_numpy(state: Any, device=None):
    """The reference's ``AdamState`` (numpy leaves; ``m_scale`` and
    ``v_scale`` None unless 8-bit) as the port's on ``device``: float32
    moments, or int8 payloads (n_blocks, 256) and float32 scales."""
    from repro_torch.train.optimizer import AdamState

    return AdamState(*(None if f is None else tree_from_numpy(f, device)
                       for f in state))


def adam_state_to_numpy(state) -> Any:
    """The port's ``AdamState`` as the reference's, numpy leaves."""
    from repro_torch.train.optimizer import AdamState

    return AdamState(*(None if f is None else tree_to_numpy(f)
                       for f in state))


def moe_state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`moe_state_from_numpy`."""
    return {pos: _numpy(t) for pos, t in state.items()}
