"""Small tree utilities used across the training port: the
counterparts of ``repro/utils/trees.py``.

A tree is nested dicts, tuples, lists and NamedTuples with tensor (or
numpy) leaves; ``None`` is an empty subtree.  Leaves are visited in
``jax.tree_util``'s order: a dict's keys sorted, a sequence's items in
order, a NamedTuple's fields in order.  A leaf's path name joins its
keys with "/", as the reference's checkpoints name leaves: a dict key
as it is, a sequence index as its number, a NamedTuple field as
``.name`` (``str`` of JAX's ``GetAttrKey``), so a ``TrainState``'s
embedding is ``.params/embed/tokens``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from repro_torch.core import xla


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_names(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path name, leaf)] in ``jax.tree_util``'s order."""
    def join(key: str) -> str:
        return f"{prefix}/{key}" if prefix else key

    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += tree_flatten_with_names(tree[key], join(str(key)))
        return out
    if _is_namedtuple(tree):
        out = []
        for name, value in zip(tree._fields, tree):
            out += tree_flatten_with_names(value, join("." + name))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, value in enumerate(tree):
            out += tree_flatten_with_names(value, join(str(i)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_names(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``) in leaf order, keeping its structure (a dict's keys come
    out sorted); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):  # in leaf order: the keys sorted
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten_like(template, leaves: List[Any]):
    """``template``'s structure with ``leaves`` in its leaf order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_count(tree) -> int:
    """Total number of array elements in a tree."""
    return sum(int(x.numel() if torch.is_tensor(x) else x.size)
               for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of a tree of tensors or numpy arrays."""
    total = 0
    for x in tree_leaves(tree):
        if torch.is_tensor(x):
            total += x.numel() * x.element_size()
        else:
            total += int(x.size) * x.dtype.itemsize
    return total


def tree_map_with_path_names(fn: Callable, tree):
    """``tree_map`` where ``fn`` receives ('a/b/c', leaf)."""
    names = iter(tree_flatten_with_names(tree))
    return tree_map(lambda leaf: fn(next(names)[0], leaf), tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, as the
    reference's jitted ``global_norm``: each leaf's ``jnp.sum`` of
    squares by ``core.xla.reduce_sum`` over the flattened leaf (up to 32
    elements the squares fused into a left-to-right sum, above that
    rounded and summed by XLA's windows of 32), then the leaf sums added
    left to right in leaf order; the square root correctly rounded
    (through float64: PyTorch's float32 sqrt on the CPU is not).  That
    is XLA's order for a 1-D leaf.  For a leaf of several axes XLA
    windows each axis longer than 32 (a window spans the whole of a
    shorter one) and sums a window row-major, which can differ from the
    flat order in the last bit; following it would take one op per
    element of a window, so the port keeps the flat order."""
    total = None
    for x in tree_leaves(tree):
        s = xla.reduce_sum(x.float().reshape(-1), squares=True)
        total = s if total is None else total + s
    if total is None:
        raise ValueError("global_norm of an empty tree")
    return torch.sqrt(total.double()).float()
