"""Bitwise port of ``jax.random``'s threefry2x32 generator.

The JAX package draws all of the engine's randomness with threefry2x32
in its "partitionable" mode (``jax_threefry_partitionable=True``, the
default of jax 0.9).  This module reproduces those draws bit for bit,
so a seed means the same thing in both packages: ``PRNGKey``,
``split``, ``fold_in``, ``random_bits``, ``uniform`` and ``randint``
follow ``jax/_src/prng.py`` (``threefry_2x32``,
``_threefry_split_foldlike``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``) and ``jax/_src/random.py``
(``_uniform``, ``_randint``).

PyTorch has no uint32 arithmetic, so a uint32 value lives in an int64
tensor and every operation masks back to 32 bits.  A key is an int64
tensor of shape ``(..., 2)``; every function broadcasts over the
leading axes, which lets the engine draw a whole horizon's waves in one
call.  ``threefry2x32`` also accepts plain Python ints, which the
engine uses to walk the per-tick key chain on the host.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.xla import fma
from repro_torch.kernels.common import resolve_device

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block cipher on uint32 values held in int64
    tensors (or Python ints); arguments broadcast.  Returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def mul32(a, b):
    """``a * b mod 2**32`` for uint32 values in int64, without ever
    forming a product that overflows int64."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``(2,)`` key on
    ``device`` (the card when None)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=resolve_device(device))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., num, 2)``."""
    cnt = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., :1], key[..., 1:], 0, cnt)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` (int or int tensor) broadcasts
    against the key's leading axes, like a vmapped fold_in."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0, data & MASK)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element: ``(..., 2)`` keys -> ``(..., *shape)``
    int64 tensor of uint32 values."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError(f"random_bits supports < 2**32 draws, got {n}")
    cnt = torch.arange(n, dtype=torch.int64, device=key.device)
    cnt = cnt.reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    b1, b2 = threefry2x32(
        key[..., 0].reshape(lead), key[..., 1].reshape(lead), 0, cnt
    )
    return b1 ^ b2


def uniform(
    key: torch.Tensor,
    shape: Tuple[int, ...] = (),
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform`` in float32 over ``[minval, maxval)``."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    if lo == 0.0 and span == 1.0:
        return floats
    # XLA fuses floats * span + lo into one multiply-add
    return fma(floats, span, lo).clamp(min=lo)


def randint(
    key: torch.Tensor, shape: Tuple[int, ...], minval: int, maxval: int
) -> torch.Tensor:
    """``jax.random.randint`` to int32 for Python-int bounds."""
    k = split(key)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (2**16) % span
    mult = ((mult * mult) & MASK) % span
    off = (mul32(higher % span, mult) + lower % span) & MASK
    return (minval + off % span).to(torch.int32)


def key_ints(key: torch.Tensor) -> Tuple[int, int]:
    """A single ``(2,)`` key as two Python ints (one host read)."""
    k1, k2 = key.tolist()
    return int(k1), int(k2)


def split_ints(k1: int, k2: int, num: int):
    """``split`` on a key held as Python ints: ``num`` (k1, k2) pairs."""
    return [threefry2x32(k1, k2, 0, i) for i in range(num)]
