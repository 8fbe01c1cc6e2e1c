"""XLA CPU semantics that the port reproduces on purpose.

The JAX package is the reference, and on the CPU it computes two things
differently from plain PyTorch:

* **Fused multiply-add.**  XLA's CPU backend contracts a multiply that
  feeds an add into one fused operation (``(1-a)*x + a*y`` becomes
  ``fma(1-a, x, a*y)``), rounding once.  :func:`fma` does the same.
* **Division by a scalar.**  XLA divides; PyTorch multiplies by a
  reciprocal in some scalar cases.  :func:`div` always divides.
* **Scatter with dropped rows and repeated indices.**  ``x.at[i].set(v,
  mode="drop")`` skips out-of-bounds rows (the engine's sentinel ``N``)
  and, on the CPU, keeps the LAST write when an index repeats.  PyTorch
  raises on index ``N``, and ``index_put_`` with repeated indices is
  nondeterministic on CUDA.  :func:`set_last` masks instead of using a
  sentinel and makes every repeat write the winning value, so the result
  is deterministic on every device.

:func:`set_last` updates the (N,)-sized per-key tables IN PLACE: at N = 10**6 a
functional copy per wave would move more bytes than the whole tick.
"""

from __future__ import annotations

import numpy as np
import torch


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend fuses it.

    The product of two float32 values is exact in float64, so only the
    sum rounds twice (to float64, then to float32).  That can differ
    from a true fused multiply-add only when the float64 sum lands
    exactly on a float32 rounding midpoint.  Python scalars are first
    rounded to float32, as XLA does with weakly typed constants."""
    a, b, c = (
        v.double() if torch.is_tensor(v) else float(np.float32(v))
        for v in (a, b, c)
    )
    return (a * b + c).float()


def div(a, b) -> torch.Tensor:
    """``a / b`` rounded once, also when one side is a Python scalar.

    PyTorch computes ``scalar / tensor`` as a reciprocal times the
    scalar (two roundings), and on CUDA ``tensor / scalar`` as a
    multiply by the scalar's reciprocal; XLA divides.  The scalar
    becomes a device tensor here (a fill, not a host copy)."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, float(np.float32(a)))
    if not torch.is_tensor(b):
        b = torch.full((), float(np.float32(b)), dtype=a.dtype,
                       device=a.device)
    return a / b


def _rows(src, idx: torch.Tensor, dtype) -> torch.Tensor:
    """``src`` (tensor or Python scalar) as one value per row of ``idx``,
    without a host-to-device copy."""
    if torch.is_tensor(src):
        return src.to(dtype).expand(idx.shape)
    return torch.full(idx.shape, src, dtype=dtype, device=idx.device)


def _winners(idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per row, the position of the last valid row with the same index,
    or -1.  O(R**2) compares; R is one wave or one tick of requests."""
    R = idx.shape[0]
    pos = torch.arange(R, device=idx.device)
    same = (idx[:, None] == idx[None, :]) & valid[None, :]
    return torch.where(same, pos[None, :], -1).amax(dim=1)


def set_last(
    dst: torch.Tensor,
    idx: torch.Tensor,
    src,
    valid: torch.Tensor,
) -> torch.Tensor:
    """In place ``dst[idx[r]] = src[r]`` for every valid row ``r``.

    Invalid rows write nothing, and when an index repeats among valid
    rows the last one wins: the semantics of
    ``dst.at[where(valid, idx, N)].set(src, mode="drop")`` under XLA on
    the CPU.  ``idx`` must lie in ``[0, N)`` on every row (invalid rows
    included); ``src`` is a tensor of shape ``(R,)`` or a scalar."""
    src = _rows(src, idx, dst.dtype)
    win = _winners(idx, valid)
    val = torch.where(
        win >= 0, src[win.clamp(min=0)], dst[idx]
    )
    # every row aimed at one index now carries the same value, so the
    # order in which repeats land no longer matters
    dst[idx] = val
    return dst
