"""XLA CPU semantics that the port reproduces on purpose.

The JAX package is the reference, and on the CPU it computes two things
differently from plain PyTorch:

* **Fused multiply-add.**  XLA's CPU backend contracts a multiply that
  feeds an add into one fused operation (``(1-a)*x + a*y`` becomes
  ``fma(1-a, x, a*y)``), rounding once.  :func:`fma` does the same.
* **Division by a scalar.**  XLA divides; PyTorch multiplies by a
  reciprocal in some scalar cases.  :func:`div` always divides.
* **The order of a sum.**  XLA's CPU backend sums a float32 vector of
  up to 32 elements left to right, and a longer one in windows of 32
  with the padding split across both ends; a cumulative sum is a
  two-level scan over blocks of 16.  PyTorch sums
  in other orders (on the CPU in vector lanes, a cumulative sum in
  float64).  :func:`reduce_sum` and :func:`cumsum` take XLA's orders.
* **Binary search.**  ``jnp.searchsorted`` bisects in a fixed number
  of steps; on a table that is not sorted everywhere (a long float32
  cumulative sum) it finds another index than a lower bound does.
  :func:`searchsorted` takes jnp's steps.
* **The C library's float32 math.**  Outside a fused computation XLA's
  CPU backend calls the C library's ``sinf`` and ``powf``, which are
  not correctly rounded and differ from ``torch.sin`` and ``torch.pow``
  in the last bit for a few percent of arguments.  :func:`libm` calls
  the same functions on the host.
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

import ctypes
import ctypes.util
import functools
import operator

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


def _blocks(x: torch.Tensor, b: int) -> torch.Tensor:
    """1-D ``x`` as rows of ``b``, the last padded with zeros."""
    k = -(-x.shape[0] // b)
    if k * b > x.shape[0]:  # x + 0.0 == x: the pad changes no sum
        x = torch.cat([x, x.new_zeros(k * b - x.shape[0])])
    return x.reshape(k, b)


def _fold(parts, squares: bool) -> torch.Tensor:
    """``parts`` summed left to right; with ``squares``, the sum of
    their squares, each square fused into its add."""
    if not squares:
        return functools.reduce(operator.add, parts)
    acc = parts[0] * parts[0]
    for p in parts[1:]:
        acc = fma(p, p, acc)
    return acc


def _windows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (n > 32 along the last axis) as rows of 32 along it:
    ``32·k − n`` zeros padded, ``pad // 2`` in front and the rest
    behind, as XLA's tree-reduction rewrite pads the ``reduce-window``
    it makes of a long sum.  Returns (..., k, 32)."""
    n = x.shape[-1]
    k = -(-n // 32)
    pad = 32 * k - n
    if pad:  # 0.0 + x == x: the pad changes no sum
        front, back = pad // 2, pad - pad // 2
        lead = x.shape[:-1]
        x = torch.cat([x.new_zeros(lead + (front,)), x,
                       x.new_zeros(lead + (back,))], dim=-1)
    return x.reshape(x.shape[:-1] + (k, 32))


def reduce_sum(x: torch.Tensor, squares: bool = False) -> torch.Tensor:
    """``jnp.sum`` of a 1-D float32 tensor in XLA's CPU order; of a
    batch, the sum of each row along the last axis, each in that order
    (one op a column for all rows at once).

    Up to 32 elements XLA sums left to right.  A longer sum becomes a
    ``reduce-window`` of size and stride 32: ``32·k − n`` zeros are
    padded, ``pad // 2`` of them in front and the rest behind, each
    window of 32 is summed left to right, and the ``k`` window sums are
    reduced by the same rule.  This is ``jax.jit(jnp.sum)`` bit for bit
    at every n from 1 to 300 and at 1000, 4097, 10**4, 65537 and 10**6
    (``tests/test_torch_xla_sums.py``).

    With ``squares`` it is ``jnp.sum(x * x)`` inside a fused computation
    (``jnp.std``'s squared deviations): up to 32 elements XLA folds each
    square into its add; above 32 it rounds the squares first and sums
    them by the windows above.  One op per column: a few dozen small ops
    on the card and no host read."""
    n = x.shape[-1]
    if n <= 32:
        return _fold(x.unbind(-1), squares)
    if squares:
        x = x * x
    return reduce_sum(_fold(_windows(x).unbind(-1), False))


def loop_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of each row along the last axis in the order XLA's CPU
    backend takes when the reduction's input is fused into its loop
    (the engine's per-wave dV): above 32 elements the windows of
    :func:`reduce_sum`; up to 32 the loop LLVM vectorizes, 16 lanes
    (two accumulators of 8) over the first ``16·⌊n/16⌋`` elements, the
    lanes added in halves (8, 4, 2, 1), then the rest added left to
    right; below 16 simply left to right.  Bit for bit the live jitted
    engine's dV at 3-66 requests a wave (``tests/test_torch_unrolled.py``,
    ``tests/test_torch_tick.py``)."""
    n = x.shape[-1]
    if n > 32:
        return reduce_sum(x)
    nv = n // 16 * 16
    if not nv:
        return _fold(x.unbind(-1), False)
    acc = _fold(x[..., :nv].unflatten(-1, (nv // 16, 16)).unbind(-2),
                False)
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return _fold((acc[..., 0],) + x[..., nv:].unbind(-1), False)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` of a 1-D float32 tensor in XLA's CPU order (its
    reduce-window rewriter): each block of 16 summed left to right,
    plus the cumulative sum of the earlier blocks' totals, itself
    taken the same way."""
    n = x.shape[0]
    rows = _blocks(x, 16)
    cols = [rows[:, 0]]
    for j in range(1, 16):
        cols.append(cols[-1] + rows[:, j])
    inb = torch.stack(cols, 1)
    if n > 16:
        prefix = cumsum(inb[:, -1])
        inb = torch.cat([inb[:1], inb[1:] + prefix[:-1, None]])
    return inb.reshape(-1)[:n]


def searchsorted(table: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(table, query)`` (side "left") as jnp computes
    it: a bisection of ``ceil(log2(n + 1))`` fixed steps from
    ``(low, high) = (0, n)``, each step comparing ``query <=
    table[(low + high) // 2]``, returning ``high``.  On a sorted table
    that is the lower bound ``torch.searchsorted`` gives; a float32
    cumulative table of 10**6 Zipf weights is not sorted everywhere (its
    rounding steps back in places), and there only the same bisection
    gives the same index.  Returns int64, shaped as ``query``."""
    n = table.shape[0]
    low = torch.zeros(query.shape, dtype=torch.int64, device=query.device)
    high = torch.full(query.shape, n, dtype=torch.int64,
                      device=query.device)
    for _ in range(int(np.ceil(np.log2(n + 1)))):
        mid = (low + high) // 2
        left = query <= table[mid.clamp(max=n - 1)]
        low = torch.where(left, low, mid)
        high = torch.where(left, mid, high)
    return high


@functools.lru_cache(maxsize=None)
def _libm_fn(name: str, nargs: int):
    # find_library needs ldconfig or a compiler; glibc's soname otherwise
    path = ctypes.util.find_library("m") or "libm.so.6"
    fn = getattr(ctypes.CDLL(path), name)
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float] * nargs
    return np.frompyfunc(fn, nargs, 1)


def libm(name: str, *args) -> torch.Tensor:
    """The C library's float32 function ``name`` (``"sinf"``,
    ``"powf"``) elementwise over broadcast CPU tensors or scalars,
    computed on the host: one call per element, for the small
    host-side tables of the workload generators."""
    arrs = [np.asarray(a.numpy() if torch.is_tensor(a) else a, np.float32)
            for a in args]
    out = _libm_fn(name, len(arrs))(*arrs)
    return torch.from_numpy(np.asarray(out, dtype=np.float32))


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
