"""The sum schedules of the CUDA ``route_tick`` kernel, written as scalar
float32 loops one add at a time in the kernel's order, against the plain
version's sums (``core/xla.py``) and chbl's cap, bit for bit.

``csrc/route_select.cu`` sums a wave's steering dV in ``xla.loop_sum``'s
order and chbl's view in ``xla.reduce_sum``'s, one warp at a time: windows
of 32 with +0.0 pads split ``pad // 2`` in front, one lane a window, the
window sums reduced by the same rule; from 16 to 32 terms sixteen lanes,
folded in halves 8, 4, 2, 1 by shuffles, then the rest; the cap
``fma(sum, float32(1/m), 1) * 1.25`` with the fma in float64 rounded once
to float32, as the plain version rounds it.  Only the card runs the
kernel (``tests/test_torch_kernels_cuda.py``); these loops pin down its
schedule on the CPU, at every length the engine gives it: 1-300, 1025,
4097 and 8192 rows a wave (the kernel's ``MAX_RG``), m = 1-300 and 6144
(``MAX_M``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import xla  # noqa: E402
from repro_torch.core.policies.bounded_load import C_LOAD  # noqa: E402
from repro_torch.core.policies.bounded_load import load_cap  # noqa: E402

F32 = np.float32


def _window_sums(x):
    """One level of the kernel's windows: lane w sums padded positions
    32w .. 32w + 31 left to right from the first (a pad is +0.0)."""
    n = len(x)
    k = -(-n // 32)
    front = (32 * k - n) // 2
    out = []
    for w in range(k):
        v = [x[q] if 0 <= q < n else F32(0.0)
             for q in range(32 * w - front, 32 * w - front + 32)]
        acc = v[0]
        for t in v[1:]:
            acc = F32(acc + t)
        out.append(acc)
    return out


def kernel_reduce_sum(x):
    """``warp_reduce_sum``: windows while more than 32 remain, then lane
    0 left to right from the first."""
    x = [F32(t) for t in x]
    while len(x) > 32:
        x = _window_sums(x)
    acc = x[0]
    for t in x[1:]:
        acc = F32(acc + t)
    return acc


def kernel_loop_sum(x):
    """``warp_loop_sum``: reduce_sum above 32; from 16 sixteen lanes (a
    lane holds x[l], plus x[16 + l] at 32 terms), folded by shuffles
    (lane l adds lane l + h for h = 8, 4, 2, 1), then lane 0 adds the
    rest; below 16 left to right."""
    x = [F32(t) for t in x]
    n = len(x)
    if n > 32:
        return kernel_reduce_sum(x)
    nv = n // 16 * 16
    if not nv:
        acc = x[0]
        for t in x[1:]:
            acc = F32(acc + t)
        return acc
    lanes = [x[lane] for lane in range(16)]
    if nv == 32:
        lanes = [F32(lanes[lane] + x[16 + lane]) for lane in range(16)]
    for h in (8, 4, 2, 1):
        lanes = [F32(lanes[lane] + lanes[lane + h]) for lane in range(h)]
    acc = lanes[0]
    for t in x[nv:]:
        acc = F32(acc + t)
    return acc


def kernel_cap(view):
    """chbl's cap in the kernel: ``__dadd_rn(__dmul_rn(sum, inv_m), 1)``
    rounded to float32 by ``__double2float_rn``, times ``c`` in
    float32."""
    s = kernel_reduce_sum(view)
    inv_m = F32(1.0 / len(view))
    mean1 = np.float64(s) * np.float64(inv_m) + np.float64(1.0)
    return F32(F32(mean1) * F32(C_LOAD))


def _terms(n, seed):
    """dV-like terms (zeros where nothing moved, 2·dL + 2 of both signs
    elsewhere, a -0.0) and loads (tenths and wide uniforms)."""
    rng = np.random.default_rng(seed)
    moved = rng.random(n) < 0.4
    dv = np.where(moved, 2 * np.round(rng.standard_normal(n) * 20, 1) + 2,
                  0.0).astype(F32)
    dv[rng.integers(0, n)] = F32(-0.0)
    loads = (rng.random(n) * rng.choice([1.0, 7.0, 1e3])).astype(F32)
    return dv, loads, np.round(rng.random(n) * 8, 1).astype(F32)


def _bits(x):
    return np.asarray(x, F32).tobytes()


@pytest.mark.parametrize("sizes", [range(1, 101), range(101, 201),
                                   range(201, 301), (1025, 4097, 8192)],
                         ids=["1-100", "101-200", "201-300", "long"])
def test_kernel_sum_orders_are_the_plain_sums(sizes):
    for n in sizes:
        for x in _terms(n, n):
            t = torch.as_tensor(x)
            assert _bits(kernel_loop_sum(x)) == _bits(xla.loop_sum(t)), n
            assert _bits(kernel_reduce_sum(x)) == _bits(
                xla.reduce_sum(t)), n


@pytest.mark.parametrize("sizes", [range(1, 151), range(151, 301),
                                   (6144,)],
                         ids=["1-150", "151-300", "6144"])
def test_kernel_cap_is_load_cap(sizes):
    for m in sizes:
        for x in _terms(m, 1000 + m)[1:]:
            assert _bits(kernel_cap(x)) == _bits(load_cap(
                torch.as_tensor(x))), m


def test_the_schedules_reach_their_shapes():
    """The lengths above take every branch: left to right, the lanes
    with and without a rest, one and two levels of windows, with pads
    in front and behind."""
    assert kernel_loop_sum([F32(1.0)] * 15) == F32(15.0)
    assert kernel_loop_sum([F32(1.0)] * 47) == F32(47.0)
    levels = []
    for n in (33, 1100, 8192):
        x, k = list(range(n)), 0
        while len(x) > 32:
            x, k = _window_sums([F32(t) for t in x]), k + 1
        levels.append(k)
    assert levels == [1, 2, 2]
    # a pad in front changes the sign of an all -0.0 window
    assert _bits(kernel_reduce_sum([F32(-0.0)] * 33)) == _bits(F32(0.0))
