"""The port's optimizer and tree utilities against the jitted JAX
reference on the CPU.

``_quantize`` / ``_dequantize`` bit for bit (leaf sizes that are and are
not multiples of 256, several axes); ``adamw_update`` on given
gradients over three steps: float32 bit for bit (params, m, v: XLA's
fused multiply-adds, its ``m / (c1 * den)`` for ``(m / c1) / den`` and
the C library's ``powf`` reproduced); 8-bit: the int8 payloads bit for
bit, the scales within 2 ulp and the params within 1 ulp (inside the
fused update XLA recomputes the dequantized moments in the reduction
that takes each block's max, rounding them elsewhere); ``global_norm``
bit for bit over 1-D leaves and within 2 ulp with leaves of several
axes (XLA windows each axis of such a leaf, the port sums it flat);
``clip_by_global_norm``; the tree helpers' leaf names against the
reference checkpoint's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt.checkpoint import _flatten as jflatten  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.step import TrainState as JState  # noqa: E402
from repro.utils import global_norm as jglobal_norm  # noqa: E402
from repro.utils import tree_bytes as jtree_bytes  # noqa: E402
from repro.utils import tree_count as jtree_count  # noqa: E402

from repro_torch import utils  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.step import TrainState  # noqa: E402

SHAPES = {"a": (7,), "b": (256,), "c": (300,), "d": (1000,),
          "e": (33, 5), "f": (2, 960), "g": (4, 64, 3)}
FLAT = ("a", "b", "c", "d")


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib).max()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_quantize_is_bitwise_the_reference(name):
    x = _tree(1, 1e-2)[name]
    qj, sj = jax.jit(jopt._quantize)(x)
    qt, st = topt._quantize(torch.as_tensor(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dj = jax.jit(jopt._dequantize, static_argnums=2)(qj, sj, x.shape)
    dt = topt._dequantize(qt, st, x.shape)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


@pytest.mark.parametrize("eight_bit", [False, True])
def test_adamw_update_matches_reference(eight_bit):
    params = _tree(0)
    jp, tp = params, _t(params)
    js = jopt.init_adam_state(params, eight_bit=eight_bit)
    ts = topt.init_adam_state(tp, eight_bit=eight_bit)
    step_fn = jax.jit(lambda p, g, s, t: jopt.adamw_update(
        p, g, s, t, lr=3e-4, eight_bit=eight_bit))
    for step in range(3):
        grads = _tree(10 + step, 1e-2)
        jp, js = step_fn(jp, grads, js, jnp.asarray(step, jnp.int32))
        tp, ts = topt.adamw_update(tp, _t(grads), ts, torch.tensor(step),
                                   lr=3e-4, eight_bit=eight_bit)
        for k in SHAPES:
            if eight_bit:
                assert _ulps(tp[k].numpy(), jp[k]) <= 1, (step, k)
            else:
                np.testing.assert_array_equal(tp[k].numpy(),
                                              np.asarray(jp[k]))
            for field in ("m", "v", "m_scale", "v_scale"):
                want = getattr(js, field)
                if want is None:
                    assert getattr(ts, field) is None
                    continue
                got = getattr(ts, field)[k].numpy()
                if field.endswith("scale"):
                    assert _ulps(got, want[k]) <= 2, (step, field, k)
                else:
                    np.testing.assert_array_equal(
                        got, np.asarray(want[k]),
                        err_msg=f"{step} {field} {k}")


def test_global_norm_and_clipping():
    grads = _tree(3, 1e-2)
    flat = {k: grads[k] for k in FLAT}
    assert (utils.global_norm(_t(flat)).numpy()
            == np.asarray(jax.jit(jglobal_norm)(flat)))
    assert _ulps(utils.global_norm(_t(grads)).numpy(),
                 jax.jit(jglobal_norm)(grads)) <= 2
    for max_norm in (1e-3, 1e3):  # clipped, and not
        (jc, jn) = jax.jit(lambda g: jopt.clip_by_global_norm(
            g, max_norm))(flat)
        tc, tn = topt.clip_by_global_norm(_t(flat), max_norm)
        assert tn.numpy() == np.asarray(jn)
        for k in FLAT:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))


def test_tree_helpers_name_leaves_as_the_reference():
    """Leaf order and path names of a TrainState (dicts sorted,
    NamedTuple fields as ``.name``, None skipped) equal the reference
    checkpoint's; counts and bytes too."""
    params = {"embed": {"tokens": np.ones((4, 2), np.float32)},
              "blocks": {"1": {"w": np.ones((2, 3), np.float32)},
                         "0": {"w": np.ones((2, 2), np.float32)}},
              "final_norm": {"scale": np.ones(2, np.float32)}}
    for eight in (False, True):
        jst = JState(params=params,
                     opt=jopt.init_adam_state(params, eight_bit=eight),
                     moe_state={"1": np.ones((2, 4), np.float32)},
                     step=np.zeros((), np.int32))
        tparams = {k: utils.tree_map(torch.as_tensor, v)
                   for k, v in params.items()}
        tst = TrainState(params=tparams,
                         opt=topt.init_adam_state(tparams, eight_bit=eight),
                         moe_state={"1": torch.ones((2, 4))},
                         step=torch.zeros((), dtype=torch.int32))
        want = [n for n, _ in jflatten(jst)]
        assert [n for n, _ in utils.tree_flatten_with_names(tst)] == want
        assert utils.tree_count(tst) == jtree_count(jst)
        assert utils.tree_bytes(tst) == jtree_bytes(jst)
    named = utils.tree_map_with_path_names(lambda n, x: n, params)
    assert named["blocks"]["0"]["w"] == "blocks/0/w"
    leaves = utils.tree_leaves(params)
    again = utils.tree_unflatten_like(params, leaves)
    assert [n for n, _ in utils.tree_flatten_with_names(again)] == \
        [n for n, _ in utils.tree_flatten_with_names(params)]
