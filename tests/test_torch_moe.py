"""The port's MoE block against the JAX reference, on the CPU.

``layers.apply_moe`` (one global dispatch over every token) and
``layers._apply_moe_row`` (one dispatch a batch row) against the
reference's functions of the same names, on the reference's own weights
(``params_from_numpy``) and the same numpy inputs:

- fp32: outputs within 1e-5 of their largest magnitude, the load-balance
  loss within 1e-6;
- the routing itself: expert ids, queue slots and the ``keep`` mask equal
  the reference's (``lax.top_k``, then its one-hot cumsum ranking, written
  out below in numpy) under a router rigged to tie exactly (small integers,
  so every dot product is exact in any order) and one skewed to overflow
  capacity;
- bf16: outputs within 2e-2 of their largest magnitude.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro import perf_flags as jflags  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.embedder import params_from_numpy  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
# the smoke config (4 experts, top 2) and a wider one (16 experts, top 4)
SHAPES = {"E4K2": {}, "E16K4": {"num_experts": 16, "experts_per_token": 4}}
DISPATCH = {"global": (jL.apply_moe, L.apply_moe),
            "row": (jL._apply_moe_row, L._apply_moe_row)}
Y_REL, AUX_ABS, BF16_REL = 1e-5, 1e-6, 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(shape):
    kw = SHAPES[shape]
    return (jax_get_config(ARCH).smoke().replace(**kw),
            get_config(ARCH).smoke().replace(**kw))


def reference_params(jc, dtype=jnp.float32):
    """The reference's ``init_moe`` tree, as jax arrays and on the port."""
    p = jL.init_moe(jax.random.PRNGKey(0), jc, dtype)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def run_both(dispatch, jc, tc, jp, tp, x):
    jf, tf = DISPATCH[dispatch]
    want_y, want_aux = jf(jp, jc, jnp.asarray(x))
    got_y, got_aux = tf(tp, tc, torch.from_numpy(np.asarray(x)))
    return (np.asarray(want_y, np.float32), float(want_aux),
            got_y.float().numpy(), float(got_aux))


def assert_rel(got, want, rel):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_moe_matches_jax_in_fp32(shape, dispatch):
    jc, tc = configs(shape)
    jp, tp = reference_params(jc)
    x = np.random.default_rng(0).standard_normal(
        (3, 10, tc.d_model)).astype(np.float32)
    want_y, want_aux, got_y, got_aux = run_both(dispatch, jc, tc, jp, tp, x)
    assert got_y.shape == x.shape
    assert_rel(got_y, want_y, Y_REL)
    assert abs(got_aux - want_aux) <= AUX_ABS


@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
def test_moe_matches_jax_in_bf16(dispatch):
    jc, tc = configs("E16K4")
    jp, tp = reference_params(jc, jnp.bfloat16)
    assert tp["w_gate"].dtype == torch.bfloat16
    x = np.random.default_rng(1).standard_normal(
        (2, 12, tc.d_model)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jf, tf = DISPATCH[dispatch]
    want_y, want_aux = jf(jp, jc, xb)
    got_y, got_aux = tf(tp, tc, torch.from_numpy(
        np.array(xb, np.float32)).bfloat16())
    assert got_y.dtype == torch.bfloat16
    assert_rel(got_y.float().numpy(), np.asarray(want_y, np.float32),
               BF16_REL)
    assert abs(float(got_aux) - float(want_aux)) <= AUX_ABS


def reference_routing(jc, router, x, cap):
    """The reference's routing of x (R, N, D), each row its own dispatch:
    expert ids from ``lax.top_k`` of its fp32 softmax, then each
    assignment's place in its expert's queue by the one-hot cumsum of
    ``layers.apply_moe``, in numpy.  Returns (eidx, slot, keep)."""
    E, K = jc.num_experts, jc.experts_per_token
    logits = (jnp.asarray(x) @ jnp.asarray(router)).astype(jnp.float32)
    _, eidx = lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    eidx = np.asarray(eidx)
    flat = eidx.reshape(eidx.shape[0], -1)                       # (R, N*K)
    onehot = (flat[..., None] == np.arange(E)).astype(np.int64)
    place = (np.cumsum(onehot, axis=1) * onehot).sum(-1) - 1
    keep = place < cap
    slot = np.where(keep, flat * cap + place, E * cap)
    return eidx, slot, keep


def rigged_router(kind, D, E):
    """Small integers, so x @ router is exact in any summation order.
    "tie": experts 1 and 2 have the same column, 3 is all zeros (it ties
    with whatever else scores 0); "skew": expert 2's column is large and
    positive, so with the positive x below every token picks it and its
    queue overflows."""
    rng = np.random.default_rng(5)
    w = rng.integers(-2, 3, (D, E)).astype(np.float32)
    if kind == "tie":
        w[:, 2] = w[:, 1]
        w[:, 3] = 0.0
    else:
        w[:, 2] = 3.0
    return w


@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
@pytest.mark.parametrize("kind", ["tie", "skew"])
def test_slots_and_keep_equal_the_reference(kind, dispatch):
    jc, tc = configs("E4K2")
    E, K, D = tc.num_experts, tc.experts_per_token, tc.d_model
    jp, tp = reference_params(jc)
    router = rigged_router(kind, D, E)
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    rng = np.random.default_rng(6)
    lo = 0 if kind == "skew" else -1
    x = rng.integers(lo, 2, (3, 8, D)).astype(np.float32)
    B, S = x.shape[:2]
    rows = x.reshape(1, B * S, D) if dispatch == "global" else x
    N = rows.shape[1]
    cap = int(math.ceil(N * K / E * jc.capacity_factor))
    want_eidx, want_slot, want_keep = reference_routing(jc, router, rows, cap)
    _, _, eidx = L.moe_route(tp, tc, torch.from_numpy(rows))
    slot, keep = L.moe_slots(eidx.reshape(rows.shape[0], -1), E, cap)
    np.testing.assert_array_equal(eidx.numpy(), want_eidx)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if kind == "tie":
        # experts 1 and 2 always tie; where the top K took only one of
        # them, the tie fell on the cut, and the lower id won
        picked1, picked2 = ((want_eidx == e).any(-1) for e in (1, 2))
        one = picked1 ^ picked2
        assert one.any() and picked1[one].all()
    else:                   # capacity overflowed: some assignments dropped
        assert (~want_keep).any() and (want_eidx == 2).any(-1).all()
    want_y, want_aux, got_y, got_aux = run_both(dispatch, jc, tc, jp, tp, x)
    assert_rel(got_y, want_y, Y_REL)
    assert abs(got_aux - want_aux) <= AUX_ABS


def test_the_flag_picks_the_row_dispatch():
    """Off, ``apply_moe`` is the per-row dispatch over one row of every
    token; on, over each batch row.  Under the skewed router every token
    picks expert 2, and the two drop different assignments: the last 45
    of its 120 (capacity 75), against the last 15 of each row's 40
    (capacity 25)."""
    jc, tc = configs("E4K2")
    _, tp = reference_params(jc)
    tp = {**tp, "router": torch.from_numpy(
        rigged_router("skew", tc.d_model, tc.num_experts))}
    x = torch.from_numpy(np.random.default_rng(7).integers(
        0, 2, (3, 40, tc.d_model)).astype(np.float32))
    row, _ = L._apply_moe_row(tp, tc, x)
    flat, _ = L._apply_moe_row(tp, tc, x.reshape(1, 120, -1))
    assert torch.equal(L.apply_moe(tp, tc, x)[0], flat.reshape(x.shape))
    assert not torch.equal(row, flat.reshape(x.shape))
    try:
        perf_flags.set_flags(**perf_flags.parse_opt("moe_row_dispatch=1"))
        assert torch.equal(L.apply_moe(tp, tc, x)[0], row)
    finally:
        perf_flags.reset_flags()
    assert not jflags.FLAGS.moe_row_dispatch
