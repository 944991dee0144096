"""The plain backward versions of the two kernels that carry gradients on
the card, on the CPU: ``attention_bwd_ref`` and ``rmsnorm_bwd_ref`` against
float64 autograd of the port's own forwards (``attention_ref``,
``rmsnorm_ref``) and against ``jax.grad`` of the reference's
(``layers.flash_attention_jnp``, the reference's training attention, and
``kernels/rmsnorm/ref.rmsnorm_ref``) in fp32.  Then the routers' CPU path
under autograd (``FlashAttentionFn``, ``RMSNormFn``), the forward's
``lse`` and the refusal helper the other routers call on the card.

Attention cases: causal, a sliding window, GQA, a ragged ``kv_len`` with a
row of none, and Sq != Sk (queries over other keys).  A row with no valid
key (kv_len 0, or a window past kv_len) comes out as zeros in the port
(``attention_ref``); the reference's jnp attention gives it the mean of
the values instead, so against JAX the output gradient of such rows is
zero (their gradients are held against float64 autograd).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm.ref import rmsnorm_ref as jrmsnorm_ref  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch.kernels import SERVING_BWD_ITEM, refuse_grad  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, attention_ref, flash_attention, flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import \
    attention_mask  # noqa: E402
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd,  # noqa: E402
                                         rmsnorm_bwd_ref, rmsnorm_ref)

# (B, H, KV, Sq, Sk, hd, causal, window, kv_len)
CASES = [
    (2, 4, 4, 12, 12, 16, True, 0, None),              # causal MHA
    (2, 4, 2, 20, 20, 16, True, 6, None),              # window, GQA G=2
    (3, 6, 2, 10, 10, 8, False, 0, [10, 4, 0]),        # ragged, a row of 0
    (2, 4, 1, 7, 15, 16, False, 0, [15, 9]),           # Sq != Sk, G=4
    (2, 2, 2, 16, 16, 32, True, 5, [16, 11]),          # causal + window + ragged
]
IDS = ["causal", "window_gqa", "ragged_kv_len0", "sq_ne_sk", "all_masks"]


def _inputs(case, dtype, seed=0):
    B, H, KV, Sq, Sk, hd, causal, window, kv_len = case
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, H, Sq, hd)) for _ in range(2))
    k, v = (rng.standard_normal((B, KV, Sk, hd)) for _ in range(2))
    t = [torch.tensor(a, dtype=dtype) for a in (q, k, v, do)]
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    return t, dict(causal=causal, window=window, kv_len=kvl)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_attention_bwd_ref_is_float64_autograd(case):
    (q, k, v, do), kw = _inputs(case, torch.float64)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = attention_ref(q, k, v, **kw)
    want = torch.autograd.grad(out, (q, k, v), do)
    out2, lse = attention_ref(q, k, v, return_lse=True, **kw)
    got = attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                            out2.detach(), do, lse.detach(), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_attention_bwd_ref_matches_jax_grad(case):
    B, H, KV, Sq, Sk, hd, causal, window, kv_len = case
    (q, k, v, do), kw = _inputs(case, torch.float32, seed=1)
    # (B, 1, Sq): the query rows with a valid key (see above)
    live = attention_mask(B, Sq, Sk, causal=causal, window=window,
                          kv_len=kw["kv_len"], device="cpu").any(-1)[:, None]
    do = do * live[..., None]
    out, lse = attention_ref(q, k, v, return_lse=True, **kw)
    got = attention_bwd_ref(q, k, v, out, do, lse, **kw)

    mask = None
    if kv_len is not None:
        mask = jnp.asarray(np.arange(Sk)[None] < np.asarray(kv_len)[:, None])

    def f(qj, kj, vj):   # the reference's layout: (B, S, heads, hd)
        return jL.flash_attention_jnp(
            qj, kj, vj, jnp.arange(Sq), jnp.arange(Sk), causal=causal,
            window=window, kv_mask=mask, q_chunk=8, kv_chunk=8)

    tr = lambda t: jnp.asarray(t.numpy().transpose(0, 2, 1, 3))
    jout, vjp = jax.vjp(f, tr(q), tr(k), tr(v))
    want = vjp(tr(do))
    jout = torch.from_numpy(np.asarray(jout).transpose(0, 2, 1, 3).copy())
    torch.testing.assert_close(out * live[..., None],
                               jout * live[..., None], rtol=0, atol=1e-5)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_is_the_log_sum_exp_of_the_valid_scores(case):
    B, H, KV, Sq, Sk, hd, causal, window, kv_len = case
    (q, k, v, _), kw = _inputs(case, torch.float64, seed=2)
    out, lse = attention_ref(q, k, v, return_lse=True, **kw)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float64
    G = H // KV
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(G, 1)) / math.sqrt(hd)
    valid = attention_mask(B, Sq, Sk, causal=causal, window=window,
                           kv_len=kw["kv_len"], device="cpu")[:, None]
    want = torch.logsumexp(s.masked_fill(~valid, -math.inf), -1)
    none = ~valid.any(-1).expand(B, H, Sq)
    assert (lse[none] == -1e30).all()
    torch.testing.assert_close(lse[~none].double(), want[~none], rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(out, attention_ref(q, k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_carries_gradients_on_the_cpu(dtype):
    case = CASES[4]
    (q, k, v, do), kw = _inputs(case, dtype, seed=3)
    before = flash_attention.launches, flash_attention_bwd.launches
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_attention(qg, kg, vg, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    want_out, lse = attention_ref(q, k, v, return_lse=True, **kw)
    want = flash_attention_bwd(q, k, v, want_out, do, lse, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # CPU tensors take the plain versions: no launch is counted
    assert (flash_attention.launches, flash_attention_bwd.launches) == before
    # and with no gradient asked for, the plain forward, no graph
    with torch.no_grad():
        assert flash_attention(qg, kg, vg, **kw).grad_fn is None


# ---------------------------------------------------------------- rmsnorm --
RMS_SHAPES = [(5, 16), (2, 3, 40), (1, 7)]


@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_rmsnorm_bwd_ref_is_float64_autograd(shape):
    rng = np.random.default_rng(4)
    x, dy = (torch.tensor(rng.standard_normal(shape) * 2) for _ in range(2))
    scale = torch.tensor(1 + 0.3 * rng.standard_normal(shape[-1]))
    xg, sg = x.clone().requires_grad_(), scale.clone().requires_grad_()
    want = torch.autograd.grad(rmsnorm_ref(xg, sg, 1e-5), (xg, sg), dy)
    got = rmsnorm_bwd_ref(x, scale, dy, 1e-5)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_rmsnorm_bwd_ref_matches_jax_grad(shape):
    rng = np.random.default_rng(5)
    x, dy = (rng.standard_normal(shape).astype(np.float32) * 2
             for _ in range(2))
    scale = (1 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s: jrmsnorm_ref(a, s, 1e-5), jnp.asarray(x),
                     jnp.asarray(scale))
    want = vjp(jnp.asarray(dy))
    got = rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(dy), 1e-5)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_carries_gradients_on_the_cpu(dtype):
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((3, 4, 24)), dtype=dtype)
    dy = torch.tensor(rng.standard_normal((3, 4, 24)), dtype=dtype)
    scale = torch.tensor(1 + 0.1 * rng.standard_normal(24),
                         dtype=torch.float32)
    before = rmsnorm.launches, rmsnorm_bwd.launches
    xg, sg = x.clone().requires_grad_(), scale.clone().requires_grad_()
    y = rmsnorm(xg, sg, 1e-5)
    assert y.grad_fn is not None and y.dtype == dtype
    got = torch.autograd.grad(y, (xg, sg), dy)
    want = rmsnorm_bwd_ref(x, scale, dy, 1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert got[1].dtype == torch.float32
    assert (rmsnorm.launches, rmsnorm_bwd.launches) == before


def test_refuse_grad_raises_only_under_autograd():
    t = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        refuse_grad("pool_norm", SERVING_BWD_ITEM, torch.ones(2), t)
    with torch.no_grad():
        refuse_grad("pool_norm", SERVING_BWD_ITEM, t)
    refuse_grad("pool_norm", SERVING_BWD_ITEM, torch.ones(2), None)
