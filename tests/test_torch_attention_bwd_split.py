"""The arithmetic of the port's attention backward on the tensor cores,
emulated on the CPU.

``csrc/flash_attention_bwd.cu`` runs all five products of the backward
(S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) on bf16
``mma.sync`` with fp32 accumulators:

- bf16: the inputs are bf16, so S and dP sum exact products in fp32;
  P = 2^(S * scale * log2 e - lse * log2 e) and dS = P (dP - D) are fp32,
  and P^T, dS^T and dS are rounded to bf16 before their products;
- fp32: every operand of the five products, P^T and dS^T too, is the exact
  sum h + m + l of three bf16 values, and each product takes the six
  significant cross terms (l*h, h*l, m*m, m*h, h*m, h*h), summed small to
  large.

These tests emulate both in plain torch and hold them to the port's plain
backward, ``attention_bwd_ref``: bf16 at cosine 0.999 against it in bf16;
fp32 within 1e-6 of each gradient's largest magnitude against it run in
float64 on the same inputs (its oracle mode: the emulation's own error,
where two fp32 computations summed in other orders differ by up to 1.2e-6
at Sq 16 over Sk 150).  In fp32 they also hold it to ``jax.grad`` of the
reference's training attention (``layers.flash_attention_jnp``), as
``tests/test_torch_attention_grad.py`` holds the plain backward, on seeded
numpy inputs: causal attention in stablelm-1.6b's head layout, GQA with
G 4 at hd 128, a sliding window with a ragged kv_len and a row of none, and
Sq != Sk.  The reference's jnp attention gives a row with no valid key the
mean of the values (the port: zeros), so against JAX the output gradient of
such rows is zero.  They also show why three terms are taken: two miss the
fp32 bar.  The kernel itself runs only on the card
(``tests/test_torch_kernels_card.py``).
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jL  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.kernels.flash_attention.ref import \
    attention_mask  # noqa: E402

TOL = 1e-6                      # fp32: of each gradient's largest magnitude
JAX_TOL = 1e-5                  # as tests/test_torch_attention_grad.py
COSINE = 0.999                  # bf16
LOG2E = 1.4426950408889634
# (A term, B term) of the products the kernel takes, small to large; the
# terms are h 0, m 1, l 2
PRODUCTS = [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)]
# (B, H, KV, Sq, Sk, hd, causal, window, kv_len)
SHAPES = {
    # stablelm-1.6b's head layout (G 1, hd 64), causal, at 4 heads
    "stablelm_causal": (2, 4, 4, 96, 96, 64, True, 0, None),
    # GQA with 4 query heads a KV head at hd 128
    "gqa_G4_hd128": (1, 8, 2, 80, 80, 128, True, 0, None),
    # a sliding window over a ragged kv_len, one row with no key at all
    "window_ragged": (3, 4, 2, 70, 70, 64, True, 24, [70, 37, 0]),
    # queries over other keys (whisper's cross attention, narrowed)
    "sq_ne_sk": (2, 4, 4, 16, 150, 64, False, 0, [150, 70]),
}


def _bf16_top(t: torch.Tensor) -> torch.Tensor:
    """fp32 t truncated to bf16 (its low 16 bits cleared), as fp32."""
    return (t.view(torch.int32) & -65536).view(torch.float32)


def split(x: torch.Tensor, terms: int) -> list:
    """x (fp32) as ``terms`` bf16-valued fp32 tensors, largest first: each
    term truncates what the ones before left."""
    out, rest = [], x
    for _ in range(terms):
        t = _bf16_top(rest)
        out.append(t)
        rest = rest - t
    return out


def split_matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b from the splits of both: one fp32 product for each kept pair
    of terms, summed small to large (with two terms: m*m, m*h, h*m, h*h)."""
    sa, sb = split(a, terms), split(b, terms)
    acc = None
    for i, j in PRODUCTS:
        if i < terms and j < terms:
            p = sa[i] @ sb[j]
            acc = p if acc is None else acc + p
    return acc


def emulated_bwd(q, k, v, o, do, lse, *, causal, window, kv_len, terms):
    """(dq, dk, dv) as the kernel computes them: ``terms`` None for bf16
    (P^T, dS^T and dS rounded to bf16 before their products), else fp32
    with every product split in ``terms`` terms."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    mm = (torch.matmul if terms is None
          else functools.partial(split_matmul, terms=terms))
    qf, dof, of = (t.float().reshape(B, KV, G, Sq, hd) for t in (q, do, o))
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    lse = lse.float().reshape(B, KV, G, Sq, 1)
    valid = attention_mask(B, Sq, Sk, causal=causal, window=window,
                           kv_len=kv_len, device=q.device)[:, None, None]
    s = mm(qf, kf.transpose(-1, -2))
    p = torch.exp2(s * (scale * LOG2E) - lse * LOG2E)
    p = torch.where(valid, p, torch.zeros_like(p))
    dp = mm(dof, vf.transpose(-1, -2))
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    if terms is None:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dv = mm(p.transpose(-1, -2), dof).sum(2)
    dk = mm(ds.transpose(-1, -2), qf).sum(2) * scale
    dq = (mm(ds, kf) * scale).reshape(B, H, Sq, hd)
    return tuple(g.to(q.dtype) for g in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _case(name, dtype):
    """Seeded standard-normal q, k, v and dO in ``dtype``, the plain
    forward's output and lse, the keyword arguments, and the query rows
    with a valid key (B, 1, Sq)."""
    B, H, KV, Sq, Sk, hd, causal, window, kv_len = SHAPES[name]
    rng = np.random.default_rng(0)
    q, do = (torch.from_numpy(rng.standard_normal((B, H, Sq, hd),
                                                  np.float32)).to(dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, KV, Sk, hd),
                                                 np.float32)).to(dtype)
            for _ in range(2))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    kw = dict(causal=causal, window=window, kv_len=kvl)
    live = attention_mask(B, Sq, Sk, device="cpu", **kw).any(-1)[:, None]
    do = do * live[..., None]
    out, lse = attention_ref(q, k, v, return_lse=True, **kw)
    return q, k, v, do, out, lse.float(), kw, live


@functools.lru_cache(maxsize=None)
def _exact(name):
    """The fp32 case's gradients from the plain versions run in float64."""
    q, k, v, do, _, _, kw, _ = _case(name, torch.float32)
    q, k, v, do = (t.double() for t in (q, k, v, do))
    out, lse = attention_ref(q, k, v, return_lse=True, **kw)
    return attention_bwd_ref(q, k, v, out, do, lse, **kw)


def _err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _cosine(got, want):
    return torch.nn.functional.cosine_similarity(
        got.float().flatten(), want.float().flatten(), dim=0).item()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_bf16_emulation_matches_plain(name):
    q, k, v, do, out, lse, kw, live = _case(name, torch.bfloat16)
    got = emulated_bwd(q, k, v, out, do, lse, terms=None, **kw)
    want = attention_bwd_ref(q, k, v, out, do, lse, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        assert torch.isfinite(g.float()).all()
        assert _cosine(g, w) >= COSINE
    # a query row with no valid key gets a zero gradient
    assert (got[0].float() * ~live[..., None] == 0).all()


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    """jax.grad of the reference's training attention at the fp32 case's
    inputs, in the port's (B, heads, S, hd) layout."""
    B, H, KV, Sq, Sk, hd, causal, window, kv_len = SHAPES[name]
    q, k, v, do, _, _, _, _ = _case(name, torch.float32)
    mask = None
    if kv_len is not None:
        mask = jnp.asarray(np.arange(Sk)[None] < np.asarray(kv_len)[:, None])

    def f(qj, kj, vj):   # the reference's layout: (B, S, heads, hd)
        return jL.flash_attention_jnp(
            qj, kj, vj, jnp.arange(Sq), jnp.arange(Sk), causal=causal,
            window=window, kv_mask=mask, q_chunk=16, kv_chunk=16)

    tr = lambda t: jnp.asarray(t.numpy().transpose(0, 2, 1, 3))
    _, vjp = jax.vjp(f, tr(q), tr(k), tr(v))
    return [torch.from_numpy(np.asarray(w).transpose(0, 2, 1, 3).copy())
            for w in vjp(tr(do))]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fp32_split_matches_plain_and_jax(name):
    q, k, v, do, out, lse, kw, live = _case(name, torch.float32)
    got = emulated_bwd(q, k, v, out, do, lse, terms=3, **kw)
    for g, w in zip(got, _exact(name)):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert _err(g, w) <= TOL
    for g, w in zip(got, _jax_grads(name)):
        assert _err(g, w) <= JAX_TOL
    assert (got[0] * ~live[..., None] == 0).all()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_two_terms_miss_the_fp32_bar(name):
    """Without l, each operand keeps 16 of fp32's 24 significant bits."""
    q, k, v, do, out, lse, kw, _ = _case(name, torch.float32)
    got = emulated_bwd(q, k, v, out, do, lse, terms=2, **kw)
    assert max(_err(g, w) for g, w in zip(got, _exact(name))) > TOL


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_split_is_exact_for_the_backward_operands(name):
    """h + m + l is x bit for bit for dO and for the probabilities and dS
    the kernel splits in registers, and each term is a bf16 value."""
    B, H, KV, Sq, Sk, hd, *_ = SHAPES[name]
    q, k, v, do, out, lse, kw, _ = _case(name, torch.float32)
    valid = attention_mask(B, Sq, Sk, device="cpu", **kw)[:, None]
    s = (q[:, :1] @ k[:, :1].transpose(-1, -2)) / math.sqrt(hd)
    p = torch.where(valid, torch.exp(s - lse[:, :1, :, None]),
                    torch.zeros_like(s))
    ds = p * ((do[:, :1] @ v[:, :1].transpose(-1, -2))
              - (do[:, :1] * out[:, :1]).sum(-1, keepdim=True))
    for x in (do, p, ds):
        h, m, lo = split(x, 3)
        assert torch.equal(h + m + lo, x)
        for t in (h, m, lo):
            assert not (t.view(torch.int32) & 0xFFFF).any()
