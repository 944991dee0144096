"""The exact three-term bf16 split behind the port's fp32 attention, on the
CPU.

``csrc/flash_attention.cu`` runs fp32 attention on the bf16 tensor cores:
every fp32 operand of Q K^T and of P V is the exact sum h + m + l of three
bf16 values (h is x truncated to bf16, m the truncation of x - h, l what is
left), a bf16 x bf16 product is exact in fp32, and each product takes the
six significant cross terms -- l*h, h*l, m*m, m*h, h*m, h*h, summed small to
large.  These tests emulate that attention in plain torch and hold it to the
port's plain version and to the JAX package's reference at bge-large-zh-
v1.5's serving shape and at a causal GQA shape of hymba-1.5b's head layout
at a narrow width, on seeded inputs.  They also show why three terms are
taken: two miss the limit.  The kernel itself runs only on the card
(``tests/test_torch_kernels_card.py``).
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_mask  # noqa: E402

TOL = 1e-6                      # of the output's largest magnitude
# (A term, B term) of the products the kernel takes, small to large; the
# terms are h 0, m 1, l 2
PRODUCTS = [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)]
# (B, H, KV, S, hd, causal, window, kv_len)
SHAPES = {
    # bge-large-zh-v1.5 at B 16 x S 96, ragged rows and padding rows
    "bge": (16, 16, 16, 96, 64, False, 0, [96, 75, 0, 48] * 4),
    # hymba-1.5b's head layout (G = 5, hd 64), causal with a sliding window,
    # at 10 heads on 2 and an S off the 32-key tile
    "hymba_narrow": (2, 10, 2, 130, 64, True, 100, [130, 130]),
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


def split_attention(q, k, v, *, causal, window, kv_len, terms):
    """The kernel's fp32 attention with both products split: scores, masks
    and the softmax as the plain version has them, P split like q and k."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, hd)
    s = split_matmul(qg, k.transpose(-1, -2)[:, :, None], terms) \
        * (1.0 / math.sqrt(hd))
    valid = attention_mask(B, Sq, Sk, causal=causal, window=window,
                           kv_len=kv_len, device=q.device)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    pv = split_matmul(p, v[:, :, None], terms)
    return (pv / den).reshape(B, H, Sq, hd)


@functools.lru_cache(maxsize=None)
def _case(name):
    """Seeded standard-normal q, k, v as chip_smoke makes them, the port's
    plain output and the JAX reference's."""
    B, H, KV, S, hd, causal, window, kv_len = SHAPES[name]
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, n, S, hd), np.float32)
               for n in (H, KV, KV))
    kvl = np.asarray(kv_len, np.int32)
    kw = dict(causal=causal, window=window)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    plain = attention_ref(qt, kt, vt, kv_len=torch.from_numpy(kvl), **kw)
    ref = np.array(jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), kv_len=jnp.asarray(kvl),
                                       **kw))
    return qt, kt, vt, torch.from_numpy(kvl), kw, plain, torch.from_numpy(ref)


def _err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_three_term_split_matches_plain_and_jax(name):
    q, k, v, kvl, kw, plain, ref = _case(name)
    got = split_attention(q, k, v, kv_len=kvl, terms=3, **kw)
    assert torch.isfinite(got).all()
    assert _err(got, plain) <= TOL
    assert _err(got, ref) <= TOL
    # rows with no valid key come out as zeros, as in the plain version
    assert (got[kvl == 0] == 0).all()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_two_terms_miss_the_limit(name):
    """Without l, each operand keeps 16 of fp32's 24 significant bits."""
    q, k, v, kvl, kw, plain, _ = _case(name)
    got = split_attention(q, k, v, kv_len=kvl, terms=2, **kw)
    assert _err(got, plain) > TOL


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_split_is_exact_in_bf16_terms(name):
    """h + m + l is x bit for bit, for q, k, v and the probabilities, and
    each term is a bf16 value (its low 16 bits are zero)."""
    q, k, v, kvl, kw, _, _ = _case(name)
    s = q[:, :1] @ k[:, :1].transpose(-1, -2) / 8.0
    probs = torch.exp(s - s.amax(-1, keepdim=True))
    for x in (q, k, v, probs):
        h, m, lo = split(x, 3)
        assert torch.equal(h + m + lo, x)
        for t in (h, m, lo):
            assert not (t.view(torch.int32) & 0xFFFF).any()
