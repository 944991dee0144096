"""The exact three-way bf16 split behind the port's weight-only int8 GEMM,
on the CPU.

``csrc/quant_matmul.cu`` forms fp32-accurate products on the bf16 tensor
cores: an fp32 x is the exact sum h + m + l of three bf16 terms (h is x
truncated to bf16, m the truncation of x - h, l what is left), an int8
weight is exact in bf16, and a bf16 x bf16 product is exact in fp32.  These
tests emulate that product in plain torch -- one fp32 product a term,
summed small to large -- and hold it to the port's plain version and to the
JAX package's reference at bge-large-zh-v1.5's projection shapes, on inputs
made as ``chip_smoke.py`` makes them.  They also show why three terms are
taken: two lose the last 8 bits of x.  The kernel itself runs only on the
card (``tests/test_torch_kernels_card.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant_matmul.ref import \
    quant_matmul_ref as jax_quant_matmul_ref  # noqa: E402
from repro_torch.kernels.quant_matmul import (quant_matmul,  # noqa: E402
                                              quant_matmul_ref)

M = 1536                                   # 16 x 96 tokens
# bge-large-zh-v1.5's projections (K, N): q/k/v/o, w_in, w_out
SHAPES = [(1024, 1024), (1024, 4096), (4096, 1024)]
TOL = 1e-5                                 # of the output's largest magnitude


def _inputs(M, K, N, seed=2):
    """As ``chip_smoke._qm_inputs``: standard normal x, uniform int8
    weights, small positive per-column scales."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), np.float32)
    w8 = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = (np.abs(rng.standard_normal(N, np.float32)) * 0.01 + 1e-4)
    return x, w8, s.astype(np.float32)


def _bf16_top(t: torch.Tensor) -> torch.Tensor:
    """fp32 t truncated to bf16 (its low 16 bits cleared), as fp32."""
    return (t.view(torch.int32) & -65536).view(torch.float32)


def split(x: torch.Tensor, terms: int) -> list:
    """x (fp32) as ``terms`` bf16-valued fp32 tensors, largest first, as the
    kernel splits it: each term truncates what the ones before left."""
    out, rest = [], x
    for _ in range(terms):
        t = _bf16_top(rest)
        out.append(t)
        rest = rest - t
    return out


def split_product(x, w8, s, terms):
    """(x @ w8) * s from the split of x: one fp32 product a term, summed
    small to large, the scale applied once."""
    wf = w8.float()
    acc = None
    for t in reversed(split(x, terms)):
        p = t @ wf
        acc = p if acc is None else acc + p
    return acc * s


@functools.lru_cache(maxsize=None)
def _case(K, N):
    x, w8, s = _inputs(M, K, N)
    xt, wt, st = (torch.from_numpy(a) for a in (x, w8, s))
    exact = (xt.double() @ wt.double()) * st.double()
    jax_out = np.array(jax_quant_matmul_ref(jnp.asarray(x), jnp.asarray(w8),
                                            jnp.asarray(s)))
    return xt, wt, st, exact, torch.from_numpy(jax_out)


def test_three_bf16_terms_hold_every_fp32_exactly():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    x *= np.geomspace(1e-30, 1e30, 64, dtype=np.float32)[:, None]
    x[0] = 0.0
    xt = torch.from_numpy(x)
    h, m, l = split(xt, 3)
    for t in (h, m, l):
        assert torch.equal(t.to(torch.bfloat16).float(), t)   # bf16-exact
    assert torch.equal((h + m) + l, xt)                        # no bit lost
    # a bf16 x is its own h: the bf16 instantiation takes one pass
    xb = xt.to(torch.bfloat16).float()
    hb, mb, lb = split(xb, 3)
    assert torch.equal(hb, xb) and not mb.any() and not lb.any()


@pytest.mark.parametrize("K,N", SHAPES, ids=lambda v: str(v))
def test_split_product_matches_the_plain_and_jax_references(K, N):
    xt, wt, st, exact, jax_out = _case(K, N)
    got = split_product(xt, wt, st, 3)
    plain = quant_matmul(xt, wt, st)                 # CPU: the plain version
    assert torch.equal(plain, quant_matmul_ref(xt, wt, st))
    scale = exact.abs().max().item()
    assert (got - plain).abs().max().item() <= TOL * scale
    assert (got - jax_out).abs().max().item() <= TOL * scale


@pytest.mark.parametrize("K,N", SHAPES, ids=lambda v: str(v))
def test_two_terms_lose_what_three_keep(K, N):
    """Against the float64 product: the three-way split is as close as
    fp32 summation allows, the two-way split at least 3x further off (it
    drops the last 8 of x's 24 significant bits)."""
    xt, wt, st, exact, _ = _case(K, N)
    scale = exact.abs().max().item()
    err3 = (split_product(xt, wt, st, 3).double() - exact).abs().max().item()
    err2 = (split_product(xt, wt, st, 2).double() - exact).abs().max().item()
    assert err3 <= 1e-6 * scale
    assert err2 >= 3 * err3
