"""The port's CUDA kernels against their plain PyTorch versions on the card.

Each case launches a kernel through its wrapper, checks that the wrapper
counted exactly one launch, and holds the result against the plain version
on the same inputs, with the limits ``chip_smoke.py`` holds.  This file
imports neither JAX nor the JAX package, so it runs on a machine with a card
and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_card.py

Without a card every case skips.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (attention_ref,  # noqa: E402
                                                 flash_attention)
from repro_torch.kernels.pool_norm import (pool_norm,  # noqa: E402
                                           pool_norm_ref)

pytestmark = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device")

# fp32: the kernel sums in another order than the plain version.  bf16: both
# round P and the output to bf16, so they differ by about one output ulp.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# (B, H, KV, S, hd, causal, window, kv_len)
ATTN_CASES = [
    (2, 4, 4, 24, 16, False, 0, [24, 0]),              # MHA, padding row
    (3, 4, 2, 40, 32, False, 0, [40, 17, 0]),          # GQA G=2, ragged
    (2, 4, 1, 33, 16, False, 0, [33, 1]),              # GQA G=4, kv_len 1
    (2, 2, 2, 48, 32, True, 0, [48, 20]),              # causal + ragged
    (2, 4, 2, 48, 16, True, 12, [48, 30]),             # sliding window
    (2, 4, 4, 70, 128, True, 0, [70, 0]),              # hd 128
    # bge-large-zh-v1.5's attention on the serving path
    (16, 16, 16, 96, 64, False, 0, [96, 75, 0, 48] * 4),
]

# (B, S, D, lens)
POOL_CASES = [(4, 7, 32, [7, 0, 1, 5]),
              (16, 96, 1024, [96, 75, 0, 48] * 4)]   # bge's epilogue


def _ids(cases, fmt):
    return [fmt(*c) for c in cases]


def _on_card(x, dtype):
    return torch.from_numpy(x).to("cuda", getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=_ids(
    ATTN_CASES, lambda B, H, KV, S, hd, c, w, _:
    f"B{B}H{H}KV{KV}S{S}hd{hd}{'c' if c else ''}w{w}"))
def test_attention_kernel_matches_plain(case, dtype):
    B, H, KV, S, hd, causal, window, kv_len = case
    rng = np.random.default_rng(0)
    q = _on_card(rng.standard_normal((B, H, S, hd), np.float32), dtype)
    k, v = (_on_card(rng.standard_normal((B, KV, S, hd), np.float32), dtype)
            for _ in range(2))
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kvl)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window, kv_len=kvl)
    assert torch.isfinite(got).all()
    # a row with no valid key comes out as zeros, as in the plain version
    assert (got[torch.tensor(kv_len, device="cuda") == 0] == 0).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["mean", "cls"])
@pytest.mark.parametrize("case", POOL_CASES, ids=_ids(
    POOL_CASES, lambda B, S, D, _: f"B{B}S{S}D{D}"))
def test_pool_norm_kernel_matches_plain(case, pool, dtype):
    B, S, D, lens = case
    rng = np.random.default_rng(1)
    h = _on_card(rng.standard_normal((B, S, D), np.float32), dtype)
    m = (torch.arange(S, device="cuda")[None]
         < torch.tensor(lens, device="cuda")[:, None]).float()
    before = pool_norm.launches
    got = pool_norm(h, m, pool)
    torch.cuda.synchronize()
    assert pool_norm.launches == before + 1
    assert got.dtype == torch.float32
    assert (got[torch.tensor(lens, device="cuda") == 0] == 0).all()
    torch.testing.assert_close(got, pool_norm_ref(h, m, pool), rtol=0,
                               atol=1e-5)


def test_fp32_embed_refuses_tf32():
    from repro_torch.configs import get_config
    from repro_torch.models.embedder import embed, init_embedder
    from repro_torch.models.quantize import serve_params

    cfg = get_config("bge-large-zh-v1.5").smoke()
    params, cdt = serve_params(
        init_embedder(cfg, torch.Generator("cuda").manual_seed(0),
                      device="cuda"), "fp32")
    toks = torch.ones((2, 8), dtype=torch.int32, device="cuda")
    assert embed(params, cfg, toks, compute_dtype=cdt).shape == (2, cfg.d_model)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            embed(params, cfg, toks, compute_dtype=cdt)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
