"""The port's CUDA kernels against their plain PyTorch versions on the card.

Each case launches a kernel through its wrapper, checks that the wrapper
counted exactly one launch, and holds the result against the plain version
on the same inputs, with the limits ``chip_smoke.py`` holds.  This file
imports neither JAX nor the JAX package, so it runs on a machine with a card
and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_kernels_card.py

Without a card every case skips.  Besides the forward kernels: the three
backward kernels (attention, RMSNorm and the selective scan) against their
plain backward versions, on views that are not 16-byte aligned, and bit for
bit across two calls; the attention forward's ``lse``, each under autograd,
and the other routers' refusal of autograd on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (attention_ref,  # noqa: E402
                                                 flash_attention)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    decode_attention_ref, flash_decode)
from repro_torch.kernels.pool_norm import (pool_norm,  # noqa: E402
                                           pool_norm_ref)
from repro_torch.kernels.quant_matmul import (quant_matmul,  # noqa: E402
                                              quant_matmul_ref,
                                              quant_matmul_w8a8,
                                              quantize_activations,
                                              quantize_rows, w8a8_matmul,
                                              w8a8_matmul_ref)
from repro_torch.kernels.quant_matmul.ops import MAX_W8A8_K  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref  # noqa: E402


@pytest.fixture(autouse=True)
def card():
    """Decided per test, not at import: every worker collects the same
    tests whether or not it sees a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

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
    # several 64-key tiles: an S that is not a multiple of the tile, a
    # window that ends mid-tile, hd 32 and 128 (hd 128's bf16 tiles take
    # shared memory above 48 KB)
    (2, 4, 2, 130, 64, True, 48, [130, 77]),
    (2, 8, 2, 200, 32, False, 0, [200, 150]),
    (2, 4, 2, 200, 128, True, 100, [200, 131]),
    # bge-large-zh-v1.5's attention on the serving path
    (16, 16, 16, 96, 64, False, 0, [96, 75, 0, 48] * 4),
    # hymba-1.5b's prefill: causal, window 1024, G = 5; the 64-token
    # window and a prompt longer than the window
    (16, 25, 5, 64, 64, True, 1024, [64] * 16),
    (2, 25, 5, 1100, 64, True, 1024, [1100, 1100]),
    # stablelm-1.6b's prefill (32 heads of 64, G = 1, no window) and
    # starcoder2-7b's (36 heads on 4 KV heads of 128, window 4096): the
    # 64-token prompts, and one prompt longer than starcoder2's window
    (16, 32, 32, 64, 64, True, 0, [64] * 16),
    (16, 36, 4, 64, 128, True, 4096, [64] * 16),
    (1, 36, 4, 4160, 128, True, 4096, [4160]),
    # the prefills of granite-moe-3b-a800m (24 on 8 KV heads of 64),
    # qwen3-moe-30b-a3b (32 on 4 of 64), internlm2-20b (48 on 8 of 128)
    # and internvl2-2b (16 on 8 of 128), and internvl2's with its 256
    # patch embeddings before the 64 tokens
    (16, 24, 8, 64, 64, True, 0, [64] * 16),
    (16, 32, 4, 64, 64, True, 0, [64] * 16),
    (16, 48, 8, 64, 128, True, 0, [64] * 16),
    (16, 16, 8, 64, 128, True, 0, [64] * 16),
    (16, 16, 8, 320, 128, True, 0, [320] * 16),
]

# (B, S, D, lens)
POOL_CASES = [(4, 7, 32, [7, 0, 1, 5]),
              (16, 96, 1024, [96, 75, 0, 48] * 4),   # bge's epilogue
              # D not a multiple of 128, nor of the 16-byte vector; S = 1
              (4, 7, 1000, [7, 0, 1, 5]),
              (3, 20, 77, [20, 0, 9]),
              (3, 1, 1024, [1, 0, 1])]


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


# (B, H, KV, Sq, Sk, hd, kv_len): bidirectional attention of Sq queries
# over Sk keys, Sk 1500 = 46 key tiles of 32 and 28 keys: whisper-tiny's
# cross attention in prefill (64 decoder queries over the 1500 encoder
# frames), a short odd case with a row of no valid key and one that ends
# mid-tile, and its encoder's self-attention over the 1500 frames
XATTN_CASES = [(16, 6, 6, 64, 1500, 64, [1500] * 16),
               (2, 6, 6, 7, 1500, 64, [0, 1499]),
               (16, 6, 6, 1500, 1500, 64, [1500] * 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", XATTN_CASES, ids=_ids(
    XATTN_CASES, lambda B, H, KV, Sq, Sk, hd, _: f"B{B}H{H}Sq{Sq}Sk{Sk}"))
def test_attention_kernel_matches_plain_for_queries_over_other_keys(case,
                                                                    dtype):
    B, H, KV, Sq, Sk, hd, kv_len = case
    rng = np.random.default_rng(11)
    q = _on_card(rng.standard_normal((B, H, Sq, hd), np.float32), dtype)
    k, v = (_on_card(rng.standard_normal((B, KV, Sk, hd), np.float32), dtype)
            for _ in range(2))
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=False, kv_len=kvl)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (B, H, Sq, hd)
    want = attention_ref(q, k, v, causal=False, kv_len=kvl)
    assert torch.isfinite(got).all()
    assert (got[kvl == 0] == 0).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])
    # without kv_len every key is valid, as whisper's path calls it
    got = flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(
        got.float(), attention_ref(q, k, v, causal=False).float(), rtol=0,
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


def _unaligned(x, dtype):
    """x on the card as a view whose base is one element past a 16-byte
    boundary (and, where x has more than one dim, whose rows are one
    element longer than x's), so the kernels take their element copies."""
    *lead, n = x.shape
    pad = torch.zeros((*lead, n + 1), dtype=getattr(torch, dtype),
                      device="cuda")
    pad[..., 1:] = _on_card(x, dtype)
    return pad[..., 1:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_takes_unaligned_views(dtype):
    B, H, KV, S, hd = 2, 4, 2, 70, 64
    rng = np.random.default_rng(2)
    q, k, v = (_unaligned(rng.standard_normal((B, S, n, hd), np.float32),
                          dtype).transpose(1, 2) for n in (H, KV, KV))
    assert q.data_ptr() % 16 and q.stride(1) % 8
    kvl = torch.tensor([70, 33], dtype=torch.int32, device="cuda")
    got = flash_attention(q, k, v, causal=True, window=40, kv_len=kvl)
    want = attention_ref(q, k, v, causal=True, window=40, kv_len=kvl)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_norm_mean_takes_an_unaligned_base(dtype):
    B, S, D = 3, 20, 1024
    rng = np.random.default_rng(3)
    flat = _unaligned(rng.standard_normal((1, B * S * D), np.float32), dtype)
    h = flat.reshape(B, S, D)
    assert h.is_contiguous() and h.data_ptr() % 16
    m = (torch.arange(S, device="cuda")[None]
         < torch.tensor([20, 0, 7], device="cuda")[:, None]).float()
    torch.testing.assert_close(pool_norm(h, m, "mean"),
                               pool_norm_ref(h, m, "mean"), rtol=0, atol=1e-5)


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


# ------------------------------------------------------------------ int8 --
# (M, K, N): the JAX package's kernel sweep, then bge-large-zh-v1.5's
# projections at 16 x 96 tokens (q/k/v/o and w_out: K = N = 1024 or
# K = 4096; w_in: N = 4096)
QM_CASES = [(128, 128, 128), (200, 96, 260), (7, 48, 130), (256, 320, 64),
            (1, 16, 24), (1536, 1024, 1024), (1536, 1024, 4096),
            (1536, 4096, 1024),
            # ragged 128 x 128 tiles and K steps of 32 on every side
            (1537, 1000, 4100)]


def _qm_inputs(M, K, N, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K), np.float32)
    w8 = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    s = np.abs(rng.standard_normal(N, np.float32)) * 0.01 + 1e-4
    return x, w8.cuda(), torch.from_numpy(s.astype(np.float32)).cuda()


def _qm_id(c):
    return "M{}K{}N{}".format(*c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", QM_CASES, ids=_qm_id)
def test_quant_matmul_kernel_matches_plain(case, dtype):
    x, w8, s = _qm_inputs(*case)
    x = _on_card(x, dtype)
    before = quant_matmul.launches
    got = quant_matmul(x, w8, s)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    want = quant_matmul_ref(x, w8, s)
    assert got.dtype == x.dtype and got.shape == want.shape
    if dtype == "float32":
        # fp32 FMAs in another order than cuBLAS's: 1e-5 of the output's
        # largest magnitude
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
    else:       # both round one fp32 sum to bf16
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


def test_quant_matmul_holds_fp32_accuracy_at_every_magnitude():
    """fp32 x rows from 1e-30 to 1e30: each row within 1e-5 of its own
    largest output (the three-way bf16 split keeps all 24 bits of x); a zero
    row comes out zero; a row of subnormals is held to 1e-5 of the whole
    output's largest magnitude, since the tensor cores may flush subnormal
    inputs."""
    M, K, N = 64, 1024, 512
    x, w8, s = _qm_inputs(M, K, N, seed=11)
    x[:M - 2] *= np.geomspace(1e-30, 1e30, M - 2, dtype=np.float32)[:, None]
    x[M - 2] = 0.0
    x[M - 1] = (np.random.default_rng(12).uniform(-1, 1, K)
                * np.float32(1e-39)).astype(np.float32)
    assert (np.abs(x[M - 1]) < np.finfo(np.float32).tiny).all()
    x = _on_card(x, "float32")
    before = quant_matmul.launches
    got = quant_matmul(x, w8, s)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    want = quant_matmul_ref(x, w8, s)
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    row_max = want.abs().amax(dim=1)
    assert (err[:M - 2].amax(dim=1) <= 1e-5 * row_max[:M - 2]).all(), (
        (err[:M - 2].amax(dim=1) / row_max[:M - 2]).max().item())
    assert (got[M - 2] == 0).all()
    assert err[M - 1].max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [1024, 1000])
def test_quant_matmul_element_copy_path_on_an_odd_row_stride(N, dtype):
    """An odd row stride (and, at N 1000, a w8 row that is not a multiple
    of 16 bytes) takes the instantiation that copies element by element,
    over many 128 x 128 tiles and K steps."""
    M, K = 300, 1024
    x, w8, s = _qm_inputs(M, K, N, seed=13)
    view = _on_card(np.pad(x, ((0, 0), (0, 1))), dtype)[:, :K]
    assert view.stride(0) % 2 == 1
    before = quant_matmul.launches
    got = quant_matmul(view, w8, s)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    want = quant_matmul_ref(view.contiguous(), w8, s)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


def _edge_rows(K):
    """Random rows at many scales, a zero row, a subnormal row, a row whose
    amax / 127 is subnormal, and exact half-way ties (scale 1; as many as K
    holds)."""
    tiny = np.finfo(np.float32).tiny
    rng = np.random.default_rng(3)
    x = rng.standard_normal((12, K), np.float32)
    x *= np.geomspace(1e-3, 1e3, 12, dtype=np.float32)[:, None]
    x[1] = 0.0
    x[2] *= np.float32(1e-40)
    x[3] = (rng.uniform(-1, 1, K) * tiny * 60).astype(np.float32)
    x[3, 0] = np.float32(tiny * 100)
    x[4] = 0.0
    ties = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5]
    x[4, :8] = ties[:K]
    return x


# (M, K): one row and a few; K of one value and off the 16-value chunk
# (33, 1000, 4097; 4097 held by eight warps): the element path; bge's
# projections (M 1536 at K 1024 and 4096), a warp or four warps a row;
# enough rows at K 1024 that every group quantizes several in turn; and K
# past the 8192 values eight warps hold, so each row is read twice, on the
# vector path (8208, 16384) and the element path (8193)
QR_SHAPES = [(M, K) for M in (1, 7) for K in (1, 33, 1000, 4097)] + [
    (12, 70), (12, 1024), (1536, 1024), (1536, 4096), (20000, 1024),
    (7, 8208), (300, 16384), (5, 8193)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", QR_SHAPES, ids=str)
def test_quantize_rows_kernel_is_bitwise_the_plain_version(shape, dtype):
    M, K = shape
    x = np.random.default_rng(4).standard_normal((M, K), np.float32)
    x[:12] = _edge_rows(K)[:M]
    x = _on_card(x, dtype)
    before = quantize_rows.launches
    x8, s = quantize_rows(x)
    torch.cuda.synchronize()
    assert quantize_rows.launches == before + 1
    w8, ws = quantize_activations(x)
    assert x8.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(x8, w8)
    assert torch.equal(s.view(torch.int32), ws.view(torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [1024, 4096, 8208])
def test_quantize_rows_reads_an_unaligned_row_strided_view(K, dtype):
    """A view one value into each row of a wider array: its base is not
    16-byte aligned, so the kernel takes its element path, with the row
    stride as it is (at K 8208 reading each row twice)."""
    M = 300
    x = np.random.default_rng(6).standard_normal((M, K + 3), np.float32)
    x[:12, 1:K + 1] = _edge_rows(K)
    view = _on_card(x, dtype)[:, 1:K + 1]
    assert view.data_ptr() % 16 != 0 and view.stride(0) == K + 3
    before = quantize_rows.launches
    x8, s = quantize_rows(view)
    torch.cuda.synchronize()
    assert quantize_rows.launches == before + 1
    w8, ws = quantize_activations(view.contiguous())
    assert torch.equal(x8, w8)
    assert torch.equal(s.view(torch.int32), ws.view(torch.int32))


def test_weights_quantize_on_the_card_as_on_the_cpu():
    """serve_params quantizes on the device the weights live on: the card's
    int8 weights and scales are the CPU's (and so the JAX package's)."""
    from repro_torch.models.quantize import quantize_dense

    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 1024, 4096), np.float32) / 32)
    w[0, :, 3] = 0.0
    q, s = quantize_dense(w.cuda())
    qc, sc = quantize_dense(w)
    assert torch.equal(q.cpu(), qc)
    assert torch.equal(s.cpu().view(torch.int32), sc.view(torch.int32))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", QM_CASES, ids=_qm_id)
def test_w8a8_matmul_kernel_matches_plain(case, out):
    """The int32 product is exact on both sides, both round it to fp32 to
    nearest even, and the epilogue is the same fp32 multiplies in the same
    order: equal bit for bit."""
    x, w8, s = _qm_inputs(*case)
    x8, xs = quantize_activations(_on_card(x, "float32"))
    dt = getattr(torch, out)
    before = w8a8_matmul.launches
    got = w8a8_matmul(x8, w8, xs, s, out_dtype=dt)
    torch.cuda.synchronize()
    assert w8a8_matmul.launches == before + 1
    want = w8a8_matmul_ref(x8, w8, xs, s, out_dtype=dt)
    assert got.dtype == dt
    assert torch.equal(got, want)


def _w8a8_extreme(M, K, N, seed=17):
    """x8 and w8 all +-127: column 0 of w8 and row 0 of x8 all +127, so
    out[0, 0]'s sum is K * 127^2 (66,064,384 at K 4096, past 2^24, where
    fp32 keeps only every fourth integer); the other signs random."""
    rng = np.random.default_rng(seed)
    x8 = (127 * rng.choice([-1, 1], (M, K))).astype(np.int8)
    w8 = (127 * rng.choice([-1, 1], (K, N))).astype(np.int8)
    x8[0], w8[:, 0] = 127, 127
    xs = rng.uniform(1e-3, 1e-2, M).astype(np.float32)
    ws = rng.uniform(1e-3, 1e-2, N).astype(np.float32)
    return (torch.from_numpy(a).cuda() for a in (x8, w8, xs, ws))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(96, 4096, 640), (1536, 4096, 4096)],
                         ids=_qm_id)
def test_w8a8_matmul_rounds_sums_past_2_24_as_the_plain_version(case, out):
    """Sums up to 66,064,384 (> 2^24) under both tile sizes: the int -> fp32
    rounding is the plain version's (float64 -> fp32, nearest even)."""
    M, K, N = case
    x8, w8, xs, ws = _w8a8_extreme(M, K, N)
    dt = getattr(torch, out)
    got = w8a8_matmul(x8, w8, xs, ws, out_dtype=dt)
    torch.cuda.synchronize()
    want = w8a8_matmul_ref(x8, w8, xs, ws, out_dtype=dt)
    acc = x8[:1].double() @ w8[:, :1].double()
    assert acc.item() == K * 127 ** 2 > 2 ** 24
    assert torch.equal(got, want)


# (M, K, N) for each tile the launcher picks: 64-row tiles while 128-row
# ones would give fewer than two blocks an SM (M not a multiple of 64,
# and M a multiple), 128-row tiles above (M not a multiple of 128, and an
# odd N that takes the element-copy path for w8)
W8_TILE_CASES = [(1000, 512, 1024), (1536, 1024, 1024), (2100, 256, 2176),
                 (1600, 320, 4099)]


@pytest.mark.parametrize("case", W8_TILE_CASES, ids=_qm_id)
def test_w8a8_matmul_under_each_tile_size(case):
    x, w8, s = _qm_inputs(*case, seed=19)
    x8, xs = quantize_activations(_on_card(x, "float32"))
    before = w8a8_matmul.launches
    got = w8a8_matmul(x8, w8, xs, s)
    torch.cuda.synchronize()
    assert w8a8_matmul.launches == before + 1
    assert torch.equal(got, w8a8_matmul_ref(x8, w8, xs, s))


def test_w8a8_router_is_quantize_rows_then_the_gemm():
    x, w8, s = _qm_inputs(1536, 1024, 1024)
    x = _on_card(x, "float32")
    q0, g0 = quantize_rows.launches, w8a8_matmul.launches
    got = quant_matmul_w8a8(x, w8, s)
    torch.cuda.synchronize()
    assert (quantize_rows.launches, w8a8_matmul.launches) == (q0 + 1, g0 + 1)
    x8, xs = quantize_activations(x)
    assert torch.equal(got, w8a8_matmul_ref(x8, w8, xs, s))


def test_int8_kernels_read_a_row_strided_view():
    """A view whose rows are strided (as a column slice is) is read with
    its row stride, never as if it were contiguous."""
    x, w8, s = _qm_inputs(200, 96, 260)
    wide = _on_card(np.pad(x, ((0, 0), (0, 37))), "float32")
    view = wide[:, :96]
    assert not view.is_contiguous()
    torch.testing.assert_close(quant_matmul(view, w8, s),
                               quant_matmul_ref(view.contiguous(), w8, s),
                               rtol=1e-5, atol=1e-5)
    x8, xs = quantize_rows(view)
    w8_, ws_ = quantize_activations(view.contiguous())
    assert torch.equal(x8, w8_) and torch.equal(xs, ws_)
    wide8 = torch.zeros((200, 128), dtype=torch.int8, device="cuda")
    wide8[:, :96] = x8
    assert torch.equal(w8a8_matmul(wide8[:, :96], w8, xs, s),
                       w8a8_matmul_ref(x8, w8, xs, s))
    # an odd row stride: the element-copy path for x8
    odd8 = torch.zeros((200, 97), dtype=torch.int8, device="cuda")
    odd8[:, :96] = x8
    assert torch.equal(w8a8_matmul(odd8[:, :96], w8, xs, s),
                       w8a8_matmul_ref(x8, w8, xs, s))


def test_int8_wrappers_refuse_what_the_kernels_do_not_take():
    x, w8, s = _qm_inputs(8, 32, 16)
    x = _on_card(x, "float32")
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(x, w8.float(), s)
    with pytest.raises(TypeError, match="int8"):
        quant_matmul_w8a8(x, w8.float(), s)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(x[:, :16], w8.t().contiguous().t()[:16], s)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quant_matmul(x.half(), w8, s)
    k = MAX_W8A8_K + 4
    with pytest.raises(ValueError, match="overflow"):
        w8a8_matmul(torch.zeros((1, k), dtype=torch.int8, device="cuda"),
                    torch.zeros((k, 1), dtype=torch.int8, device="cuda"),
                    torch.ones(1, device="cuda"), torch.ones(1, device="cuda"))


@pytest.mark.parametrize("dtype", ["int8", "int8_w8a8"])
def test_int8_embed_runs_with_tf32_switched_off(dtype):
    """The int8 policies compute in fp32: realising them switches TF32 off,
    so embed's fp32 guard lets them through, and every projection goes
    through the int8 kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models.embedder import embed, init_embedder
    from repro_torch.models.quantize import serve_params, wants_act_quant

    cfg = get_config("bge-large-zh-v1.5").smoke()
    base = init_embedder(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    toks = torch.ones((2, 8), dtype=torch.int32, device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        params, cdt = serve_params(base, dtype)
        before = launch_counts()
        out = embed(params, cfg, toks, compute_dtype=cdt,
                    act_quant=wants_act_quant(dtype))
        torch.cuda.synchronize()
        after = launch_counts()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert out.shape == (2, cfg.d_model) and torch.isfinite(out).all()
    per_layer = 6 * cfg.num_layers
    if dtype == "int8":
        assert after["quant_matmul"] - before["quant_matmul"] == per_layer
    else:
        assert after["w8a8_matmul"] - before["w8a8_matmul"] == per_layer
        # q, k and v share one quantized input (layers.dense_apply_many)
        assert (after["quantize_rows"] - before["quantize_rows"]
                == 4 * cfg.num_layers)


# ------------------------------------------------------------ LM kernels --
# Outputs are held relative to their largest magnitude: fp32 within 1e-4,
# bf16 within 2e-2 (about two bf16 ulps), the limits chip_smoke.py holds.

def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(want.float().abs().max().item(), 1e-30), err


# (R, D): hymba-1.5b's prefill (16 x 64 tokens) and decode rows, an odd D;
# the norm widths of the configs queued next (stablelm-1.6b 2048 is below
# 4096; falcon-mamba-7b 4096, qwen2-72b 8192); a D that is a multiple of 4
# but not of 8 (fp32 vector path, bf16 element path); rows too wide to hold
# in registers (D 4099 on the element path, 20000 on the vector path)
RMS_CASES = [(1024, 1600), (16, 1600), (7, 77), (5, 4096), (3, 8192),
             (9, 1604), (2, 4099), (2, 20000),
             # the served rows: stablelm-1.6b's and falcon-mamba-7b's
             # prefill (16 x 64) and decode (16)
             (1024, 2048), (16, 2048), (1024, 4096), (16, 4096),
             # granite-moe-3b-a800m's d 1536 and internlm2-20b's 6144
             (1024, 1536), (16, 1536), (1024, 6144), (16, 6144)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RMS_CASES, ids=lambda c: "R{}D{}".format(*c))
def test_rmsnorm_kernel_matches_plain(case, dtype):
    R, D = case
    rng = np.random.default_rng(3)
    x = _on_card(rng.standard_normal((R, D), np.float32) * 3, dtype)
    scale = _on_card(1 + 0.1 * rng.standard_normal(D).astype(np.float32),
                     "float32")
    before = rmsnorm.launches
    got = rmsnorm(x, scale, 1e-5)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, rmsnorm_ref(x, scale, 1e-5), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [200, 203], ids=lambda w: f"stride{w}")
def test_rmsnorm_kernel_reads_strided_rows(width, dtype):
    """Rows 200 values apart (16-byte aligned in both dtypes) and 203 apart
    (not: the element path)."""
    rng = np.random.default_rng(4)
    wide = _on_card(rng.standard_normal((2, 9, width), np.float32), dtype)
    scale = _on_card(rng.standard_normal(160).astype(np.float32), "float32")
    x = wide[..., :160]
    _close(rmsnorm(x, scale), rmsnorm_ref(x, scale), dtype)


def _ssm_inputs(B, S, DI, N, dtype, seed=5):
    rng = np.random.default_rng(seed)
    x = _on_card(rng.standard_normal((B, S, DI), np.float32), dtype)
    dt = _on_card(np.log1p(np.exp(rng.standard_normal((B, S, DI))))
                  .astype(np.float32), "float32")           # softplus > 0
    Bm, Cm = (_on_card(rng.standard_normal((B, S, N), np.float32), "float32")
              for _ in range(2))
    A = _on_card(-np.broadcast_to(np.arange(1, N + 1, dtype=np.float32),
                                  (DI, N)).copy(), "float32")
    return x, dt, Bm, Cm, A


# (B, S, DI, N): hymba-1.5b's prefill, then S and DI off the tile sizes,
# then the 1100-token prompt at B 2 (69 time chunks, 200 blocks)
SSM_CASES = [(16, 64, 3200, 16), (2, 50, 200, 16), (3, 33, 130, 16),
             (1, 1, 7, 16), (2, 1100, 3200, 16),
             # falcon-mamba-7b's prefill: d_inner 8192
             (16, 64, 8192, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSM_CASES,
                         ids=lambda c: "B{}S{}DI{}N{}".format(*c))
def test_ssm_scan_kernel_matches_plain(case, dtype):
    x, dt, Bm, Cm, A = _ssm_inputs(*case, dtype)
    before = ssm_scan.launches
    y, h = ssm_scan(x, dt, Bm, Cm, A)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    y_ref, h_ref = ssm_scan_ref(x, dt, Bm, Cm, A)
    assert y.dtype == h.dtype == torch.float32
    # both read the same x and compute in fp32
    _close(y, y_ref, "float32")
    _close(h, h_ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lanes", [2, 8])
@pytest.mark.parametrize("shape", [(2, 300, 200), (3, 33, 130)],
                         ids=lambda c: "B{}S{}DI{}".format(*c))
def test_ssm_scan_under_each_lane_split(shape, lanes, dtype, monkeypatch):
    """Both lane splits, whatever the router picks for the shape, on the
    vector (DI 200) and element-copy (DI 130) paths."""
    from repro_torch.kernels.ssm_scan import ops

    monkeypatch.setattr(ops, "scan_lanes", lambda *_: lanes)
    x, dt, Bm, Cm, A = _ssm_inputs(*shape, 16, dtype)
    dt = dt * 0.05               # a slow decay: h carries far
    y, h = ssm_scan(x, dt, Bm, Cm, A)
    y_ref, h_ref = ssm_scan_ref(x, dt, Bm, Cm, A)
    _close(y, y_ref, "float32")
    _close(h, h_ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_takes_an_unaligned_base(dtype):
    """A contiguous x that starts one element past a 16-byte boundary
    takes the element-copy path."""
    x, dt, Bm, Cm, A = _ssm_inputs(2, 40, 96, 16, dtype)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    xu = flat[1:].view_as(x)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16
    y, h = ssm_scan(xu, dt, Bm, Cm, A)
    y_ref, h_ref = ssm_scan_ref(x, dt, Bm, Cm, A)
    _close(y, y_ref, "float32")
    _close(h, h_ref, "float32")


def test_ssm_scan_reads_column_slices_of_one_projection():
    """The model's B and C are column slices of x_proj's output."""
    x, dt, _, _, A = _ssm_inputs(2, 40, 96, 16, "float32")
    dbc = torch.randn((2, 40, 8 + 32), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
    Bm, Cm = dbc[..., 8:24], dbc[..., 24:]
    y, h = ssm_scan(x, dt, Bm, Cm, A)
    y_ref, h_ref = ssm_scan_ref(x, dt, Bm, Cm, A)
    _close(y, y_ref, "float32")
    _close(h, h_ref, "float32")


# the scan's backward: the forward's shapes, plus hymba-1.5b's training
# shape (B 8 x S 512, d_inner 3200) and falcon-mamba-7b's (B 4, d_inner
# 8192)
SSM_BWD_CASES = SSM_CASES + [(8, 512, 3200, 16), (4, 512, 8192, 16)]
SCAN_GRADS = ("dx", "ddt", "dBm", "dCm", "dA")


def _scan_grads_close(got, want, dtype):
    """Each gradient within 1e-4 of its largest magnitude (fp32 on both
    sides); dx of a bf16 x within one bf16 step there (2^-7 of it), as
    both round it once from fp32."""
    for name, g, w in zip(SCAN_GRADS, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        g, w = g.float(), w.float()
        assert bool(torch.isfinite(g).all()), name
        lim = 2.0 ** -7 if name == "dx" and dtype == "bfloat16" else 1e-4
        assert (g - w).abs().max() <= lim * w.abs().max(), name


@pytest.mark.parametrize("dh", [False, True], ids=["no_dh", "dh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSM_BWD_CASES,
                         ids=lambda c: "B{}S{}DI{}N{}".format(*c))
def test_ssm_scan_backward_kernel_matches_plain(case, dtype, dh):
    """The backward kernel from the forward kernel's chunk states against
    the plain backward, and bit for bit equal across two calls."""
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd, ssm_scan_bwd_ref
    from repro_torch.kernels.ssm_scan.ops import _forward

    x, dt, Bm, Cm, A = _ssm_inputs(*case, dtype)
    B, S, DI, N = case
    rng = np.random.default_rng(11)
    dy = _on_card(rng.standard_normal((B, S, DI), np.float32), "float32")
    dhf = (_on_card(rng.standard_normal((B, DI, N), np.float32), "float32")
           if dh else None)
    states = _forward(x, dt, Bm, Cm, A, True)[2]
    before = ssm_scan_bwd.launches
    got = ssm_scan_bwd(x, dt, Bm, Cm, A, dy, dhf, states)
    again = ssm_scan_bwd(x, dt, Bm, Cm, A, dy, dhf, states)
    torch.cuda.synchronize()
    assert ssm_scan_bwd.launches == before + 2
    _scan_grads_close(got, ssm_scan_bwd_ref(x, dt, Bm, Cm, A, dy, dhf),
                      dtype)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dh", [False, True], ids=["no_dh", "dh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_backward_takes_unaligned_bases(dtype, dh):
    """x and dy that start one element past a 16-byte boundary (DI 96, S
    off the chunk): the element path that reads the tiles and B and C
    without 16-byte pieces, against the plain backward, bit for bit across
    two calls."""
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd, ssm_scan_bwd_ref
    from repro_torch.kernels.ssm_scan.ops import _forward

    B, S, DI, N = 2, 41, 96, 16
    x, dt, Bm, Cm, A = _ssm_inputs(B, S, DI, N, dtype)
    rng = np.random.default_rng(13)
    dy = _on_card(rng.standard_normal((B, S, DI), np.float32), "float32")
    dhf = (_on_card(rng.standard_normal((B, DI, N), np.float32), "float32")
           if dh else None)

    def unaligned(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        u = flat[1:].view_as(t)
        u.copy_(t)
        assert u.is_contiguous() and u.data_ptr() % 16
        return u

    xu, dyu = unaligned(x), unaligned(dy)
    states = _forward(x, dt, Bm, Cm, A, True)[2]
    got = ssm_scan_bwd(xu, dt, Bm, Cm, A, dyu, dhf, states)
    again = ssm_scan_bwd(xu, dt, Bm, Cm, A, dyu, dhf, states)
    torch.cuda.synchronize()
    _scan_grads_close(got, ssm_scan_bwd_ref(x, dt, Bm, Cm, A, dy, dhf),
                      dtype)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_autograd_runs_both_kernels(dtype):
    """A tiny scan under autograd: the forward kernel once and the backward
    kernel once, with autograd's gradient of the plain scan, also through
    column slices of one projection (the model's B and C)."""
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd

    x, dt, _, _, A = _ssm_inputs(2, 37, 48, 16, dtype)
    dbc = torch.randn((2, 37, 8 + 32), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
    rng = np.random.default_rng(12)
    dy = _on_card(rng.standard_normal((2, 37, 48), np.float32), "float32")
    dhf = _on_card(rng.standard_normal((2, 48, 16), np.float32), "float32")
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, dbc, A)]
    before = ssm_scan.launches, ssm_scan_bwd.launches
    y, h = ssm_scan(leaves[0], leaves[1], leaves[2][..., 8:24],
                    leaves[2][..., 24:], leaves[3])
    got = torch.autograd.grad((y, h), leaves, (dy, dhf))
    torch.cuda.synchronize()
    assert (ssm_scan.launches, ssm_scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    plain = [t.detach().clone().requires_grad_() for t in (x, dt, dbc, A)]
    yr, hr = ssm_scan_ref(plain[0], plain[1], plain[2][..., 8:24],
                          plain[2][..., 24:], plain[3])
    want = torch.autograd.grad((yr, hr), plain, (dy, dhf))
    for name, g, w in zip(("dx", "ddt", "ddbc", "dA"), got, want):
        assert g.dtype == w.dtype, name
        g, w = g.float(), w.float()
        lim = 2.0 ** -7 if name == "dx" and dtype == "bfloat16" else 1e-4
        assert (g - w).abs().max() <= lim * w.abs().max(), name


def _ring_kpos(Sc, pos):
    """Slot positions after writing positions 0..pos into a ring of Sc
    slots (slot = position % Sc); unwritten slots are -1."""
    kpos = np.full(Sc, -1, np.int32)
    for p in range(max(0, pos - Sc + 1), pos + 1):
        kpos[p % Sc] = p
    return torch.from_numpy(kpos).cuda()


# (B, KV, G, hd, Sc, pos, window): hymba-1.5b's last decode step of a
# 64 + 16 token generation; a full ring of 1024 slots that has wrapped,
# under its window and under a narrower one; empty slots; no valid slot
FD_CASES = [(16, 5, 5, 64, 80, 79, 1024), (2, 5, 5, 64, 1024, 1100, 1024),
            (2, 5, 5, 64, 1024, 1100, 1000), (3, 2, 4, 32, 80, 40, 0),
            (2, 1, 3, 128, 70, 69, 16), (2, 2, 2, 64, 16, -1, 0),
            # one (row, KV head) and 4096 slots: a full cluster of 8 blocks
            # of 512 slots, the window's valid slots in one or two of them
            (1, 1, 5, 64, 4096, 5000, 1024), (1, 1, 5, 64, 4096, 5000, 1000),
            # 200 slots over 7 blocks of 29: split boundaries inside every
            # 64-slot tile
            (1, 2, 4, 64, 200, 199, 0),
            # starcoder2-7b's decode: 36 heads on 4 KV heads of 128, window
            # 4096 (G 9: two passes of 8 query heads)
            (1, 4, 9, 128, 4096, 5000, 4096),
            # the served decode steps of stablelm-1.6b (32 KV heads, G 1,
            # no window) and starcoder2-7b (G 9 x hd 128) on 80 slots
            (16, 32, 1, 64, 80, 79, 0), (16, 4, 9, 128, 80, 79, 4096),
            # those of granite-moe-3b-a800m (G 3 x hd 64), qwen3-moe-30b-a3b
            # (G 8 x hd 64) and internlm2-20b (G 6 x hd 128), and
            # internvl2-2b's (G 2 x hd 128), whose cache keeps 256 slots
            # for patches past the 80 of its prompt and new tokens
            (16, 8, 3, 64, 80, 79, 0), (16, 4, 8, 64, 80, 79, 0),
            (16, 8, 6, 128, 80, 79, 0), (16, 8, 2, 128, 336, 79, 0),
            # whisper-tiny's decoder self-attention (6 KV heads, G 1, hd 64)
            (16, 6, 1, 64, 80, 79, 0)]
FD_DTYPES = [("float32", "float32"), ("bfloat16", "float32"),
             ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("dtypes", FD_DTYPES, ids=lambda d: "q-{}-cache-{}"
                         .format(*d))
@pytest.mark.parametrize("case", FD_CASES,
                         ids=lambda c: "B{}KV{}G{}hd{}Sc{}pos{}w{}".format(*c))
def test_flash_decode_kernel_matches_plain(case, dtypes):
    B, KV, G, hd, Sc, pos, window = case
    qdt, cdt = dtypes
    rng = np.random.default_rng(6)
    q = _on_card(rng.standard_normal((B, KV, G, hd), np.float32), qdt)
    k, v = (_on_card(rng.standard_normal((B, Sc, KV, hd), np.float32), cdt)
            for _ in range(2))
    kpos = _ring_kpos(Sc, pos)
    before = flash_decode.launches
    got = flash_decode(q, k, v, kpos, pos, window=window)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = decode_attention_ref(q, k, v, kpos, pos, window=window)
    if pos < 0:                                   # no valid slot: zeros
        assert (got == 0).all() and (want == 0).all()
    else:
        _close(got, want, qdt)


@pytest.mark.parametrize("dtypes", FD_DTYPES, ids=lambda d: "q-{}-cache-{}"
                         .format(*d))
@pytest.mark.parametrize("view", ["q", "cache"])
def test_flash_decode_takes_unaligned_views(view, dtypes):
    """A q view, or a cache view, whose base is one element past a 16-byte
    boundary and whose rows are one element longer than hd: q is read
    element by element anyway, the cache takes the element-load path."""
    B, KV, G, hd, Sc, pos = 2, 5, 5, 64, 300, 299
    qdt, cdt = dtypes
    rng = np.random.default_rng(10)
    qn = rng.standard_normal((B, KV, G, hd), np.float32)
    kn, vn = (rng.standard_normal((B, Sc, KV, hd), np.float32)
              for _ in range(2))
    if view == "q":
        q = _unaligned(qn, qdt)
        k, v = _on_card(kn, cdt), _on_card(vn, cdt)
        assert q.data_ptr() % 16
    else:
        q = _on_card(qn, qdt)
        k, v = _unaligned(kn, cdt), _unaligned(vn, cdt)
        assert k.data_ptr() % 16 and v.stride(1) % 8
    kpos = _ring_kpos(Sc, pos)
    before = flash_decode.launches
    got = flash_decode(q, k, v, kpos, pos)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    _close(got, decode_attention_ref(q, k, v, kpos, pos), qdt)


def test_flash_decode_reads_a_layer_of_the_stacked_cache_and_a_q_view():
    """The LM passes one layer of an (L, B, Sc, KV, hd) cache and q as a
    view of the (B, 1, H*hd) projection."""
    rng = np.random.default_rng(8)
    cache = _on_card(rng.standard_normal((3, 2, 40, 2, 32), np.float32),
                     "float32")
    proj = _on_card(rng.standard_normal((2, 1, 3 * 2 * 32 + 8), np.float32),
                    "float32")
    q = proj[..., :192].reshape(2, 2, 3, 32)
    kpos = _ring_kpos(40, 39)
    got = flash_decode(q, cache[1], cache[2], kpos, 39)
    _close(got, decode_attention_ref(q.contiguous(), cache[1], cache[2],
                                     kpos, 39), "float32")


# (B, KV, G, hd, Sc, pos, window): qwen2-72b's decode shard (G 8 x hd 128,
# one 1024-slot shard of a 4096-slot cache, all valid), a shard the
# window half covers, hymba's served shape, and a shard with no valid slot
FD_LSE_CASES = [(4, 8, 8, 128, 1024, 1023, 0),
                (2, 8, 8, 128, 1024, 1500, 1000),
                (16, 5, 5, 64, 80, 79, 1024), (3, 8, 8, 128, 64, -1, 0)]


@pytest.mark.parametrize("dtypes", FD_DTYPES, ids=lambda d: "q-{}-cache-{}"
                         .format(*d))
@pytest.mark.parametrize("case", FD_LSE_CASES,
                         ids=lambda c: "B{}KV{}G{}hd{}Sc{}pos{}w{}".format(*c))
def test_flash_decode_lse_matches_plain(case, dtypes):
    """The optional log-sum-exp output: each row's max score plus the log of
    its denominator, -1e30 and a zero output for a shard with no valid
    slot."""
    B, KV, G, hd, Sc, pos, window = case
    qdt, cdt = dtypes
    rng = np.random.default_rng(12)
    q = _on_card(rng.standard_normal((B, KV, G, hd), np.float32), qdt)
    k, v = (_on_card(rng.standard_normal((B, Sc, KV, hd), np.float32), cdt)
            for _ in range(2))
    kpos = _ring_kpos(Sc, pos)
    before = flash_decode.launches
    got, lse = flash_decode(q, k, v, kpos, pos, window=window, lse=True)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    assert lse.dtype == torch.float32 and lse.shape == (B, KV, G)
    want, want_lse = decode_attention_ref(q, k, v, kpos, pos, window=window,
                                          lse=True)
    if pos < 0:
        assert (got == 0).all() and (lse == -1e30).all()
        assert (want_lse == -1e30).all()
        return
    _close(got, want, qdt)
    # the scores' rounding (k to q's type) is the same in both; the sums
    # differ in order and the kernel's exp2 is approximate
    assert (lse - want_lse).abs().max().item() <= 1e-4 * max(
        want_lse.abs().max().item(), 1.0)


@pytest.mark.parametrize("dtypes", FD_DTYPES, ids=lambda d: "q-{}-cache-{}"
                         .format(*d))
@pytest.mark.parametrize("pos", [4095, 200, 40], ids=lambda p: f"pos{p}")
def test_flash_decode_sharded_matches_the_whole_cache(pos, dtypes):
    """qwen2-72b's decode read (G 8 x hd 128) over a 4096-slot cache split
    into 4 shards of 1024: one launch a shard, the lse combine equal to the
    whole cache's read and to the reference's shard_map formula; at pos
    200 and 40 the later shards are empty."""
    from repro_torch.kernels.flash_decode import (flash_decode_sharded,
                                                  sharded_decode_ref)

    qdt, cdt = dtypes
    B, KV, G, hd, Sc = 2, 8, 8, 128, 4096
    rng = np.random.default_rng(13)
    q = _on_card(rng.standard_normal((B, KV, G, hd), np.float32), qdt)
    k, v = (_on_card(rng.standard_normal((B, Sc, KV, hd), np.float32), cdt)
            for _ in range(2))
    kpos = _ring_kpos(Sc, pos)
    ks, vs, kps = (list(t.split(1024, dim)) for t, dim in
                   ((k, 1), (v, 1), (kpos, 0)))
    before = flash_decode.launches
    got = flash_decode_sharded(q, ks, vs, kps, pos)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 4
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, flash_decode(q, k, v, kpos, pos), qdt)
    _close(got, sharded_decode_ref(q, ks, vs, kps, pos), qdt)


def test_lm_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    x, dt, Bm, Cm, A = _ssm_inputs(1, 4, 8, 16, "float32")
    with pytest.raises(ValueError, match="state size"):
        ssm_scan(x, dt, Bm[..., :5], Cm[..., :5], A[:, :5])
    with pytest.raises(TypeError, match="float32"):
        ssm_scan(x, dt.bfloat16(), Bm, Cm, A)
    q = torch.zeros((1, 1, 1, 16), device="cuda")
    k = torch.zeros((1, 4, 1, 16), device="cuda")
    kpos = _ring_kpos(4, 3)
    with pytest.raises(TypeError, match="Python int"):
        flash_decode(q, k, k, kpos, torch.tensor(3, device="cuda"))
    with pytest.raises(ValueError, match="int32"):
        flash_decode(q, k, k, kpos.long(), 3)
    with pytest.raises(TypeError, match="not supported"):
        flash_decode(q, k.bfloat16(), k.bfloat16(), kpos, 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rmsnorm(q.half(), torch.ones(16, device="cuda"))
    with pytest.raises(TypeError, match="scale must be float32"):
        rmsnorm(q, torch.ones(16, device="cuda").bfloat16())


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_hymba_smoke_kernel_path_matches_plain_path(compute, monkeypatch):
    """prefill + decode steps at hymba's smoke size: every kernel of the
    path launched the expected number of times, logits held against the
    same model with the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    cfg = get_config("hymba-1.5b").smoke()
    params = lm.init_lm(cfg, torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    cdt = getattr(torch, compute)
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24))
                            .astype(np.int32)).cuda()
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 2))
                              .astype(np.int32)).cuda()

    def run():
        logits, cache = lm.prefill(params, cfg, toks, max_len=28,
                                   cache_dtype=torch.float32,
                                   compute_dtype=cdt)
        out = [logits]
        for t in range(3):
            logits, cache = lm.decode_step(params, cfg, forced[t], cache,
                                           compute_dtype=cdt)
            out.append(logits)
        return torch.stack(out).float()

    before = launch_counts()
    got = run()
    torch.cuda.synchronize()
    after = launch_counts()
    n = {k: after[k] - before[k] for k in after}
    Ly = cfg.num_layers
    assert n["rmsnorm"] == 4 * (2 * Ly + 1)
    assert n["flash_attention"] == Ly and n["ssm_scan"] == Ly
    assert n["flash_decode"] == 3 * Ly
    for name, ref in (("rmsnorm", rmsnorm_ref),
                      ("flash_decode", decode_attention_ref),
                      ("ssm_scan", ssm_scan_ref),
                      ("flash_attention", attention_ref)):
        monkeypatch.setattr(L, name, ref)
    want = run()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= (1e-4 if compute == "float32" else 5e-2) * scale, err


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "starcoder2-7b",
                                  "falcon-mamba-7b", "internlm2-20b",
                                  "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
                                  "internvl2-2b", "whisper-tiny",
                                  "qwen2-72b"])
def test_decoder_smoke_kernel_path_matches_plain_path(arch, compute,
                                                      monkeypatch):
    """The other decoder families at smoke size (starcoder2's window 16
    wraps its ring; internvl2 prefills 16 patch embeddings before its
    prompt; whisper-tiny encodes 32 stub frames, and its prefill's cross
    attention reads them; qwen2-72b adds q/k/v biases): each kernel of the
    family's path launched as often as its layers ask, logits held against
    the plain versions.
    internlm2 and qwen3-moe run on bf16 weights, as they are served."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models import api, encdec, lm
    from repro_torch.models import layers as L

    cfg = get_config(arch).smoke()
    wdt = (torch.bfloat16 if arch in ("internlm2-20b", "qwen3-moe-30b-a3b")
           else torch.float32)
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             device="cuda", dtype=wdt)
    cdt = getattr(torch, compute)
    rng = np.random.default_rng(10)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24))
                            .astype(np.int32)).cuda()
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 2))
                              .astype(np.int32)).cuda()
    # the prefill's other input: patch embeddings (their slots are cached)
    # or the encoder's frames
    model, extra, P = (encdec if cfg.cross_attention else lm), None, 0
    if cfg.frontend != "none":
        n = cfg.num_patches if cfg.frontend == "vision" else cfg.num_frames
        extra = torch.from_numpy(rng.standard_normal(
            (2, n, cfg.d_model)).astype(np.float32)).cuda()
        P = n if cfg.frontend == "vision" else 0

    def run():
        logits, cache = model.prefill(params, cfg, toks, extra,
                                      max_len=28 + P,
                                      cache_dtype=torch.float32,
                                      compute_dtype=cdt)
        out = [logits]
        for t in range(3):
            logits, cache = model.decode_step(params, cfg, forced[t], cache,
                                              compute_dtype=cdt)
            out.append(logits)
        return torch.stack(out).float()

    before = launch_counts()
    got = run()
    torch.cuda.synchronize()
    after = launch_counts()
    n = {k: after[k] - before[k] for k in after}
    Ly = cfg.num_layers
    norms = (Ly * (2 if cfg.d_ff else 1) + 1
             if cfg.norm == "rmsnorm" else 0)
    assert n["rmsnorm"] == 4 * norms
    # an encoder-decoder's prefill also attends across (one launch a
    # decoder layer) and runs its encoder's layers
    attn = Ly * (2 if cfg.cross_attention else 1) + cfg.encoder_layers
    assert n["flash_attention"] == (attn if cfg.has_attention else 0)
    assert n["flash_decode"] == (3 * Ly if cfg.has_attention else 0)
    assert n["ssm_scan"] == (Ly if cfg.has_ssm else 0)
    for name, ref in (("rmsnorm", rmsnorm_ref),
                      ("flash_decode", decode_attention_ref),
                      ("ssm_scan", ssm_scan_ref),
                      ("flash_attention", attention_ref)):
        monkeypatch.setattr(L, name, ref)
    want = run()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= (1e-4 if compute == "float32" else 5e-2) * scale, err


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "starcoder2-7b",
                                  "hymba-1.5b", "qwen2-72b"])
def test_sequence_sharded_decode_matches_the_whole_cache(arch):
    """decode_shard_map at smoke size with four logical shards on the card
    (a (1, 4) mesh over one device): the prefill's cache laid out over the
    mesh, then decode steps through the shards, against the same steps on
    the whole cache in fp32 compute: tokens equal, caches within 1e-6 of
    their largest magnitude; one flash_decode launch a shard a layer."""
    from repro_torch import perf_flags
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.steps import serve

    cfg = get_config(arch).smoke()
    params = lm.init_lm(cfg, torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 21))
                            .astype(np.int32)).cuda()
    shape = ShapeConfig("t", 32, 2, "decode")
    mesh = Mesh(["cuda"] * 4, (1, 4), ("data", "model"))
    kw = dict(cache_dtype=torch.float32, max_len=32,
              compute_dtype=torch.float32)
    runs = {}
    for flag in (False, True):
        perf_flags.set_flags(decode_shard_map=flag)
        try:
            logits, cache = serve.build_prefill_step(cfg, shape, mesh,
                                                     **kw)(params,
                                                           {"tokens": toks})
            step = serve.build_decode_step(cfg, shape, mesh,
                                           compute_dtype=torch.float32)
            tok, fed = logits.argmax(-1).to(torch.int32), []
            before = launch_counts()["flash_decode"]
            for _ in range(8):
                tok, cache = step(params, cache, {"token": tok})
                fed.append(tok)
            torch.cuda.synchronize()
            launched = launch_counts()["flash_decode"] - before
        finally:
            perf_flags.reset_flags()
        runs[flag] = (torch.stack(fed), lm.unshard_cache(cache), launched)
    (want, whole, n0), (got, sharded, n1) = runs[False], runs[True]
    assert n0 == 8 * cfg.num_layers and n1 == 4 * n0
    assert torch.equal(got, want)
    assert torch.equal(sharded["kpos"], whole["kpos"])
    for key in ("k", "v"):
        err = (sharded[key] - whole[key]).abs().max().item()
        assert err <= 1e-6 * whole[key].abs().max().item(), (key, err)


# ------------------------------------------------------------- backward --
# (B, H, KV, Sq, Sk, hd, causal, window, kv_len): stablelm-1.6b's training
# attention at a short S, GQA at hd 128 (qwen2-style 8 query heads a KV
# head), a sliding window, a ragged kv_len with a row of none, Sq != Sk
# (whisper's cross attention, 64 queries over 1500 keys at a narrow B),
# odd sizes that end mid-tile, hd 16 and 32, and hd 128 under a window with
# a ragged kv_len
ATTN_BWD_CASES = [
    (2, 32, 32, 128, 128, 64, True, 0, None),
    (1, 16, 2, 96, 96, 128, True, 0, None),
    (2, 4, 2, 130, 130, 64, True, 48, [130, 77]),
    (3, 4, 4, 40, 40, 32, False, 0, [40, 0, 17]),
    (2, 6, 6, 64, 1500, 64, False, 0, None),
    (2, 4, 1, 33, 70, 16, True, 20, [70, 5]),
    (2, 8, 2, 200, 200, 128, True, 64, [200, 77]),
]


def _attn_bwd_inputs(case, dtype, seed=0):
    B, H, KV, Sq, Sk, hd, causal, window, kv_len = case
    rng = np.random.default_rng(seed)
    # (B, S, heads, hd) projections seen as (B, heads, S, hd)
    q, do = (_on_card(rng.standard_normal((B, Sq, H, hd), np.float32),
                      dtype).transpose(1, 2) for _ in range(2))
    k, v = (_on_card(rng.standard_normal((B, Sk, KV, hd), np.float32),
                     dtype).transpose(1, 2) for _ in range(2))
    kvl = (None if kv_len is None else
           torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
    return q, k, v, do, dict(causal=causal, window=window, kv_len=kvl)


def _held(got, want, dtype):
    """fp32: max-abs within 1e-4 of the largest magnitude; bf16: cosine of
    the flattened tensors at least 0.999."""
    g, w = got.float().flatten(), want.float().flatten()
    assert torch.isfinite(g).all()
    if dtype == "float32":
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * max(w.abs().max().item(), 1e-30), err
    else:
        cos = torch.nn.functional.cosine_similarity(g, w, dim=0).item()
        assert cos >= 0.999 or (w.abs().max() == 0 and g.abs().max() == 0), cos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_BWD_CASES, ids=_ids(
    ATTN_BWD_CASES, lambda B, H, KV, Sq, Sk, hd, c, w, _:
    f"B{B}H{H}KV{KV}Sq{Sq}Sk{Sk}hd{hd}{'c' if c else ''}w{w}"))
def test_attention_backward_kernel_matches_plain(case, dtype):
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bwd)

    q, k, v, do, kw = _attn_bwd_inputs(case, dtype)
    out, lse = attention_ref(q, k, v, return_lse=True, **kw)
    lse = lse.float().contiguous()
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = attention_bwd_ref(q, k, v, out, do, lse, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
        _held(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_BWD_CASES, ids=_ids(
    ATTN_BWD_CASES, lambda B, H, KV, Sq, Sk, hd, c, w, _:
    f"B{B}H{H}KV{KV}Sq{Sq}Sk{Sk}hd{hd}{'c' if c else ''}w{w}"))
def test_attention_forward_lse_matches_plain(case, dtype):
    from repro_torch.kernels.flash_attention.ops import _forward

    q, k, v, _, kw = _attn_bwd_inputs(case, dtype, seed=1)
    before = flash_attention.launches
    out, lse = _forward(q, k, v, kw["causal"], kw["window"], kw["kv_len"],
                        True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want_out, want = attention_ref(q, k, v, return_lse=True, **kw)
    none = want == -1e30
    assert (lse[none] == -1e30).all()
    torch.testing.assert_close(lse[~none], want[~none].float(), rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [ATTN_BWD_CASES[0], ATTN_BWD_CASES[1]],
                         ids=["causal_mha", "gqa_hd128"])
def test_attention_backward_is_bitwise_repeatable(case, dtype):
    """No float atomics: two calls give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v, do, kw = _attn_bwd_inputs(case, dtype, seed=4)
    out, lse = attention_ref(q, k, v, return_lse=True, **kw)
    lse = lse.float().contiguous()
    first = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    second = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_backward_takes_unaligned_views(dtype):
    """q, k, v and dO as views one element past a 16-byte boundary, rows
    one element longer than hd: the element-copy staging path."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention_bwd)

    B, H, KV, Sq, Sk, hd, causal, window, kv_len = ATTN_BWD_CASES[2]
    rng = np.random.default_rng(5)
    q, do = (_unaligned(rng.standard_normal((B, Sq, H, hd), np.float32),
                        dtype).transpose(1, 2) for _ in range(2))
    k, v = (_unaligned(rng.standard_normal((B, Sk, KV, hd), np.float32),
                       dtype).transpose(1, 2) for _ in range(2))
    assert q.data_ptr() % 16 and q.stride(2) % 8
    kw = dict(causal=causal, window=window,
              kv_len=torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
    out, lse = attention_ref(q, k, v, return_lse=True, **kw)
    lse = lse.float().contiguous()
    got = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    want = attention_bwd_ref(q, k, v, out, do, lse, **kw)
    for g, w in zip(got, want):
        _held(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_autograd_runs_both_kernels(dtype):
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v, do, kw = _attn_bwd_inputs(ATTN_BWD_CASES[2], dtype, seed=2)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    before = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(qg, kg, vg, **kw)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    q2, k2, v2 = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(attention_ref(q2, k2, v2, **kw), (q2, k2, v2),
                               do.float())
    for g, w in zip(got, want):
        _held(g, w, dtype)


# (R, D): stablelm-1.6b's training rows (B 8 x S 512 at d 2048),
# internlm2's d 6144, odd sizes, a D past what registers hold, and rows
# whose stride is not a multiple of 16 bytes in either dtype
RMS_BWD_CASES = [(4096, 2048), (64, 6144), (7, 77), (3, 20000), (1, 2048),
                 (9, 2046)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RMS_BWD_CASES, ids=_ids(
    RMS_BWD_CASES, lambda R, D: f"R{R}D{D}"))
def test_rmsnorm_backward_kernel_matches_plain(case, dtype):
    from repro_torch.kernels.rmsnorm import (RMSNormFn, rmsnorm_bwd,
                                             rmsnorm_bwd_ref)

    R, D = case
    rng = np.random.default_rng(3)
    x, dy = (_on_card(rng.standard_normal((R, D), np.float32) * 2, dtype)
             for _ in range(2))
    scale = _on_card(1 + 0.1 * rng.standard_normal(D).astype(np.float32),
                     "float32")
    before = rmsnorm_bwd.launches
    got = rmsnorm_bwd(x, scale, dy, 1e-5)
    torch.cuda.synchronize()
    assert rmsnorm_bwd.launches == before + 1
    want = rmsnorm_bwd_ref(x, scale, dy, 1e-5)
    assert got[0].dtype == x.dtype and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        _held(g, w, dtype)
    # under autograd: both kernels, the gradients the backward kernel gives
    xg, sg = x.clone().requires_grad_(), scale.clone().requires_grad_()
    fwd = rmsnorm.launches
    grads = torch.autograd.grad(rmsnorm(xg, sg, 1e-5), (xg, sg), dy)
    assert rmsnorm.launches == fwd + 1
    for g, w in zip(grads, got):
        assert torch.equal(g, w)
    assert RMSNormFn is not None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_is_bitwise_repeatable(dtype):
    """No atomics: two calls give the same bits, dscale too."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    rng = np.random.default_rng(7)
    x, dy = (_on_card(rng.standard_normal((4096, 2048), np.float32), dtype)
             for _ in range(2))
    scale = _on_card(1 + 0.1 * rng.standard_normal(2048).astype(np.float32),
                     "float32")
    first = rmsnorm_bwd(x, scale, dy, 1e-5)
    second = rmsnorm_bwd(x, scale, dy, 1e-5)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_reads_strided_rows(dtype):
    """x and dy as row views of (R, D + 1) buffers: their row stride is not
    a multiple of 16 bytes, so the kernel takes its element path."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_ref

    R, D = 40, 2048
    rng = np.random.default_rng(8)
    x, dy = (_on_card(rng.standard_normal((R, D + 1), np.float32) * 2,
                      dtype)[:, :D] for _ in range(2))
    assert x.stride(0) == D + 1
    scale = _on_card(1 + 0.1 * rng.standard_normal(D).astype(np.float32),
                     "float32")
    got = rmsnorm_bwd(x, scale, dy, 1e-5)
    want = rmsnorm_bwd_ref(x, scale, dy, 1e-5)
    for g, w in zip(got, want):
        _held(g, w, dtype)


def test_routers_without_a_backward_refuse_autograd():
    """Every router with no backward kernel raises on the card when asked
    for a gradient, instead of returning an output cut from the graph; under
    no_grad it runs."""
    dev = "cuda"
    q = torch.randn(2, 2, 1, 32, device=dev, requires_grad=True)
    kc = torch.randn(2, 8, 2, 32, device=dev)
    kpos = torch.arange(8, dtype=torch.int32, device=dev)
    h = torch.randn(2, 5, 64, device=dev, requires_grad=True)
    m = torch.ones(2, 5, device=dev)
    xm = torch.randn(6, 64, device=dev, requires_grad=True)
    w8 = torch.randint(-127, 128, (64, 32), dtype=torch.int8, device=dev)
    ws = torch.rand(32, device=dev, requires_grad=True)
    x8 = torch.randint(-127, 128, (6, 64), dtype=torch.int8, device=dev)
    xs = torch.rand(6, device=dev)
    calls = {
        "flash_decode": lambda: flash_decode(q, kc, kc, kpos, 7),
        "pool_norm": lambda: pool_norm(h, m, "mean"),
        "quant_matmul": lambda: quant_matmul(xm, w8, ws),
        "quantize_rows": lambda: quantize_rows(xm),
        "w8a8_matmul": lambda: w8a8_matmul(x8, w8, xs, ws),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
