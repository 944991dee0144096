"""The port's int8 serving path against the JAX reference, on the CPU.

The same numpy inputs go through both packages: the load-time weight
quantization and the per-row activation quantization (bit for bit), the
plain versions of the int8 kernels (against the reference's Pallas kernels
in interpret mode), ``dense_apply``'s routing, ``embed`` and the serving
backends under ``embed_dtype=int8`` and ``int8_w8a8``.  The CUDA kernels
themselves are held against these plain versions on the card in
``test_torch_kernels_card.py``.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.routing import Query as JaxQuery  # noqa: E402
from repro.core.sharded_backend import \
    ShardedEmbedderBackend as JaxSharded  # noqa: E402
from repro.kernels.quant_matmul.quant_matmul import (  # noqa: E402
    quant_matmul_pallas, w8a8_matmul_pallas)
from repro.kernels.quant_matmul.quant_matmul import \
    quantize_activations as jax_quantize_activations  # noqa: E402
from repro.models import embedder as jemb  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import quantize as jq  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.bucketing import BucketedEmbedderBackend  # noqa: E402
from repro_torch.core.routing import Query  # noqa: E402
from repro_torch.core.sharded_backend import \
    ShardedEmbedderBackend  # noqa: E402
from repro_torch.core.windve import TorchEmbedderBackend  # noqa: E402
from repro_torch.kernels.quant_matmul import (quant_matmul,  # noqa: E402
                                              quant_matmul_ref,
                                              quant_matmul_w8a8,
                                              quantize_activations,
                                              quantize_rows, w8a8_matmul,
                                              w8a8_matmul_ref)
from repro_torch.models import embedder  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import quantize as Q  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_embed.npz")
TINY = np.finfo(np.float32).tiny
GOLDEN_KW = dict(name="bge-golden", num_layers=1, d_model=32, num_heads=2,
                 num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=128,
                 embed_dim=16)
# the reference's kernel sweep (tests/test_kernels.py QM_CASES):
# M, K, N, block_m, block_n, block_k
QM_CASES = [
    (128, 128, 128, 128, 128, 128),
    (200, 96, 260, 128, 128, 64),
    (7, 48, 130, 8, 128, 32),
    (256, 320, 64, 64, 64, 128),
    (1, 16, 24, 128, 128, 128),
]
# fp32: both sides accumulate fp32, in another order.  bf16: the output is
# rounded to bf16, as the reference's own kernel tests allow.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread each, so parallel test workers do
    not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def bits(a):
    """The raw bits of a numpy or torch array, so equality is bitwise."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint8)


def assert_bitwise(got, want):
    g, w = bits(got), bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    assert np.array_equal(g, w), f"{int((g != w).sum())} bytes differ"


def cosine_distance(a, b):
    return float((1.0 - (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)).max())


def golden_tree():
    data = np.load(GOLDEN)
    return (embedder.unflatten({k: data[k] for k in data.files}, "param:"),
            [data[f"query:{i}"] for i in range(8)], data["golden"])


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ------------------------------------------------------ weight quantize ---
def _assert_trees_bitwise(got, want):
    g, w = flatten(got), flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert_bitwise(g[k], np.asarray(w[k]))


def _both_quantize_params(tree):
    want = jq.quantize_params(jax.tree.map(jnp.asarray, tree))
    got = Q.quantize_params(embedder.params_from_numpy(tree, "cpu"))
    return got, want


def test_quantize_params_golden_tree_bitwise():
    tree, _, _ = golden_tree()
    got, want = _both_quantize_params(tree)
    _assert_trees_bitwise(got, want)
    assert got["blocks"]["attn"]["wq"].dtype == torch.int8
    assert got["blocks"]["attn"]["wq_scale"].shape == (1, 32)
    assert got["embed"].dtype == torch.float32          # a gather stays float
    assert Q.is_quantized(got) and not Q.is_quantized(
        embedder.params_from_numpy(tree, "cpu"))


def test_quantize_params_stacked_blocks_bitwise():
    """A stacked ``blocks`` tree with a layer dim, a non-dense leaf and an
    expert-shaped leaf (one dim too many: stays float), as the reference."""
    rng = np.random.default_rng(0)
    tree = {"blocks": {"attn": {"wq": rand(rng, 3, 16, 24) * 0.3,
                                "bq": rand(rng, 3, 24)},
                       "ffn": {"w_in": rand(rng, 3, 16, 40),
                               "w_out": rand(rng, 3, 40, 16) * 7.0},
                       "moe": {"w_up": rand(rng, 3, 4, 16, 8)}},
            "head": {"wo": rand(rng, 16, 8)},
            "embed": rand(rng, 10, 16)}
    got, want = _both_quantize_params(tree)
    _assert_trees_bitwise(got, want)
    assert got["blocks"]["moe"]["w_up"].dtype == torch.float32
    assert got["blocks"]["ffn"]["w_out_scale"].shape == (3, 16)
    assert got["head"]["wo_scale"].shape == (8,)


@pytest.mark.parametrize("case", ["zero_channel", "subnormal_channel",
                                  "ties"])
def test_quantize_dense_edge_cases_bitwise(case):
    rng = np.random.default_rng(1)
    w = rand(rng, 2, 48, 12)
    if case == "zero_channel":
        w[:, :, 3] = 0.0
        w[1, :, 7] = -0.0
    elif case == "subnormal_channel":     # XLA flushes these to zero
        w[0, :, 5] = rand(rng, 48) * np.float32(1e-40)
    else:                                 # amax 127 -> scale 1: exact .5s
        w[:, :, 2] = 0.0
        w[:, :5, 2] = [127.0, 0.5, 1.5, -2.5, 126.5]
    q, s = Q.quantize_dense(torch.from_numpy(w))
    jq8, js = jq.quantize_dense(jnp.asarray(w))
    assert_bitwise(q, np.asarray(jq8))
    assert_bitwise(s, np.asarray(js))
    if case == "zero_channel":
        assert (s[:, 3] == 1).all() and (q[:, :, 3] == 0).all()
    if case == "ties":                    # round half to even
        assert q[0, :5, 2].tolist() == [127, 0, 2, -2, 126]


def test_div127_is_a_true_division():
    """Values where a multiply by the reciprocal of 127 rounds differently
    from the division: the scales divide, as the reference does."""
    a = np.random.default_rng(8).uniform(0, 100, 200_000).astype(np.float32)
    true = a / np.float32(127)
    recip = a * np.float32(1 / 127)
    assert (true != recip).any()
    assert_bitwise(Q.div127(torch.from_numpy(a)), true)


# -------------------------------------------------- activation quantize ---
def _activation_rows():
    rng = np.random.default_rng(2)
    x = rand(rng, 12, 70) * np.geomspace(1e-3, 1e3, 12, dtype=np.float32)[:, None]
    x[1] = 0.0                                         # zero row
    x[2] = rand(rng, 70) * np.float32(1e-40)           # subnormal row
    x[3] = (rng.uniform(-1, 1, 70) * TINY * 60).astype(np.float32)
    # amax / 127 is subnormal: scale FLT_MIN
    x[3, 0] = np.float32(TINY * 100)
    x[4] = 0.0                                         # exact ties: scale 1
    x[4, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_bitwise(dtype):
    x = _activation_rows()
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    for got, want in zip(quantize_activations(t), jax_quantize_activations(j)):
        assert_bitwise(got, np.asarray(want))
    x8, s = quantize_rows(t)                  # the CPU router: the plain one
    assert x8.dtype == torch.int8 and s.dtype == torch.float32
    if dtype == "float32":
        assert s[1] == 1.0 and (x8[1] == 0).all()
        assert s[2] == 1.0 and (x8[2] == 0).all()
        assert s[3] == np.float32(TINY)
        assert x8[4, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -126]


def test_quantize_activations_keeps_leading_dims():
    x = rand(np.random.default_rng(3), 2, 5, 24)
    x8, s = quantize_activations(torch.from_numpy(x))
    assert x8.shape == (2, 5, 24) and s.shape == (2, 5)
    j8, js = jax_quantize_activations(jnp.asarray(x))
    assert_bitwise(x8, np.asarray(j8))
    assert_bitwise(s, np.asarray(js))


# ------------------------------------------------------------- kernels ---
def _qm_inputs(M, K, N, seed=7):
    rng = np.random.default_rng(seed)
    x = rand(rng, M, K)
    w8 = rng.integers(-127, 128, (K, N)).astype(np.int8)
    scale = (np.abs(rand(rng, N)) * 0.01 + 1e-4).astype(np.float32)
    return x, w8, scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", QM_CASES, ids=lambda c: "M{}K{}N{}".format(*c))
def test_quant_matmul_plain_matches_pallas(case, dtype):
    M, K, N, bm, bn, bk = case
    x, w8, scale = _qm_inputs(M, K, N)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = quant_matmul(tx, torch.from_numpy(w8), torch.from_numpy(scale))
    assert got.dtype == tx.dtype and got.shape == (M, N)
    want = quant_matmul_pallas(jnp.asarray(x).astype(getattr(jnp, dtype)),
                               jnp.asarray(w8), jnp.asarray(scale),
                               block_m=bm, block_n=bn, block_k=bk,
                               interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", QM_CASES, ids=lambda c: "M{}K{}N{}".format(*c))
def test_w8a8_matmul_plain_matches_pallas(case, out):
    """On the same int8 activations the product is exact on both sides, so
    the outputs agree to the fp32 epilogue's rounding."""
    M, K, N, bm, bn, bk = case
    x, w8, w_scale = _qm_inputs(M, K, N)
    x8, xs = quantize_activations(torch.from_numpy(x))
    got = w8a8_matmul(x8, torch.from_numpy(w8), xs, torch.from_numpy(w_scale),
                      out_dtype=getattr(torch, out))
    want = w8a8_matmul_pallas(jnp.asarray(x8.numpy()), jnp.asarray(w8),
                              jnp.asarray(xs.numpy()), jnp.asarray(w_scale),
                              block_m=bm, block_n=bn, block_k=bk,
                              out_dtype=getattr(jnp, out), interpret=True)
    assert got.dtype == getattr(torch, out)
    tol = 1e-6 if out == "float32" else TOL[out]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0, rtol=tol)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_w8a8_matmul_plain_matches_pallas_past_2_24(out):
    """x8 and w8 all +-127 at K 4096: out[0, 0]'s int32 sum is 127^2 * 4096
    = 66,064,384, past 2^24, where fp32 holds only every fourth integer.
    The plain version rounds it (float64 -> fp32) as the reference's kernel
    does (int32 -> fp32), and the epilogue is the same: equal bit for bit."""
    M, K, N = 8, 4096, 16
    rng = np.random.default_rng(17)
    x8 = (127 * rng.choice([-1, 1], (M, K))).astype(np.int8)
    w8 = (127 * rng.choice([-1, 1], (K, N))).astype(np.int8)
    x8[0], w8[:, 0] = 127, 127
    xs = rng.uniform(1e-3, 1e-2, M).astype(np.float32)
    ws = rng.uniform(1e-3, 1e-2, N).astype(np.float32)
    acc = x8.astype(np.int64) @ w8.astype(np.int64)
    assert acc[0, 0] == K * 127 ** 2 > 2 ** 24
    assert (np.abs(acc) > 2 ** 24).any() and (acc % 4 != 0).any()
    got = w8a8_matmul(*(torch.from_numpy(a) for a in (x8, w8, xs, ws)),
                      out_dtype=getattr(torch, out))
    want = w8a8_matmul_pallas(*(jnp.asarray(a) for a in (x8, w8, xs, ws)),
                              block_m=8, block_n=16, block_k=512,
                              out_dtype=getattr(jnp, out), interpret=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_int8_matmuls_keep_leading_batch_dims():
    rng = np.random.default_rng(4)
    x = rand(rng, 2, 9, 48)
    w8 = rng.integers(-127, 128, (48, 64)).astype(np.int8)
    s = np.full((64,), 0.02, np.float32)
    tw, ts = torch.from_numpy(w8), torch.from_numpy(s)
    got = quant_matmul(torch.from_numpy(x), tw, ts)
    want = quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(s),
                               interpret=True)
    assert got.shape == want.shape == (2, 9, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    x8, xs = quantize_activations(torch.from_numpy(x))
    got = w8a8_matmul(x8, tw, xs, ts)
    want = w8a8_matmul_pallas(jnp.asarray(x8.numpy()), jnp.asarray(w8),
                              jnp.asarray(xs.numpy()), jnp.asarray(s),
                              interpret=True)
    assert got.shape == want.shape == (2, 9, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0,
                               rtol=1e-6)


def test_plain_versions_refuse_float_weights():
    x, w = torch.zeros(2, 4), torch.zeros(4, 3)
    with pytest.raises(TypeError, match="int8"):
        quant_matmul_ref(x, w, torch.ones(3))
    with pytest.raises(TypeError, match="int8"):
        w8a8_matmul_ref(torch.zeros(2, 4, dtype=torch.int8), w,
                        torch.ones(2), torch.ones(3))
    with pytest.raises(TypeError, match="int8"):
        w8a8_matmul_ref(x, w.to(torch.int8), torch.ones(2), torch.ones(3))


# --------------------------------------------------------- dense_apply ---
def _quantized_pair(rng, K, N):
    """One float weight, quantized by the reference: (jax tree, port tree,
    float weight)."""
    w = rand(rng, K, N) / np.sqrt(K)
    q, s = jq.quantize_dense(jnp.asarray(w))
    tree = {"wo": np.asarray(q), "wo_scale": np.asarray(s)}
    return (jax.tree.map(jnp.asarray, tree),
            embedder.params_from_numpy(tree, "cpu"), w)


@pytest.mark.parametrize("route", ["float", "weight_only", "w8a8"])
def test_dense_apply_routes_as_the_reference(route):
    rng = np.random.default_rng(5)
    x = rand(rng, 3, 5, 32)
    if route == "float":
        w = rand(rng, 32, 24)
        jp, tp = {"wo": jnp.asarray(w)}, {"wo": torch.from_numpy(w)}
    else:
        jp, tp, w = _quantized_pair(rng, 32, 24)
    aq = route == "w8a8"
    want = np.asarray(jL.dense_apply(jp, "wo", jnp.asarray(x), act_quant=aq))
    got = L.dense_apply(tp, "wo", torch.from_numpy(x), act_quant=aq).numpy()
    assert got.shape == want.shape == (3, 5, 24)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if route != "float":            # quantized: close to the float product
        ref = x @ w
        assert np.abs(got - ref).max() <= 0.05 * np.abs(ref).max()


def test_quant_routers_count_no_launch_on_the_cpu():
    from repro_torch.kernels import launch_counts

    before = launch_counts()
    x, w8 = torch.ones(2, 8), torch.ones(8, 4, dtype=torch.int8)
    quant_matmul(x, w8, torch.ones(4))
    quant_matmul_w8a8(x, w8, torch.ones(4))
    assert launch_counts() == before
    assert {"quant_matmul", "quantize_rows", "w8a8_matmul"} <= set(before)


# --------------------------------------------------------------- embed ---
def configs(model, **kw):
    jc, tc = jax_get_config(model).smoke(), get_config(model).smoke()
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


@pytest.fixture(scope="module", params=["bge-large-zh-v1.5", "jina-v2"])
def embed_case(request):
    jc, tc = configs(request.param)
    params = jax.tree.map(np.asarray,
                          jemb.init_embedder(jax.random.PRNGKey(5), jc))
    rng = np.random.default_rng(6)
    S = 24
    toks = rng.integers(1, tc.vocab_size, (4, S)).astype(np.int32)
    mask = (np.arange(S)[None] < np.array([[24], [11], [1], [17]])
            ).astype(np.float32)
    return jc, tc, params, toks, mask


def _jax_embed(jc, params, toks, mask, dtype):
    tree, cdt = jq.serve_params(jax.tree.map(jnp.asarray, params), dtype)
    return np.asarray(jemb.embed(tree, jc, jnp.asarray(toks),
                                 jnp.asarray(mask), compute_dtype=cdt,
                                 act_quant=jq.wants_act_quant(dtype)))


def _port_embed(tc, params, toks, mask, dtype):
    tree, cdt = Q.serve_params(embedder.params_from_numpy(params, "cpu"),
                               dtype)
    return embedder.embed(tree, tc, torch.from_numpy(toks),
                          torch.from_numpy(mask), compute_dtype=cdt,
                          act_quant=Q.wants_act_quant(dtype)).numpy()


def test_embed_int8_matches_jax(embed_case):
    """fp32 math on bitwise-equal int8 weights: fp32 path's tolerance."""
    jc, tc, params, toks, mask = embed_case
    got = _port_embed(tc, params, toks, mask, "int8")
    want = _jax_embed(jc, params, toks, mask, "int8")
    assert got.dtype == np.float32 and got.shape == (4, tc.d_model)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_embed_w8a8_matches_jax(embed_case):
    """The two frameworks' fp32 sums differ in their last bits, and that can
    flip one activation's int8 rounding: a looser bar than int8's."""
    jc, tc, params, toks, mask = embed_case
    got = _port_embed(tc, params, toks, mask, "int8_w8a8")
    want = _jax_embed(jc, params, toks, mask, "int8_w8a8")
    assert np.abs(got - want).max() <= 1e-3
    assert cosine_distance(got, want) <= 1e-4


@pytest.mark.parametrize("dtype,bar", [("int8", 0.99), ("int8_w8a8", 0.98)])
def test_embed_quantized_within_cosine_bar_of_fp32(embed_case, dtype, bar):
    """The reference's acceptance bars against the fp32 oracle, for CLS
    (bge) and mean (jina) pooling."""
    _, tc, params, toks, mask = embed_case
    fp32 = _port_embed(tc, params, toks, mask, "fp32")
    got = _port_embed(tc, params, toks, mask, dtype)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-3)
    assert 1.0 - cosine_distance(got, fp32) >= bar


def test_params_from_numpy_keeps_a_quantized_tree():
    tree, _, _ = golden_tree()
    qtree = jax.tree.map(np.asarray,
                         jq.quantize_params(jax.tree.map(jnp.asarray, tree)))
    got = embedder.params_from_numpy(qtree, "cpu")
    for k, v in flatten(qtree).items():
        assert_bitwise(flatten(got)[k], v)
    assert got["blocks"]["ffn"]["w_in"].dtype == torch.int8
    assert got["blocks"]["ffn"]["w_in_scale"].dtype == torch.float32
    assert Q.is_quantized(got)


# ------------------------------------------------------------ policies ---
@pytest.mark.parametrize("dtype", ["int8", "int8_w8a8"])
def test_parse_opt_int8_roundtrip(dtype):
    assert perf_flags.parse_opt(f"embed_dtype={dtype}") == {
        "embed_dtype": dtype}


# ------------------------------------------------------------ backends ---
MAX_TOKENS = 64
PORT = {"fixed": (TorchEmbedderBackend, {}),
        "bucketed": (BucketedEmbedderBackend, {"min_seq_bucket": 8}),
        "sharded": (ShardedEmbedderBackend, {"min_seq_bucket": 8})}


@pytest.fixture(scope="module")
def bge_smoke():
    cfg = get_config("bge-large-zh-v1.5").smoke()
    return cfg, embedder.init_embedder(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")


def queries(lengths, vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [Query(qid=i, payload=rng.integers(1, vocab, n), length=n)
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("dtype", ["int8", "int8_w8a8"])
def test_three_backends_agree(bge_smoke, dtype):
    cfg, params = bge_smoke
    qs = queries([12, 30, 55, 20, 44, 9], cfg.vocab_size)
    out = {}
    for kind, (cls, kw) in PORT.items():
        be = cls(cfg, params, MAX_TOKENS, dtype=dtype, device="cpu", **kw)
        assert be.name.endswith(dtype) and dtype in be.name
        assert be.act_quant == (dtype == "int8_w8a8")
        assert be.compute_dtype == torch.float32
        out[kind] = np.stack(be.embed_batch(qs))
    assert out["fixed"].dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(out["fixed"], axis=-1), 1.0,
                               atol=1e-3)
    for kind in ("bucketed", "sharded"):
        np.testing.assert_allclose(out[kind], out["fixed"], atol=1e-5)


@pytest.mark.parametrize("dtype,bar", [("int8", 0.99), ("int8_w8a8", 0.98)])
def test_sharded_quantized_footprint_and_parity(bge_smoke, dtype, bar):
    cfg, params = bge_smoke
    qs = queries([12, 30, 55, 20], cfg.vocab_size)
    fp32 = ShardedEmbedderBackend(cfg, params, MAX_TOKENS, dtype="fp32",
                                  device="cpu")
    be = ShardedEmbedderBackend(cfg, params, MAX_TOKENS, dtype=dtype,
                                device="cpu")
    assert be.serve_dtype == torch.float32
    assert be.params_nbytes < 0.5 * fp32.params_nbytes
    assert be.params["blocks"]["attn"]["wq"].dtype == torch.int8
    got, want = (np.stack(b.embed_batch(qs)) for b in (be, fp32))
    assert 1.0 - cosine_distance(got, want) >= bar


@pytest.mark.parametrize("dtype,bar", [("int8", 0.01), ("int8_w8a8", 0.02)])
def test_golden_vectors_within_cosine_bar(dtype, bar):
    """The reference's own bars against the pinned fp32 golden vectors
    (tests/test_golden_embeddings.py), and the JAX backend beside it."""
    tree, payloads, want = golden_tree()
    cfg = dataclasses.replace(get_config("bge-large-zh-v1.5").smoke(),
                              **GOLDEN_KW)
    be = ShardedEmbedderBackend(cfg, embedder.params_from_numpy(tree, "cpu"),
                                max_tokens=32, min_seq_bucket=8, dtype=dtype,
                                device="cpu")
    got = np.stack(be.embed_batch([Query(qid=i, payload=p, length=len(p))
                                   for i, p in enumerate(payloads)]))
    assert got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-3)
    assert cosine_distance(got, want) <= bar
    jcfg = dataclasses.replace(jax_get_config("bge-large-zh-v1.5").smoke(),
                               **GOLDEN_KW)
    jbe = JaxSharded(jcfg, tree, max_tokens=32, min_seq_bucket=8, dtype=dtype)
    jgot = np.stack(jbe.embed_batch([JaxQuery(qid=i, payload=p, length=len(p))
                                     for i, p in enumerate(payloads)]))
    np.testing.assert_allclose(got, jgot, atol=1e-5 if dtype == "int8"
                               else 1e-3)


def test_sharded_dtype_follows_the_int8_flag(bge_smoke):
    cfg, params = bge_smoke
    try:
        perf_flags.set_flags(embed_dtype="int8_w8a8")
        be = ShardedEmbedderBackend(cfg, params, 32, device="cpu")
    finally:
        perf_flags.reset_flags()
    assert be.dtype == "int8_w8a8" and be.act_quant
    assert "int8_w8a8" in be.name


@pytest.mark.parametrize("dtype", ["int8", "int8_w8a8"])
def test_serve_marks_the_real_tier_quantized(dtype):
    from repro_torch.core.routing import CPU
    from repro_torch.launch.serve import build_engine

    try:
        perf_flags.set_flags(embed_dtype=dtype)
        engine, _ = build_engine(smoke=True, device="cpu")
    finally:
        perf_flags.reset_flags()
    try:
        tiers = {t.name: t for t in engine.qm.tiers}
        assert tiers[CPU].quantized
        assert not any(t.quantized for n, t in tiers.items() if n != CPU)
        assert engine.backends[CPU].act_quant == (dtype == "int8_w8a8")
    finally:
        engine.shutdown()
