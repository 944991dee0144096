"""The port's embedder trunk against the JAX reference, on the CPU.

The same numpy inputs go through each ported ``layers`` function and its
JAX counterpart, then through ``embed`` on both sides (bge CLS, jina mean,
and the golden GQA config).  fp32 agrees within 1e-5 (summation order);
bf16 within 1e-2 cosine distance of the JAX bf16 path.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import embedder as jemb  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import embedder  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.quantize import serve_params  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_embed.npz")
FP32_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread each, so parallel test workers do
    not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def golden_kw():
    return dict(name="bge-golden", num_layers=1, d_model=32, num_heads=2,
                num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=128,
                embed_dim=16)


def configs(model, **kw):
    """The same config on both sides: (jax cfg, port cfg)."""
    jc, tc = jax_get_config(model).smoke(), get_config(model).smoke()
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def cosine_distance(a, b):
    return float((1.0 - (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)).max())


def left_aligned_mask(lens, S):
    return (np.arange(S)[None] < np.asarray(lens)[:, None]).astype(np.float32)


# --------------------------------------------------------------- layers --
class TestLayers:
    def test_dense_apply(self):
        rng = np.random.default_rng(0)
        p, x = {"w": rand(rng, 16, 8)}, rand(rng, 3, 5, 16)
        want = np.asarray(jL.dense_apply(jax.tree.map(jnp.asarray, p), "w",
                                         jnp.asarray(x)))
        got = L.dense_apply(embedder.params_from_numpy(p, "cpu"), "w",
                            torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=FP32_ATOL)

    def test_dense_apply_refuses_int8_trees(self):
        """A ``_scale`` sibling routes to the int8 kernels, which take int8
        weights only: a float weight there raises on either route."""
        p = {"w": torch.zeros(4, 4), "w_scale": torch.ones(4)}
        for act_quant in (False, True):
            with pytest.raises(TypeError, match="int8"):
                L.dense_apply(p, "w", torch.zeros(2, 4), act_quant=act_quant)

    @pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
    def test_apply_norm(self, norm):
        jc, tc = configs("bge-large-zh-v1.5", norm=norm)
        rng = np.random.default_rng(1)
        p = {"scale": 1 + rand(rng, tc.d_model), "bias": rand(rng, tc.d_model)}
        x = 3 * rand(rng, 2, 7, tc.d_model) + 1
        want = np.asarray(jL.apply_norm(jax.tree.map(jnp.asarray, p), jc,
                                        jnp.asarray(x)))
        got = L.apply_norm(embedder.params_from_numpy(p, "cpu"), tc,
                           torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=FP32_ATOL)

    def test_sinusoidal_positions(self):
        want = np.asarray(jL.sinusoidal_positions(jnp.arange(96), 64))
        got = L.sinusoidal_positions(torch.arange(96), 64).numpy()
        np.testing.assert_allclose(got, want, atol=FP32_ATOL)

    def _attn_params(self, cfg, rng):
        hd, H, KV, D = (cfg.resolved_head_dim, cfg.num_heads,
                        cfg.num_kv_heads, cfg.d_model)
        s = 1 / np.sqrt(D)
        return {"wq": s * rand(rng, D, H * hd), "wk": s * rand(rng, D, KV * hd),
                "wv": s * rand(rng, D, KV * hd), "wo": s * rand(rng, H * hd, D)}

    def test_project_qkv_gqa(self):
        jc, tc = configs("bge-large-zh-v1.5", num_kv_heads=2)
        rng = np.random.default_rng(2)
        p = self._attn_params(tc, rng)
        x = rand(rng, 2, 6, tc.d_model)
        want = jL._project_qkv(jax.tree.map(jnp.asarray, p), jc,
                               jnp.asarray(x), jnp.asarray(x))
        got = L._project_qkv(embedder.params_from_numpy(p, "cpu"), tc,
                             torch.from_numpy(x), torch.from_numpy(x))
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=FP32_ATOL)

    @pytest.mark.parametrize("kv_heads", [4, 2, 1])
    def test_attn_forward_ragged_mask(self, kv_heads):
        jc, tc = configs("bge-large-zh-v1.5", num_kv_heads=kv_heads)
        rng = np.random.default_rng(3)
        p = self._attn_params(tc, rng)
        S = 12
        x = rand(rng, 3, S, tc.d_model)
        mask = left_aligned_mask([12, 5, 1], S)
        want = np.asarray(jL.attn_forward(
            jax.tree.map(jnp.asarray, p), jc, jnp.asarray(x),
            jnp.arange(S), causal=False, kv_mask=jnp.asarray(mask)))
        got = L.attn_forward(embedder.params_from_numpy(p, "cpu"), tc,
                             torch.from_numpy(x), torch.arange(S),
                             causal=False,
                             kv_mask=torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, want, atol=FP32_ATOL)

    @pytest.mark.parametrize("act", ["gelu", "silu"])
    def test_apply_mlp(self, act):
        jc, tc = configs("bge-large-zh-v1.5", act=act)
        rng = np.random.default_rng(4)
        D, F = tc.d_model, tc.d_ff
        names = ({"w_in": (D, F), "w_out": (F, D)} if act == "gelu" else
                 {"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)})
        p = {k: rand(rng, *s) / np.sqrt(s[0]) for k, s in names.items()}
        x = rand(rng, 2, 5, D)
        want = np.asarray(jL.apply_mlp(jax.tree.map(jnp.asarray, p), jc,
                                       jnp.asarray(x)))
        got = L.apply_mlp(embedder.params_from_numpy(p, "cpu"), tc,
                          torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=FP32_ATOL)


# ---------------------------------------------------------------- embed --
CASES = {
    "bge-cls": ("bge-large-zh-v1.5", {}),
    "jina-mean": ("jina-v2", {}),
    "golden-gqa": ("bge-large-zh-v1.5", golden_kw()),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def model_case(request):
    model, kw = CASES[request.param]
    jc, tc = configs(model, **kw)
    params = to_np(jemb.init_embedder(jax.random.PRNGKey(5), jc))
    rng = np.random.default_rng(6)
    S = 24
    toks = rng.integers(0, tc.vocab_size, (4, S)).astype(np.int32)
    mask = left_aligned_mask([24, 11, 1, 0], S)       # incl. a padding row
    return jc, tc, params, toks, mask


def _jax_embed(jc, params, toks, mask, dt):
    return np.asarray(jemb.embed(jax.tree.map(jnp.asarray, params), jc,
                                 jnp.asarray(toks), jnp.asarray(mask),
                                 compute_dtype=dt))


def _port_embed(tc, params, toks, mask, dtype):
    tree, cdt = serve_params(embedder.params_from_numpy(params, "cpu"), dtype)
    return embedder.embed(tree, tc, torch.from_numpy(toks),
                          torch.from_numpy(mask), compute_dtype=cdt).numpy()


def test_embed_fp32_matches_jax(model_case):
    jc, tc, params, toks, mask = model_case
    want = _jax_embed(jc, params, toks, mask, jnp.float32)
    got = _port_embed(tc, params, toks, mask, "fp32")
    assert got.shape == (4, tc.d_model) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=FP32_ATOL)   # every row
    assert (got[3] == 0).all()                              # padding row
    np.testing.assert_allclose(np.linalg.norm(got[:3], axis=-1), 1.0,
                               atol=1e-5)


def test_embed_bf16_within_cosine_bar_of_jax_bf16(model_case):
    jc, tc, params, toks, mask = model_case
    want = _jax_embed(jc, params, toks, mask, jnp.bfloat16)
    got = _port_embed(tc, params, toks, mask, "bf16")
    assert got.dtype == np.float32                  # fp32 pool epilogue
    assert np.isfinite(got).all() and (got[3] == 0).all()
    assert cosine_distance(got[:3], want[:3]) <= 1e-2


def test_embed_is_padding_invariant(model_case):
    """Padding a batch further must not change its vectors (bucketing)."""
    _, tc, params, toks, mask = model_case
    wide_t = np.pad(toks, ((0, 0), (0, 8)))
    wide_m = np.pad(mask, ((0, 0), (0, 8)))
    np.testing.assert_allclose(
        _port_embed(tc, params, wide_t, wide_m, "fp32"),
        _port_embed(tc, params, toks, mask, "fp32"), atol=1e-6)


def test_golden_vectors_through_params_from_numpy():
    data = np.load(GOLDEN)
    tree = embedder.unflatten({k: data[k] for k in data.files}, "param:")
    cfg = dataclasses.replace(get_config("bge-large-zh-v1.5").smoke(),
                              **golden_kw())
    params = embedder.params_from_numpy(tree, "cpu")
    assert params["blocks"]["attn"]["wq"].shape == (1, 32, 32)
    S = 32                                      # the golden's fixed window
    payloads = [data[f"query:{i}"] for i in range(8)]
    toks = np.zeros((8, S), np.int32)
    for i, p in enumerate(payloads):
        toks[i, :len(p)] = p
    mask = left_aligned_mask([len(p) for p in payloads], S)
    got = embedder.embed(params, cfg, torch.from_numpy(toks),
                         torch.from_numpy(mask),
                         compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, data["golden"], atol=1e-6)


@pytest.mark.parametrize("model", ["bge-large-zh-v1.5", "jina-v2"])
def test_init_embedder_has_the_reference_layout(model):
    jc, tc = configs(model)
    want = jax.eval_shape(lambda: jemb.init_embedder(jax.random.PRNGKey(0),
                                                     jc))
    got = embedder.init_embedder(tc, torch.Generator().manual_seed(0),
                                 device="cpu")
    flat_w = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_g == flat_w
    again = embedder.init_embedder(tc, torch.Generator().manual_seed(0),
                                   device="cpu")
    assert torch.equal(got["blocks"]["attn"]["wq"],
                       again["blocks"]["attn"]["wq"])   # seeded


class TestPolicies:
    def test_bf16_casts_every_float_leaf(self):
        tree, cdt = serve_params({"a": torch.ones(2), "b": {"c": torch.ones(3)},
                                  "i": torch.ones(2, dtype=torch.int32)},
                                 "bf16")
        assert cdt == torch.bfloat16
        assert tree["a"].dtype == tree["b"]["c"].dtype == torch.bfloat16
        assert tree["i"].dtype == torch.int32

    @pytest.mark.parametrize("dtype", ["int8", "int8_w8a8"])
    def test_int8_policies_raise_until_their_slice(self, dtype):
        """The int8 policies serve now: the projections of the tree come
        back int8 with fp32 scales, fp32 compute, and TF32 off (``embed``
        refuses an fp32 forward on the card with it on)."""
        flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
        saved = [f.allow_tf32 for f in flags]
        try:
            for f in flags:
                f.allow_tf32 = True
            tree, cdt = serve_params({"blocks": {"wq": torch.ones(2, 4, 3)},
                                      "embed": torch.ones(5, 4)}, dtype)
            assert not any(f.allow_tf32 for f in flags)
        finally:
            for f, v in zip(flags, saved):
                f.allow_tf32 = v
        assert cdt == torch.float32
        assert tree["blocks"]["wq"].dtype == torch.int8
        assert tree["blocks"]["wq_scale"].shape == (2, 3)
        assert tree["embed"].dtype == torch.float32

    def test_fp32_policy_switches_tf32_off(self):
        flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
        saved = [f.allow_tf32 for f in flags]
        try:
            for f in flags:
                f.allow_tf32 = True
            tree, cdt = serve_params({"w": torch.ones(2)}, "fp32")
            assert cdt == torch.float32 and tree["w"].dtype == torch.float32
            assert not any(f.allow_tf32 for f in flags)
        finally:
            for f, v in zip(flags, saved):
                f.allow_tf32 = v

    def test_unknown_policy_rejected(self):
        with pytest.raises(ValueError, match="fp32|bf16"):
            serve_params({}, "fp16")

    def test_parse_opt_validates_embed_dtype(self):
        assert perf_flags.parse_opt("embed_dtype=bf16,embed_async=1") == {
            "embed_dtype": "bf16", "embed_async": True}
        with pytest.raises(ValueError, match="embed_dtype"):
            perf_flags.parse_opt("embed_dtype=fp8")
        with pytest.raises(ValueError, match="unknown perf flag"):
            perf_flags.parse_opt("attn_kernel=pallas")
