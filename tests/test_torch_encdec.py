"""The port's encoder-decoder (whisper-tiny) against the JAX reference, on
the CPU.

whisper-tiny's smoke config (2 encoder and 2 decoder layers, d_model 128,
4 heads of 32, 32 stub frames) with the reference's own weights carried
over by ``params_from_numpy``, the frames and tokens drawn from a numpy
seed.  Held: cross attention alone (``attn_forward(kv_x=...)``,
``cross_decode``), ``encode``, ``forward``, prefill of a 24-token prompt
with every cache leaf (``cross_k``/``cross_v`` included) and three decode
steps on forced tokens, greedy tokens, the port's prefill + decode against
its own ``forward``, and ``steps/serve.py``'s two builders against the
reference's, for whisper-tiny and for a decoder (stablelm-1.6b).

fp32 compute is the tight oracle: the JAX model computes in fp32 when its
``layers.COMPUTE_DTYPE`` is patched, and logits and every cache leaf agree
within 1e-4 of the largest logit.  In bf16 (both packages' default) the two
round at different places; they are held within 5e-2 of the largest
magnitude.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.launch.mesh import make_host_mesh, mesh_context  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.steps import serve as jserve  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.models import api, encdec, lm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.steps import serve  # noqa: E402

ARCH = "whisper-tiny"
FP32_REL = 1e-4            # of the largest logit
BF16_REL = 5e-2            # of the largest magnitude
PROMPT, MAX_LEN, STEPS = 24, 28, 3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread each, so parallel test workers do
    not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def whisper():
    """(jax cfg, port cfg, jax params, the same params as numpy)."""
    jc, tc = jax_get_config(ARCH).smoke(), get_config(ARCH).smoke()
    params = japi.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, params, jax.tree.map(np.asarray, params)


def port_params(tree):
    return lm.params_from_numpy(tree, device="cpu")


def dec_layer0(tree, part):
    return jax.tree.map(lambda a: a[0], tree["dec_blocks"][part])


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def inputs(tc, seed=3, batch=2):
    """(frames (B, F, D), prompt tokens (B, PROMPT), forced (STEPS, B))."""
    rng = np.random.default_rng(seed)
    frames = rand(rng, batch, tc.num_frames, tc.d_model)
    toks = rng.integers(0, tc.vocab_size, (batch, PROMPT)).astype(np.int32)
    forced = rng.integers(0, tc.vocab_size, (STEPS, batch)).astype(np.int32)
    return frames, toks, forced


def assert_rel(got, want, rel, scale=None):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


def rel_for(dtype):
    return FP32_REL if dtype == "float32" else BF16_REL


def patched(mp, dtype):
    mp.setattr(jL, "COMPUTE_DTYPE", DTYPES[dtype][0])   # read when jit traces


# --------------------------------------------------------------- config --
def test_whisper_config_is_the_reference_config():
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.smoke()) == dataclasses.asdict(jc.smoke())
    # the published widths
    assert (tc.encoder_layers, tc.num_layers, tc.d_model, tc.num_heads,
            tc.num_kv_heads, tc.resolved_head_dim, tc.d_ff, tc.vocab_size,
            tc.num_frames) == (4, 4, 384, 6, 6, 64, 1536, 51865, 1500)
    assert (tc.norm, tc.act, tc.rope_theta, tc.cross_attention,
            tc.frontend) == ("layernorm", "gelu", 0.0, True, "audio")
    assert tc.source.startswith("arXiv:2212.04356")


def test_input_shapes_are_the_reference_shapes():
    from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
    from repro_torch.configs import INPUT_SHAPES

    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_init_encdec_has_the_reference_layout(whisper, dtype):
    _, tc, _, tree = whisper
    tdt = DTYPES[dtype][1]
    got = api.init_params(tc, torch.Generator().manual_seed(0), device="cpu",
                          dtype=tdt)
    want = {jax.tree_util.keystr(k): v.shape for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    mine = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, got, is_leaf=torch.is_tensor))[0]
    assert {jax.tree_util.keystr(k): tuple(v.shape) for k, v in mine} == want
    assert {v.dtype for _, v in mine} == {tdt}
    # a cross block has no bias; N(0, 1/fan_in) projections, embed 0.02
    assert "bq" not in got["dec_blocks"]["xattn"]
    w = got["enc_blocks"]["ffn"]["w_in"]
    assert abs(float(w.float().std()) * tc.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(got["embed"].float().std()) / 0.02 - 1.0) < 0.05


def test_cross_blocks_drop_the_bias_of_a_biased_config():
    tc = get_config(ARCH).smoke().replace(qkv_bias=True)
    g = torch.Generator().manual_seed(0)
    assert "bq" in L.init_attention(g, tc, (2,), torch.float32, "cpu")
    assert "bq" not in L.init_attention(g, tc, (2,), torch.float32, "cpu",
                                        cross=True)


# --------------------------------------------------------------- layers --
def test_cross_attn_forward_matches_jax(whisper):
    """attn_forward with kv_x: q from the prompt, k and v from the encoder
    states (Sq 24, Sk 32), bidirectional, with the k and v it returns."""
    jc, tc, _, tree = whisper
    rng = np.random.default_rng(1)
    x = rand(rng, 2, PROMPT, tc.d_model)
    enc = rand(rng, 2, tc.num_frames, tc.d_model)
    pos = np.arange(PROMPT, dtype=np.int32)
    epos = np.arange(tc.num_frames, dtype=np.int32)
    p = dec_layer0(tree, "xattn")
    want = jL.attn_forward(jax.tree.map(jnp.asarray, p), jc, jnp.asarray(x),
                           jnp.asarray(pos), causal=False,
                           kv_x=jnp.asarray(enc), kv_positions=jnp.asarray(epos),
                           return_kv=True)
    got = L.attn_forward(port_params(p), tc, torch.from_numpy(x),
                         torch.from_numpy(pos), causal=False,
                         kv_x=torch.from_numpy(enc),
                         kv_positions=torch.from_numpy(epos), return_kv=True)
    assert tuple(got[0].shape) == (2, PROMPT, tc.d_model)
    assert tuple(got[1].shape) == (2, tc.num_frames, tc.num_kv_heads,
                                   tc.resolved_head_dim)
    for g, w in zip(got, want):
        assert_rel(g, w, 1e-5)


def test_cross_attn_forward_rotates_keys_at_their_own_positions():
    """Under RoPE (hymba's smoke config) the keys from kv_x rotate at
    kv_positions, the queries at theirs, as in the reference."""
    arch = "hymba-1.5b"
    jc, tc = jax_get_config(arch).smoke(), get_config(arch).smoke()
    params = jax.tree.map(np.asarray,
                          japi.init_params(jax.random.PRNGKey(0), jc))
    p = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    rng = np.random.default_rng(2)
    x = rand(rng, 2, 5, tc.d_model)
    kv = rand(rng, 2, 11, tc.d_model)
    pos = np.arange(7, 12, dtype=np.int32)
    kpos = np.arange(100, 111, dtype=np.int32)
    want = jL.attn_forward(jax.tree.map(jnp.asarray, p), jc, jnp.asarray(x),
                           jnp.asarray(pos), causal=False,
                           kv_x=jnp.asarray(kv), kv_positions=jnp.asarray(kpos),
                           return_kv=True)
    got = L.attn_forward(port_params(p), tc, torch.from_numpy(x),
                         torch.from_numpy(pos), causal=False,
                         kv_x=torch.from_numpy(kv),
                         kv_positions=torch.from_numpy(kpos), return_kv=True)
    for g, w in zip(got, want):
        assert_rel(g, w, 1e-5)


@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "float32"),
                                    ("bfloat16", "bfloat16")],
                         ids=lambda d: "x-{}-cache-{}".format(*d))
def test_cross_decode_matches_jax(whisper, dtypes):
    """One token against 32 cached encoder frames, x and the cache in each
    pair of dtypes the port serves."""
    jc, tc, _, tree = whisper
    xdt, cdt = dtypes
    rng = np.random.default_rng(4)
    x1 = rand(rng, 3, 1, tc.d_model)
    ck, cv = (rand(rng, 3, tc.num_frames, tc.num_kv_heads,
                   tc.resolved_head_dim) for _ in range(2))
    p = dec_layer0(tree, "xattn")
    jx = jnp.asarray(x1).astype(DTYPES[xdt][0])
    jk, jv = (jnp.asarray(a).astype(DTYPES[cdt][0]) for a in (ck, cv))
    want = jL.cross_decode(jax.tree.map(jnp.asarray, p), jc, jx, jk, jv,
                           tc.num_frames)
    tx = torch.from_numpy(x1).to(DTYPES[xdt][1])
    tk, tv = (torch.from_numpy(a).to(DTYPES[cdt][1]) for a in (ck, cv))
    got = L.cross_decode(port_params(p), tc, tx, tk, tv, tc.num_frames)
    assert got.dtype == DTYPES[xdt][1] and tuple(got.shape) == (3, 1,
                                                                tc.d_model)
    assert_rel(got, want, 1e-5 if xdt == "float32" else 1e-2)


# -------------------------------------------------- encode and forward --
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_matches_jax(whisper, dtype):
    jc, tc, params, tree = whisper
    frames, _, _ = inputs(tc)
    with pytest.MonkeyPatch.context() as mp:
        patched(mp, dtype)
        want = jax.jit(lambda p, f: jencdec.encode(p, jc, f))(params, frames)
    got = encdec.encode(port_params(tree), tc, torch.from_numpy(frames),
                        compute_dtype=DTYPES[dtype][1])
    assert got.dtype == DTYPES[dtype][1]
    assert_rel(got, want, 1e-5 if dtype == "float32" else BF16_REL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_jax(whisper, dtype):
    jc, tc, params, tree = whisper
    frames, toks, _ = inputs(tc)
    with pytest.MonkeyPatch.context() as mp:
        patched(mp, dtype)
        want, waux = jax.jit(lambda p, t, f: jencdec.forward(p, jc, t, f))(
            params, toks, frames)
    got, aux = encdec.forward(port_params(tree), tc, torch.from_numpy(toks),
                              torch.from_numpy(frames),
                              compute_dtype=DTYPES[dtype][1])
    assert tuple(got.shape) == (2, PROMPT, tc.vocab_size)
    assert float(aux) == float(waux) == 0.0
    assert_rel(got, want, rel_for(dtype))


def test_forward_remat_is_refused_until_training_is_ported(whisper):
    """Training is ported: ``remat=True`` (each decoder layer
    rematerialised in the backward) runs and gives the same logits as
    without it, and a gradient through them."""
    _, tc, _, tree = whisper
    frames, toks, _ = inputs(tc)
    params = port_params(tree)
    args = (params, tc, torch.from_numpy(toks), torch.from_numpy(frames))
    want, _ = encdec.forward(*args, compute_dtype=torch.float32)
    head = params["lm_head"].requires_grad_()
    got, aux = encdec.forward(*args, remat=True, compute_dtype=torch.float32)
    assert torch.equal(got.detach(), want) and float(aux) == 0.0
    (grad,) = torch.autograd.grad(got.sum(), head)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    head.requires_grad_(False)


# ------------------------------------------------- prefill + decode steps --
def snapshot(cache):
    """decode_step updates the cache in place: keep each step's."""
    return {k: v.clone() if torch.is_tensor(v) else v
            for k, v in cache.items()}


@pytest.fixture(scope="module", params=sorted(DTYPES))
def smoke_run(request, whisper):
    """Prefill of a 24-token prompt over 32 frames and three decode steps
    on forced tokens, through both packages in one compute dtype.  Returns
    (dtype, [(jax logits, jax cache), ...], the same from the port)."""
    jc, tc, params, tree = whisper
    dtype = request.param
    frames, toks, forced = inputs(tc)
    with pytest.MonkeyPatch.context() as mp:
        patched(mp, dtype)
        logits, cache = jax.jit(lambda p, t, f: jencdec.prefill(
            p, jc, t, f, max_len=MAX_LEN, cache_dtype=jnp.float32))(
                params, toks, frames)
        step = jax.jit(lambda p, t, c: jencdec.decode_step(p, jc, t, c))
        jax_out = [(logits, cache)]
        for t in range(STEPS):
            logits, cache = step(params, forced[t], cache)
            jax_out.append((logits, cache))
    jax_out = [(np.asarray(lg, np.float32), jax.tree.map(np.asarray, c))
               for lg, c in jax_out]
    tp, tdt = port_params(tree), DTYPES[dtype][1]
    logits, cache = encdec.prefill(tp, tc, torch.from_numpy(toks),
                                   torch.from_numpy(frames),
                                   max_len=MAX_LEN, cache_dtype=torch.float32,
                                   compute_dtype=tdt)
    port_out = [(logits, snapshot(cache))]
    for t in range(STEPS):
        logits, cache = encdec.decode_step(tp, tc, torch.from_numpy(forced[t]),
                                           cache, compute_dtype=tdt)
        port_out.append((logits, snapshot(cache)))
    return dtype, jax_out, port_out


def test_prefill_and_decode_logits_match_jax(smoke_run):
    dtype, jax_out, port_out = smoke_run
    for (want, _), (got, _) in zip(jax_out, port_out):
        assert got.dtype == DTYPES[dtype][1]
        assert_rel(got, want, rel_for(dtype))


def test_prefill_and_decode_caches_match_jax(smoke_run):
    dtype, jax_out, port_out = smoke_run
    for (want_logits, want), (_, got) in zip(jax_out, port_out):
        assert sorted(got) == sorted(want)
        assert got["pos"] == int(want["pos"])
        np.testing.assert_array_equal(got["kpos"].numpy(), want["kpos"])
        for key in ("k", "v", "cross_k", "cross_v"):
            assert got[key].dtype == torch.float32
            assert tuple(got[key].shape) == want[key].shape
            if dtype == "float32":
                assert_rel(got[key], want[key], FP32_REL,
                           scale=np.abs(want_logits).max())
            else:
                assert_rel(got[key], want[key], BF16_REL)


def test_cache_layout_after_prefill_and_steps(smoke_run, whisper):
    _, _, port_out = smoke_run
    tc = whisper[1]
    _, cache = port_out[-1]
    assert cache["pos"] == PROMPT + STEPS
    kpos = cache["kpos"].numpy()
    assert list(kpos) == list(range(PROMPT + STEPS)) + [-1] * (
        MAX_LEN - PROMPT - STEPS)
    assert tuple(cache["cross_k"].shape) == (
        tc.num_layers, 2, tc.num_frames, tc.num_kv_heads,
        tc.resolved_head_dim)
    # the encoder's k and v are written once, in prefill
    assert torch.equal(cache["cross_k"], port_out[0][1]["cross_k"])


def greedy(step_fns, steps):
    """Tokens of a greedy generation: prefill, then ``steps`` decode steps
    on the argmax."""
    prefill, decode = step_fns
    logits, cache = prefill()
    out = [np.asarray(logits).argmax(-1)]
    for _ in range(steps):
        logits, cache = decode(out[-1], cache)
        out.append(np.asarray(logits).argmax(-1))
    return np.stack(out, 1)


def test_greedy_tokens_equal_the_jax_packages(whisper, monkeypatch):
    jc, tc, params, tree = whisper
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    frames, toks, _ = inputs(tc, seed=5, batch=3)
    step = jax.jit(lambda p, t, c: jencdec.decode_step(p, jc, t, c))
    want = greedy((lambda: jax.jit(lambda p, t, f: jencdec.prefill(
        p, jc, t, f, max_len=PROMPT + 6, cache_dtype=jnp.float32))(
            params, toks, frames),
        lambda t, c: step(params, t.astype(np.int32), c)), 5)
    tp = port_params(tree)
    got = greedy((lambda: encdec.prefill(
        tp, tc, torch.from_numpy(toks), torch.from_numpy(frames),
        max_len=PROMPT + 6, cache_dtype=torch.float32,
        compute_dtype=torch.float32),
        lambda t, c: encdec.decode_step(tp, tc, torch.from_numpy(t), c,
                                        compute_dtype=torch.float32)), 5)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)


def test_prefill_then_decode_matches_forward(whisper):
    """decode(prefill(prompt)) logits == forward(prompt + token) logits,
    the port against itself, as the reference's smoke test holds its own."""
    _, tc, _, tree = whisper
    tp = port_params(tree)
    frames, toks, forced = inputs(tc, seed=6)
    f, t = torch.from_numpy(frames), torch.from_numpy(toks)
    _, cache = encdec.prefill(tp, tc, t, f, max_len=PROMPT + 4,
                              cache_dtype=torch.float32,
                              compute_dtype=torch.float32)
    nxt = torch.from_numpy(forced[0])
    got, _ = encdec.decode_step(tp, tc, nxt, cache,
                                compute_dtype=torch.float32)
    want, _ = encdec.forward(tp, tc, torch.cat([t, nxt[:, None]], 1), f,
                             compute_dtype=torch.float32)
    assert_rel(got, want[:, -1].numpy(), 1e-5)


def test_api_init_cache_is_the_reference_cache(whisper):
    jc, tc, _, _ = whisper
    want = japi.init_cache(jc, 2, 40, jnp.float32)
    got = api.init_cache(tc, 2, 40, dtype=torch.float32, device="cpu")
    assert sorted(got) == sorted(want) and got["pos"] == 0
    for key in ("k", "v", "kpos", "cross_k", "cross_v"):
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_array_equal(got[key].numpy(), want[key])


# ------------------------------------------------------ serving steps --
BUILDER_ARCHS = (ARCH, "stablelm-1.6b")


@pytest.fixture(scope="module")
def builder_models(whisper):
    out = {ARCH: whisper}
    for arch in BUILDER_ARCHS[1:]:
        jc, tc = jax_get_config(arch).smoke(), get_config(arch).smoke()
        params = japi.init_params(jax.random.PRNGKey(0), jc)
        out[arch] = (jc, tc, params, jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", BUILDER_ARCHS)
def test_serve_step_builders_match_the_reference_builders(
        arch, dtype, builder_models):
    """The reference's build_prefill_step / build_decode_step jitted on its
    host mesh against the port's on the CPU: prefill logits and cache, then
    three greedy steps, each package's step fed the reference's previous
    token: tokens (fp32) and caches."""
    jc, tc, params, tree = builder_models[arch]
    frames, toks, _ = inputs(tc, seed=7)
    jbatch = {"tokens": toks}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if tc.cross_attention:
        jbatch["frames"] = frames
        tbatch["frames"] = torch.from_numpy(frames)
    mesh = make_host_mesh()
    with pytest.MonkeyPatch.context() as mp, mesh_context(mesh):
        patched(mp, dtype)
        jshape = JaxShapeConfig("t", MAX_LEN, 2, "decode")
        logits, cache = jax.jit(jserve.build_prefill_step(
            jc, jshape, mesh, cache_dtype=jnp.float32, max_len=MAX_LEN))(
                params, jbatch)
        jstep = jax.jit(jserve.build_decode_step(jc, jshape, mesh))
        want_logits = np.asarray(logits, np.float32)
        fed = [np.asarray(jnp.argmax(logits, -1).astype(jnp.int32))]
        caches = [jax.tree.map(np.asarray, cache)]
        for _ in range(STEPS):
            tok, cache = jstep(params, cache, {"token": fed[-1]})
            fed.append(np.asarray(tok))
            caches.append(jax.tree.map(np.asarray, cache))
    tp, tdt = port_params(tree), DTYPES[dtype][1]
    shape = ShapeConfig("t", MAX_LEN, 2, "decode")
    logits, cache = serve.build_prefill_step(
        tc, shape, cache_dtype=torch.float32, max_len=MAX_LEN,
        compute_dtype=tdt)(tp, tbatch)
    assert_rel(logits, want_logits, rel_for(dtype))
    got_fed, got_caches = [logits.argmax(-1).to(torch.int32)], [
        snapshot(cache)]
    tstep = serve.build_decode_step(tc, shape, compute_dtype=tdt)
    for t in range(STEPS):
        tok, cache = tstep(tp, cache, {"token": torch.tensor(fed[t])})
        got_fed.append(tok)
        got_caches.append(snapshot(cache))
    scale = np.abs(want_logits).max()
    for want_tok, got_tok, want, got in zip(fed, got_fed, caches,
                                             got_caches):
        assert got_tok.dtype == torch.int32
        if dtype == "float32":          # bf16 logits may order differently
            np.testing.assert_array_equal(got_tok.numpy(), want_tok)
        assert sorted(got) == sorted(want)
        assert got["pos"] == int(want["pos"])
        np.testing.assert_array_equal(got["kpos"].numpy(), want["kpos"])
        for key in sorted(set(want) - {"pos", "kpos"}):
            if dtype == "float32":
                assert_rel(got[key], want[key], FP32_REL, scale=scale)
            else:
                assert_rel(got[key], want[key], BF16_REL)


@pytest.mark.parametrize("arch", BUILDER_ARCHS)
def test_serve_step_builders_refuse_a_mesh(arch, builder_models):
    """Both families' builders take a mesh whose data axis holds two
    positions and one whose model axis holds four, with and without
    ``serve_tp_only``, and serve a tree placed over it by
    ``serve_shardings`` (whole logits (B, V), the greedy tokens of the
    whole tree's; the steps against the reference are in
    ``tests/test_torch_tp_encdec.py`` and ``tests/test_torch_tp_serve.py``)."""
    from repro_torch import perf_flags
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import sharding

    _, tc, _, tree = builder_models[arch]
    frames, toks, _ = inputs(tc, seed=7)
    batch = {"tokens": torch.from_numpy(toks)}
    if tc.cross_attention:
        batch["frames"] = torch.from_numpy(frames)
    shape = ShapeConfig("t", MAX_LEN, 2, "decode")
    kw = dict(cache_dtype=torch.float32, max_len=MAX_LEN,
              compute_dtype=torch.float32)
    params = port_params(tree)
    want, _ = serve.build_prefill_step(tc, shape, **kw)(params, batch)
    data2 = Mesh(["cpu"] * 2, (2, 1), ("data", "model"))
    model4 = Mesh(["cpu"] * 4, (1, 4), ("data", "model"))
    for tp_only in (False, True):
        perf_flags.set_flags(serve_tp_only=tp_only)
        try:
            for mesh in (data2, model4):
                pre = serve.build_prefill_step(tc, shape, mesh, **kw)
                assert callable(serve.build_decode_step(tc, shape, mesh))
                placed = sharding.shard_tree(params, serve.serve_shardings(
                    tc, shape, mesh, params)[0])
                logits, cache = pre(placed, batch)
                assert logits.shape == (2, tc.vocab_size)
                assert_rel(logits, want.numpy(), 1e-5)
                assert torch.equal(logits.argmax(-1), want.argmax(-1))
                assert isinstance(cache["k"], sharding.Sharded)
        finally:
            perf_flags.reset_flags()
