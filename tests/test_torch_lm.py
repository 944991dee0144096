"""The port's LM generation path against the JAX reference, on the CPU.

hymba-1.5b's smoke config (2 hybrid layers, window 16) with the reference's
own weights carried over by ``params_from_numpy``: the layers it runs
(RoPE, causal windowed attention with its k/v, mamba prefill and decode),
then prefill of a 24-token prompt (the 16-slot ring wraps) and three decode
steps on forced tokens, then the generation backend and the serving entry.

fp32 compute is the tight oracle: the JAX model computes in fp32 when its
``layers.COMPUTE_DTYPE`` is patched (``monkeypatch``), and logits and
every cache leaf agree within 1e-4 of the largest logit.  In bf16 (both
packages' default) the two round at different places; they are held within
5e-2 of the largest magnitude.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.llm_backend import \
    LMGenerateBackend as JaxLMBackend  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.llm_backend import LMGenerateBackend  # noqa: E402
from repro_torch.core.routing import Query  # noqa: E402
from repro_torch.data.workload import make_queries  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARCH = "hymba-1.5b"
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
def hymba():
    """(jax cfg, port cfg, jax params, the same params as numpy)."""
    jc, tc = jax_get_config(ARCH).smoke(), get_config(ARCH).smoke()
    params = japi.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, params, jax.tree.map(np.asarray, params)


def port_params(tree):
    return lm.params_from_numpy(tree, device="cpu")


def layer0(tree, part):
    return jax.tree.map(lambda a: a[0], tree["blocks"][part])


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def assert_rel(got, want, rel, scale=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


# --------------------------------------------------------------- configs --
def test_hymba_config_is_the_reference_config():
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("d_inner", "dt_rank", "has_attention", "has_ssm",
                 "has_decoder", "resolved_head_dim"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert (tc.d_inner, tc.dt_rank, tc.num_heads // tc.num_kv_heads) == \
        (3200, 100, 5)
    assert dataclasses.asdict(tc.smoke()) == dataclasses.asdict(jc.smoke())


def test_init_lm_has_the_reference_layout(hymba):
    jc, tc, _, tree = hymba
    got = api.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat = {jax.tree_util.keystr(k): v for k, v in want}
    mine = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0]
    assert {jax.tree_util.keystr(k): (v.shape, v.dtype) for k, v in mine} \
        == {k: (v.shape, v.dtype) for k, v in flat.items()}
    mamba = got["blocks"]["mamba"]
    np.testing.assert_allclose(mamba["A_log"].numpy(),
                               tree["blocks"]["mamba"]["A_log"], rtol=1e-7)
    np.testing.assert_allclose(mamba["dt_bias"].numpy(),
                               tree["blocks"]["mamba"]["dt_bias"], rtol=1e-7)
    # N(0, 1/fan_in) projections
    assert abs(float(got["blocks"]["ffn"]["w_up"].std()) * tc.d_model ** 0.5
               - 1.0) < 0.05


def test_unported_families_raise(hymba):
    _, tc, _, _ = hymba
    g = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="MoE"):
        lm.init_lm(tc.replace(num_experts=4, experts_per_token=2), g,
                   device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        api.init_params(tc.replace(cross_attention=True), g, device="cpu")
    cache = api.init_cache(tc, 2, 40, device="cpu")
    assert cache["k"].shape == (tc.num_layers, 2, 16, tc.num_kv_heads,
                                tc.resolved_head_dim)    # clamped to window
    assert cache["pos"] == 0 and (cache["kpos"] == -1).all()


# ---------------------------------------------------------------- layers --
def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rand(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 5000, (7,)).astype(np.int32)
    want = jL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    assert_rel(got, want, 1e-5)


def test_attn_forward_causal_window_returns_rotated_kv(hymba):
    jc, tc, _, tree = hymba
    rng = np.random.default_rng(1)
    x = rand(rng, 2, PROMPT, tc.d_model)
    p = layer0(tree, "attn")
    pos = np.arange(PROMPT, dtype=np.int32)
    want = jL.attn_forward(jax.tree.map(jnp.asarray, p), jc, jnp.asarray(x),
                           jnp.asarray(pos), return_kv=True)
    got = L.attn_forward(port_params(p), tc, torch.from_numpy(x),
                         torch.from_numpy(pos), return_kv=True)
    for g, w in zip(got, want):
        assert_rel(g, w, 1e-5)


def test_mamba_prefill_and_decode_match_jax(hymba):
    jc, tc, _, tree = hymba
    rng = np.random.default_rng(2)
    p = layer0(tree, "mamba")
    jp, tp = jax.tree.map(jnp.asarray, p), port_params(p)
    x = rand(rng, 2, 20, tc.d_model)
    want = jL.mamba_prefill(jp, jc, jnp.asarray(x))
    got = L.mamba_prefill(tp, tc, torch.from_numpy(x))
    for g, w in zip(got, want):                      # y, ssm state, conv
        assert_rel(g, w, 1e-5)
    x1 = rand(rng, 2, 1, tc.d_model)
    ssm = rand(rng, 2, tc.d_inner, tc.ssm_state)
    conv = rand(rng, 2, tc.ssm_conv - 1, tc.d_inner)
    want = jL.mamba_decode(jp, jc, jnp.asarray(x1), jnp.asarray(ssm),
                           jnp.asarray(conv))
    got = L.mamba_decode(tp, tc, torch.from_numpy(x1), torch.from_numpy(ssm),
                         torch.from_numpy(conv))
    for g, w in zip(got, want):
        assert_rel(g, w, 1e-5)


# ------------------------------------------------- prefill + decode steps --
@pytest.fixture(scope="module", params=sorted(DTYPES))
def smoke_run(request, hymba):
    """Prefill of a 24-token prompt (window 16: the ring wraps) and three
    decode steps on forced tokens, through both packages in one compute
    dtype.  Returns (dtype name, [(jax logits, jax cache), ...], the same
    from the port)."""
    jc, tc, params, tree = hymba
    jdt, tdt = DTYPES[request.param]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tc.vocab_size, (2, PROMPT)).astype(np.int32)
    forced = rng.integers(0, tc.vocab_size, (STEPS, 2)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jL, "COMPUTE_DTYPE", jdt)     # read when jit traces
        logits, cache = jax.jit(lambda p, t: jlm.prefill(
            p, jc, t, max_len=MAX_LEN, cache_dtype=jnp.float32))(params, toks)
        step = jax.jit(lambda p, t, c: jlm.decode_step(p, jc, t, c))
        jax_out = [(logits, cache)]
        for t in range(STEPS):
            logits, cache = step(params, forced[t], cache)
            jax_out.append((logits, cache))
        jax_out = [(np.asarray(lg, np.float32), jax.tree.map(np.asarray, c))
                   for lg, c in jax_out]
    tp = port_params(tree)
    logits, cache = lm.prefill(tp, tc, torch.from_numpy(toks),
                               max_len=MAX_LEN, cache_dtype=torch.float32,
                               compute_dtype=tdt)
    port_out = [(logits, cache)]
    for t in range(STEPS):
        # decode_step updates the cache in place: snapshot each step's
        logits, cache = lm.decode_step(
            tp, tc, torch.from_numpy(forced[t]),
            {k: v.clone() if torch.is_tensor(v) else v
             for k, v in cache.items()}, compute_dtype=tdt)
        port_out.append((logits, cache))
    return request.param, jax_out, port_out


def test_prefill_and_decode_logits_match_jax(smoke_run):
    name, jax_out, port_out = smoke_run
    for (want, _), (got, _) in zip(jax_out, port_out):
        assert got.dtype == DTYPES[name][1]
        rel = FP32_REL if name == "float32" else BF16_REL
        assert_rel(got.float().numpy(), want, rel)


def test_prefill_and_decode_caches_match_jax(smoke_run):
    name, jax_out, port_out = smoke_run
    for (want_logits, want), (_, got) in zip(jax_out, port_out):
        assert got["pos"] == int(want["pos"])
        np.testing.assert_array_equal(got["kpos"].numpy(), want["kpos"])
        assert sorted(got) == sorted(want)
        for key in ("k", "v", "ssm", "conv"):
            assert got[key].dtype == torch.float32
            if name == "float32":
                assert_rel(got[key].numpy(), want[key], FP32_REL,
                           scale=np.abs(want_logits).max())
            else:
                assert_rel(got[key].numpy(), want[key], BF16_REL)


def test_ring_slots_hold_the_last_window_of_positions(smoke_run):
    _, _, port_out = smoke_run
    _, cache = port_out[-1]                  # after 24 + 3 positions
    kpos = cache["kpos"].numpy()
    assert sorted(kpos) == list(range(PROMPT + STEPS - 16, PROMPT + STEPS))
    assert all(kpos[p % 16] == p for p in kpos)


# --------------------------------------------------- backend and serving --
def test_greedy_tokens_equal_the_jax_backend(hymba, monkeypatch):
    jc, tc, params, tree = hymba
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    payloads = make_queries(3, tc.vocab_size, length=20, seed=4)
    qs = [Query(qid=i, payload=p, length=len(p)) for i, p in enumerate(payloads)]
    qs.append(Query(qid=3, length=9))                  # no payload: a ramp
    want = JaxLMBackend(jc, params, max_prompt=24,
                        max_new_tokens=5).embed_batch(qs)
    be = LMGenerateBackend(tc, port_params(tree), max_prompt=24,
                           max_new_tokens=5, device="cpu",
                           compute_dtype=torch.float32)
    got = be.embed_batch(qs)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (5,)
        np.testing.assert_array_equal(g, w)


def test_empty_prompt_is_refused_as_by_the_jax_backend(hymba, monkeypatch):
    jc, tc, params, tree = hymba
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    payloads = make_queries(3, tc.vocab_size, length=12, seed=5)
    qs = [Query(qid=i, payload=p, length=len(p)) for i, p in enumerate(payloads)]
    ref = JaxLMBackend(jc, params, max_prompt=24, max_new_tokens=3)
    be = LMGenerateBackend(tc, port_params(tree), max_prompt=24,
                           max_new_tokens=3, device="cpu",
                           compute_dtype=torch.float32)
    empty = qs[:1] + [Query(qid=7, payload=np.zeros(0, np.int32), length=0)] \
        + qs[1:]
    with pytest.raises(ValueError):
        ref.embed_batch(empty)
    with pytest.raises(ValueError, match="query 7"):
        be.embed_batch(empty)
    # the same batch without the empty payload still gives equal tokens
    for g, w in zip(be.embed_batch(qs), ref.embed_batch(qs)):
        np.testing.assert_array_equal(g, w)


def test_teacher_forced_generation_returns_each_steps_logits(hymba):
    _, tc, _, tree = hymba
    be = LMGenerateBackend(tc, port_params(tree), max_prompt=24,
                           max_new_tokens=4, device="cpu",
                           compute_dtype=torch.float32)
    toks = be.prompt_tokens([Query(qid=0, length=30), Query(qid=1, length=5)])
    assert toks.shape == (2, 24) and (toks[1, :19] == 1).all()
    gen, _ = be.generate(toks)
    forced = gen[:, :-1].T.numpy()             # feed back its own choices
    gen2, logits = be.generate(toks, forced=forced)
    assert torch.equal(gen, gen2)
    assert logits.shape == (4, 2, tc.vocab_size)
    assert torch.equal(logits.argmax(-1).T.to(torch.int32), gen)


def test_serve_llm_main_answers_on_the_cpu():
    from repro_torch.launch import serve_llm

    outs = serve_llm.main(["--smoke", "--device", "cpu", "--queries", "10",
                           "--new-tokens", "4"])
    assert len(outs) == 10
    real = [o for o in outs if o.dtype.kind in "iu"]
    assert real, "the real tier served nothing"
    for o in real:
        assert o.shape == (4,) and ((o >= 0) & (o < 512)).all()
