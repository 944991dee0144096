"""The port's LM generation path against the JAX reference, on the CPU.

hymba-1.5b's smoke config (2 hybrid layers, window 16) with the reference's
own weights carried over by ``params_from_numpy``: the layers it runs
(RoPE, causal windowed attention with its k/v, mamba prefill and decode),
then prefill of a 24-token prompt (the 16-slot ring wraps) and three decode
steps on forced tokens, then the generation backend and the serving entry.
The other decoder families the port serves (stablelm-1.6b: dense MHA;
starcoder2-7b: GQA with layernorm, GELU and a window, 16 at smoke size, so
its ring wraps too; falcon-mamba-7b: mamba only; internlm2-20b: dense GQA;
granite-moe-3b-a800m and qwen3-moe-30b-a3b: MoE, under the global and the
per-row dispatch; internvl2-2b: dense, with a vision frontend) go through
the same prefill, decode steps and greedy generation at their smoke
configs.  Then a bf16 reference tree carried across, internvl2's prefill
with patch embeddings and the backend's cache length.

fp32 compute is the tight oracle: the JAX model computes in fp32 when its
``layers.COMPUTE_DTYPE`` is patched (``monkeypatch``), and logits and
every cache leaf agree within 1e-4 of the largest logit.  In bf16 (both
packages' default) the two round at different places; they are held within
5e-2 of the largest magnitude.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import perf_flags as jflags  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.llm_backend import \
    LMGenerateBackend as JaxLMBackend  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.llm_backend import LMGenerateBackend  # noqa: E402
from repro_torch.core.routing import Query  # noqa: E402
from repro_torch.data.workload import make_queries  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARCH = "hymba-1.5b"
DECODERS = ("stablelm-1.6b", "starcoder2-7b", "falcon-mamba-7b",
            "internlm2-20b", "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
            "internvl2-2b")
MOE = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")
# (arch, MoE dispatch): the MoE decoders also run with moe_row_dispatch
DECODER_RUNS = [(a, "global") for a in DECODERS] + [(a, "row") for a in MOE]
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
def assert_config_is_the_reference_config(arch):
    jc, tc = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("d_inner", "dt_rank", "has_attention", "has_ssm",
                 "has_decoder", "resolved_head_dim"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert dataclasses.asdict(tc.smoke()) == dataclasses.asdict(jc.smoke())
    return tc


def test_hymba_config_is_the_reference_config():
    tc = assert_config_is_the_reference_config(ARCH)
    assert (tc.d_inner, tc.dt_rank, tc.num_heads // tc.num_kv_heads) == \
        (3200, 100, 5)


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
    """Every family the reference serves dispatches in the port now: a
    cross-attention config builds the encoder-decoder's tree and cache
    (``tests/test_torch_encdec.py`` holds them against the reference), a
    decoder its LM cache."""
    _, tc, _, _ = hymba
    g = torch.Generator().manual_seed(0)
    wc = get_config("whisper-tiny").smoke()
    tree = api.init_params(wc, g, device="cpu")
    assert sorted(tree) == ["dec_blocks", "dec_norm", "embed", "enc_blocks",
                            "enc_norm", "lm_head"]
    assert tree["enc_blocks"]["attn"]["wq"].shape[0] == wc.encoder_layers
    assert tree["dec_blocks"]["xattn"]["wk"].shape[0] == wc.num_layers
    wcache = api.init_cache(wc, 2, 40, device="cpu")
    assert wcache["k"].shape == (wc.num_layers, 2, 40, wc.num_kv_heads,
                                 wc.resolved_head_dim)
    assert wcache["cross_k"].shape == (wc.num_layers, 2, wc.num_frames,
                                       wc.num_kv_heads, wc.resolved_head_dim)
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
    return (request.param,) + run_both_packages(*hymba, request.param)


@contextlib.contextmanager
def moe_dispatch(dispatch):
    """Both packages' ``moe_row_dispatch`` flag on for "row"."""
    row = dispatch == "row"
    jflags.set_flags(moe_row_dispatch=row)
    perf_flags.set_flags(moe_row_dispatch=row)
    try:
        yield
    finally:
        jflags.reset_flags()
        perf_flags.reset_flags()


def run_both_packages(jc, tc, params, tree, dtype, dispatch="global"):
    """([(jax logits, jax cache), ...], the same from the port) for the
    prefill of a 24-token prompt and three forced decode steps in
    ``dtype``'s compute, an MoE block under ``dispatch``.

    An MoE config in bf16 runs the reference op by op (``jax.disable_jit``),
    rounding to bf16 after each op as the port does.  Compiled, XLA fuses
    the norms and skips roundings, so router logits move by a bf16 step,
    and a top-K choice whose margin is under that step flips (seen at
    smoke size: granite's second expert chosen by a logit margin of 0.0017
    in layer 0, which moves layer 1's cached k or v by 1.16 where its
    largest is 4.41); op by op, the two packages choose alike."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tc.vocab_size, (2, PROMPT)).astype(np.int32)
    forced = rng.integers(0, tc.vocab_size, (STEPS, 2)).astype(np.int32)
    op_by_op = jc.is_moe and dtype == "bfloat16"
    with pytest.MonkeyPatch.context() as mp, moe_dispatch(dispatch), \
            (jax.disable_jit() if op_by_op else contextlib.nullcontext()):
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
    return jax_out, port_out


def assert_logits_match(name, jax_out, port_out):
    rel = FP32_REL if name == "float32" else BF16_REL
    for (want, _), (got, _) in zip(jax_out, port_out):
        assert got.dtype == DTYPES[name][1]
        assert_rel(got.float().numpy(), want, rel)


def test_prefill_and_decode_logits_match_jax(smoke_run):
    assert_logits_match(*smoke_run)


def assert_caches_match(name, jax_out, port_out, leaves):
    for (want_logits, want), (_, got) in zip(jax_out, port_out):
        assert got["pos"] == int(want["pos"])
        if "kpos" in want:
            np.testing.assert_array_equal(got["kpos"].numpy(), want["kpos"])
        assert sorted(got) == sorted(want)
        for key in leaves:
            assert got[key].dtype == torch.float32
            if name == "float32":
                assert_rel(got[key].numpy(), want[key], FP32_REL,
                           scale=np.abs(want_logits).max())
            else:
                assert_rel(got[key].numpy(), want[key], BF16_REL)


def test_prefill_and_decode_caches_match_jax(smoke_run):
    name, jax_out, port_out = smoke_run
    assert_caches_match(name, jax_out, port_out, ("k", "v", "ssm", "conv"))


def test_ring_slots_hold_the_last_window_of_positions(smoke_run):
    _, _, port_out = smoke_run
    _, cache = port_out[-1]                  # after 24 + 3 positions
    kpos = cache["kpos"].numpy()
    assert sorted(kpos) == list(range(PROMPT + STEPS - 16, PROMPT + STEPS))
    assert all(kpos[p % 16] == p for p in kpos)


# --------------------------------------------------- backend and serving --
def assert_greedy_tokens_equal(jc, tc, params, tree):
    """fp32 greedy continuations of the port's backend equal the JAX
    backend's (the caller patches the reference's compute dtype)."""
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


def test_greedy_tokens_equal_the_jax_backend(hymba, monkeypatch):
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    assert_greedy_tokens_equal(*hymba)


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


# ------------------------------------- the other decoder families (smoke) --
@pytest.mark.parametrize("arch", DECODERS)
def test_decoder_config_is_the_reference_config(arch):
    tc = assert_config_is_the_reference_config(arch)
    # the published widths (layers, d_model, heads / KV heads, head dim,
    # d_ff, vocab, window, d_inner, dt_rank)
    want = {"stablelm-1.6b": (24, 2048, 32, 32, 64, 5632, 100352, 0),
            "starcoder2-7b": (32, 4608, 36, 4, 128, 18432, 49152, 4096),
            "falcon-mamba-7b": (64, 4096, 0, 0, 0, 0, 65024, 0),
            "internlm2-20b": (48, 6144, 48, 8, 128, 16384, 92544, 0),
            "granite-moe-3b-a800m": (32, 1536, 24, 8, 64, 512, 49155, 0),
            "qwen3-moe-30b-a3b": (48, 2048, 32, 4, 64, 768, 151936, 0),
            "internvl2-2b": (24, 2048, 16, 8, 128, 8192, 92553, 0)}[arch]
    assert (tc.num_layers, tc.d_model, tc.num_heads, tc.num_kv_heads,
            tc.resolved_head_dim, tc.d_ff, tc.vocab_size,
            tc.sliding_window) == want
    if arch == "falcon-mamba-7b":
        assert (tc.d_inner, tc.ssm_state, tc.dt_rank) == (8192, 16, 256)
    if arch == "starcoder2-7b":
        assert (tc.act, tc.norm) == ("gelu", "layernorm")
    # (experts, top k, capacity factor)
    if arch in MOE:
        assert (tc.num_experts, tc.experts_per_token, tc.capacity_factor) \
            == {"granite-moe-3b-a800m": (40, 8, 1.25),
                "qwen3-moe-30b-a3b": (128, 8, 1.25)}[arch]
    if arch == "internvl2-2b":
        assert (tc.frontend, tc.num_patches) == ("vision", 256)


@pytest.fixture(scope="module")
def decoders():
    """arch -> (jax cfg, port cfg, jax params, the same params as numpy),
    smoke configs, built once."""
    out = {}
    for arch in DECODERS:
        jc, tc = jax_get_config(arch).smoke(), get_config(arch).smoke()
        params = japi.init_params(jax.random.PRNGKey(0), jc)
        out[arch] = (jc, tc, params, jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", DECODERS[3:])
def test_init_lm_has_the_reference_layout_for_the_new_decoders(
        arch, dtype, decoders):
    """The port's own random tree: the reference's keys, shapes and, as
    asked, dtypes (the MoE block's router and stacked experts)."""
    _, tc, _, tree = decoders[arch]
    tdt = DTYPES[dtype][1]
    got = api.init_params(tc, torch.Generator().manual_seed(0), device="cpu",
                          dtype=tdt)
    want = {jax.tree_util.keystr(k): v.shape for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    mine = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, got, is_leaf=torch.is_tensor))[0]
    assert {jax.tree_util.keystr(k): tuple(v.shape) for k, v in mine} == want
    assert {v.dtype for _, v in mine} == {tdt}
    if arch in MOE:
        ffn = got["blocks"]["ffn"]
        E, D, F = tc.num_experts, tc.d_model, tc.d_ff
        assert ffn["w_gate"].shape == (tc.num_layers, E, D, F)
        # drawn a layer at a time: N(0, 1/fan_in) in every layer
        for w in ffn["w_up"]:
            assert abs(float(w.float().std()) * D ** 0.5 - 1.0) < 0.05


def run_id(run):
    arch, dispatch = run[:2]
    tail = run[2:]
    return "-".join((arch,) + tail + (("row",) if dispatch == "row" else ()))


@pytest.fixture(scope="module",
                params=[(a, m, d) for a, m in DECODER_RUNS
                        for d in sorted(DTYPES)], ids=run_id)
def decoder_run(request, decoders):
    arch, dispatch, dtype = request.param
    return (arch, dtype) + run_both_packages(*decoders[arch], dtype,
                                             dispatch)


def test_decoder_logits_match_jax(decoder_run):
    assert_logits_match(*decoder_run[1:])


def test_decoder_caches_match_jax(decoder_run):
    arch, name, jax_out, port_out = decoder_run
    leaves = (("ssm", "conv") if arch == "falcon-mamba-7b" else ("k", "v"))
    assert set(port_out[0][1]) == set(leaves) | {"pos"} | (
        {"kpos"} if "k" in leaves else set())
    assert_caches_match(name, jax_out, port_out, leaves)
    if arch == "starcoder2-7b":            # 24 + 3 positions, 16 slots
        kpos = port_out[-1][1]["kpos"].numpy()
        assert sorted(kpos) == list(range(PROMPT + STEPS - 16,
                                          PROMPT + STEPS))


@pytest.mark.parametrize("run", DECODER_RUNS, ids=run_id)
def test_decoder_greedy_tokens_equal_the_jax_backend(run, decoders,
                                                     monkeypatch):
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    arch, dispatch = run
    with moe_dispatch(dispatch):
        assert_greedy_tokens_equal(*decoders[arch])


@pytest.mark.parametrize("arch", DECODERS)
def test_serve_llm_serves_each_decoder_on_the_cpu(arch):
    from repro_torch.launch import serve_llm

    outs = serve_llm.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--queries", "10", "--new-tokens", "3"])
    real = [o for o in outs if o.dtype.kind in "iu"]
    assert len(outs) == 10 and real, "the real tier served nothing"
    for o in real:
        assert o.shape == (3,) and ((o >= 0) & (o < 512)).all()


@pytest.mark.parametrize("arch", MOE)
def test_serve_llm_takes_bf16_weights_and_the_row_dispatch(arch, capsys):
    from repro_torch.launch import serve_llm

    outs = serve_llm.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--queries", "6", "--new-tokens", "3",
                           "--weights", "bf16", "--opt", "moe_row_dispatch=1"])
    try:
        assert perf_flags.FLAGS.moe_row_dispatch
    finally:
        perf_flags.reset_flags()
    assert len(outs) == 6
    assert "bytes of bf16 params" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["internlm2-20b", "qwen3-moe-30b-a3b"])
def test_a_bf16_reference_tree_runs_as_in_jax(arch):
    """The two decoders served on bf16-resident weights: the reference's
    own bf16 tree carried across bit for bit, then prefill and decode
    steps in bf16 compute through both packages."""
    jc, tc = jax_get_config(arch).smoke(), get_config(arch).smoke()
    params = japi.init_params(jax.random.PRNGKey(1), jc, jnp.bfloat16)
    tree = jax.tree.map(np.asarray, params)
    tp = port_params(tree)
    for want, got in zip(jax.tree.leaves(tree), jax.tree.leaves(
            tp, is_leaf=torch.is_tensor)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    jax_out, port_out = run_both_packages(jc, tc, params, tree, "bfloat16")
    assert_logits_match("bfloat16", jax_out, port_out)


def test_vlm_prefill_with_patch_embeddings_matches_jax(decoders,
                                                       monkeypatch):
    """internvl2-2b's prefill with its stub patch embeddings (16 at smoke
    size) before a 24-token prompt, then three decode steps, in fp32."""
    jc, tc, params, tree = decoders["internvl2-2b"]
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    rng = np.random.default_rng(8)
    P = tc.num_patches
    patches = rand(rng, 2, P, tc.d_model)
    toks = rng.integers(0, tc.vocab_size, (2, PROMPT)).astype(np.int32)
    forced = rng.integers(0, tc.vocab_size, (STEPS, 2)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t, e: jlm.prefill(
        p, jc, t, e, max_len=P + MAX_LEN, cache_dtype=jnp.float32))(
            params, toks, patches)
    tp = port_params(tree)
    got, got_cache = lm.prefill(tp, tc, torch.from_numpy(toks),
                                torch.from_numpy(patches),
                                max_len=P + MAX_LEN,
                                cache_dtype=torch.float32,
                                compute_dtype=torch.float32)
    assert got_cache["pos"] == int(cache["pos"]) == P + PROMPT
    np.testing.assert_array_equal(got_cache["kpos"].numpy(), cache["kpos"])
    scale = np.abs(np.asarray(logits)).max()
    assert_rel(got.numpy(), logits, FP32_REL)
    for key in ("k", "v"):
        assert_rel(got_cache[key].numpy(), cache[key], FP32_REL, scale=scale)
    step = jax.jit(lambda p, t, c: jlm.decode_step(p, jc, t, c))
    for t in range(STEPS):
        logits, cache = step(params, forced[t], cache)
        got, got_cache = lm.decode_step(tp, tc, torch.from_numpy(forced[t]),
                                        got_cache,
                                        compute_dtype=torch.float32)
        assert_rel(got.numpy(), logits, FP32_REL)


@pytest.mark.parametrize("arch", ["internvl2-2b", "internlm2-20b"])
def test_backend_cache_length_is_the_reference_backends(arch, decoders,
                                                        monkeypatch):
    """The generation backend's prefill cache: the prompt window, the new
    tokens and, for internvl2's vision frontend, its patches, as the
    reference backend sizes it."""
    jc, tc, params, tree = decoders[arch]
    ref = JaxLMBackend(jc, params, max_prompt=24, max_new_tokens=5)
    toks = np.ones((2, 24), np.int32)
    want = ref._prefill(params, jnp.asarray(toks))[1]["k"].shape
    seen = []
    prefill = lm.prefill

    def spy(*a, **kw):
        out = prefill(*a, **kw)
        seen.append(tuple(out[1]["k"].shape))
        return out

    monkeypatch.setattr(lm, "prefill", spy)
    be = LMGenerateBackend(tc, port_params(tree), max_prompt=24,
                           max_new_tokens=5, device="cpu")
    be.generate(toks)
    assert seen == [tuple(want)]
    assert want[2] == 24 + 5 + (tc.num_patches if arch == "internvl2-2b"
                                else 0)


def test_deep_random_mamba_drifts_in_bf16_in_both_packages():
    """falcon-mamba-7b's depth (64 mamba layers) at its smoke width, the
    reference's weights: in fp32 the port computes the reference's prefill
    logits; in bf16 neither package stays near its own fp32 logits, since
    64 random layers amplify rounding.  So a bf16 cosine bar says nothing
    of a kernel at this depth, and ``chip_smoke.py`` holds falcon-mamba's
    kernel-vs-plain logits in fp32 compute."""
    jc = jax_get_config("falcon-mamba-7b").smoke().replace(num_layers=64)
    tc = get_config("falcon-mamba-7b").smoke().replace(num_layers=64)
    params = japi.init_params(jax.random.PRNGKey(0), jc)
    tp = port_params(jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(3).integers(0, 512, (2, 24)).astype(np.int32)
    got = {}
    for name, (jdt, tdt) in DTYPES.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jL, "COMPUTE_DTYPE", jdt)
            logits, _ = jax.jit(lambda p, t: jlm.prefill(
                p, jc, t, cache_dtype=jnp.float32))(params, toks)
        got[f"jax_{name}"] = np.asarray(logits, np.float32)
        logits, _ = lm.prefill(tp, tc, torch.from_numpy(toks),
                               cache_dtype=torch.float32, compute_dtype=tdt)
        got[f"port_{name}"] = logits.float().numpy()

    def min_cos(a, b):
        return float(((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
                      / np.linalg.norm(b, axis=-1)).min())

    assert min_cos(got["port_float32"], got["jax_float32"]) >= 0.99999
    for pkg in ("jax", "port"):
        assert min_cos(got[f"{pkg}_bfloat16"], got[f"{pkg}_float32"]) < 0.9
