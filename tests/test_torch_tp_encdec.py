"""whisper-tiny's encoder-decoder served over a (data, model) mesh against
the JAX reference on one device, on the CPU.

The smoke config at 6 heads of 32 (whisper-tiny's head count, which a
model axis of 4 does not divide) and 6 KV heads, 2 encoder and 2 decoder
layers, 32 stub frames, with the reference's own weights carried over by
``params_from_numpy``.  The reference's ``encdec.prefill`` and four
``encdec.decode_step``s run whole in fp32 (its ``layers.COMPUTE_DTYPE``
patched); GSPMD does not change what it computes, so one device stands
for every mesh.  The port places the same weights over ``[cpu] * n``
positions by ``steps/serve.serve_shardings`` and runs
``build_prefill_step`` / ``build_decode_step`` on them, fed the
reference's tokens.  Held: each step's logits within 1e-5 of their
largest magnitude and the same greedy tokens; the self ``k``/``v`` and
``cross_k``/``cross_v`` (``lm.unshard_cache``) within 1e-5 of each leaf's
largest magnitude, the slot positions equal.

Cases: meshes (1, 2), (1, 4), (2, 2), (4, 1) and (2, 4) under
``serve_tp_only`` (model 2: 3 whole heads a position, the cache's heads
split; model 4: the block cuts a head, the projections are gathered and
the cache holds every head), and (2, 2) with ``serve_tp_only`` off (the
train-mode rules' data-split weights gathered at their use).  B 4, a
12-token prompt, a 16-slot cache.  Then the mesh steps traced on eight
meta positions report each position's kernel calls.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import api, lm  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402
from repro_torch.steps import serve  # noqa: E402

ARCH = "whisper-tiny"
HEADS = dict(num_heads=6, num_kv_heads=6)
REL = 1e-5
PROMPT, STEPS, B = 12, 4, 4
MAX_LEN = PROMPT + STEPS
# (mesh, serve_tp_only)
CASES = [(m, True) for m in ((1, 2), (1, 4), (2, 2), (4, 1), (2, 4))] + [
    ((2, 2), False)]


def case_id(case):
    (d, m), tp_only = case
    return f"{d}x{m}{'' if tp_only else '-fsdp'}"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference's fp32 prefill and forced decode steps on one device:
    (numpy tree, tokens, frames, forced tokens, logits a step, cache)."""
    jc = dataclasses.replace(jax_get_config(ARCH).smoke(), **HEADS)
    tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(0),
                                                     jc))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab_size, (B, PROMPT)).astype(np.int32)
    frames = rng.standard_normal((B, jc.num_frames, jc.d_model)
                                 ).astype(np.float32)
    forced = rng.integers(0, jc.vocab_size, (STEPS, B)).astype(np.int32)
    params = jax.tree.map(jnp.asarray, tree)
    saved = jL.COMPUTE_DTYPE
    jL.COMPUTE_DTYPE = jnp.float32
    try:
        log, cache = jencdec.prefill(params, jc, jnp.asarray(toks),
                                     jnp.asarray(frames), max_len=MAX_LEN,
                                     cache_dtype=jnp.float32)
        logits = [np.asarray(log)]
        for t in range(STEPS):
            log, cache = jencdec.decode_step(params, jc,
                                             jnp.asarray(forced[t]), cache)
            logits.append(np.asarray(log))
    finally:
        jL.COMPUTE_DTYPE = saved
    return tree, toks, frames, forced, logits, {k: np.asarray(v)
                                                for k, v in cache.items()}


def config():
    return get_config(ARCH).smoke().replace(**HEADS)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_mesh_steps_match_the_reference(case, ref):
    (d, m), tp_only = case
    tree, toks, frames, forced, want_logits, want_cache = ref
    cfg = config()
    mesh = Mesh(["cpu"] * (d * m), (d, m), ("data", "model"))
    shape = ShapeConfig("t", MAX_LEN, B, "decode")
    perf_flags.set_flags(serve_tp_only=tp_only)
    try:
        params = lm.params_from_numpy(tree, device="cpu")
        placed = sharding.shard_tree(
            params, serve.serve_shardings(cfg, shape, mesh, params)[0])
        log, cache = serve.build_prefill_step(
            cfg, shape, mesh, cache_dtype=torch.float32, max_len=MAX_LEN,
            compute_dtype=torch.float32)(
                placed, {"tokens": torch.from_numpy(toks),
                         "frames": torch.from_numpy(frames)})
        step = serve.build_decode_step(cfg, shape, mesh,
                                       compute_dtype=torch.float32,
                                       return_logits=True)
        logits = [log]
        for t in range(STEPS):
            tok, cache, log = step(placed, cache,
                                   {"token": torch.from_numpy(forced[t])})
            assert torch.equal(tok, log.argmax(-1).to(torch.int32))
            logits.append(log)
    finally:
        perf_flags.reset_flags()
    for got, want in zip(logits, want_logits):
        got = got.numpy()
        assert np.abs(got - want).max() <= REL * np.abs(want).max()
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the heads as the projections leave them: split on model 2, every
    # head (gathered) where model 4 cuts one; the batch over data
    heads = "model" if m == 2 else None
    for name in ("k", "v", "cross_k", "cross_v"):
        assert cache[name].spec == (None, "data" if d > 1 else None, None,
                                    heads, None)
    whole = lm.unshard_cache(cache)
    assert sorted(whole) == sorted(want_cache)
    assert whole["pos"] == int(want_cache["pos"])
    np.testing.assert_array_equal(whole["kpos"].numpy(), want_cache["kpos"])
    for key in ("k", "v", "cross_k", "cross_v"):
        got, want = whole[key].numpy(), want_cache[key]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= REL * np.abs(want).max(), key


@pytest.mark.parametrize("model", [2, 4])
def test_the_mesh_steps_trace_on_meta_positions(model):
    """Every position's kernel calls on (8 / model, model) meta positions:
    the prefill's attention once an encoder layer and twice a decoder
    layer (self, then cross), a decode step's flash_decode once a layer
    (its cross attention is plain ops)."""
    cfg = config()
    mesh = Mesh(["meta"] * 8, (8 // model, model), ("data", "model"))
    shape = ShapeConfig("t", MAX_LEN, 8, "decode")
    perf_flags.set_flags(serve_tp_only=True)
    try:
        shapes = api.param_shapes(cfg, torch.float32)
        placed = sharding.shard_tree(
            shapes, serve.serve_shardings(cfg, shape, mesh, shapes)[0])
        pre = serve.build_prefill_step(cfg, shape, mesh, max_len=MAX_LEN,
                                       cache_dtype=torch.float32,
                                       compute_dtype=torch.float32)
        batch = {"tokens": torch.zeros((8, PROMPT), dtype=torch.int32,
                                       device="meta"),
                 "frames": torch.zeros((8, cfg.num_frames, cfg.d_model),
                                       device="meta")}
        c_pre = op_cost.analyse_step(pre, placed, batch)
        _, cache = pre(placed, batch)
        step = serve.build_decode_step(cfg, shape, mesh,
                                       compute_dtype=torch.float32)
        c_dec = op_cost.analyse_step(
            step, placed, cache,
            {"token": torch.zeros(8, dtype=torch.int32, device="meta")})
    finally:
        perf_flags.reset_flags()
    n = 8
    assert c_pre.kernel_calls == {
        "flash_attention": n * (cfg.encoder_layers + 2 * cfg.num_layers)}
    assert c_dec.kernel_calls == {"flash_decode": n * cfg.num_layers}
    assert cache["cross_k"].shape == (cfg.num_layers, 8, cfg.num_frames,
                                      cfg.num_kv_heads,
                                      cfg.resolved_head_dim)


@pytest.mark.parametrize("shape", [(2, 4), (1, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_the_whisper_mesh_part_rehearses_on_the_cpu(shape):
    """``chip_smoke.mesh_tp`` for whisper-tiny at smoke size: the whole
    steps, then the placed tree (not freed: the next mesh reuses it) on
    the mesh's CPU positions, every case held at the card's bars, the
    cross cache's k and v held too."""
    from repro_torch.models import api
    from tests.test_torch_tp_serve_moe import _chip_smoke

    cs = _chip_smoke()
    dev = torch.device("cpu")
    cfg = cs.mesh_config(dev, cs.ENC_ARCH)
    g = torch.Generator().manual_seed(0)
    params = api.init_params(cfg, g, device=dev)
    frames = torch.randn((cs.TP_B, cfg.num_frames, cfg.d_model), generator=g)
    out, _ = cs.mesh_tp(dev, cs.mesh_devices(dev, shape[0] * shape[1]),
                        cs.ENC_ARCH, params, shape, {"frames": frames},
                        free=False)
    assert params["enc_blocks"]["attn"]["wq"].numel()   # kept whole
    (case,) = out["cases"]
    assert case["held"] and case["tokens_equal"]
    assert {"prefill_cross_k_rel", "prefill_cross_v_rel"} <= set(case)
    for k in cs.TP_ENC_SPLIT[shape]:
        assert case["flops_over_whole"][k] == 1.0
    assert case["meta_kernel_calls"]["flash_decode"] > 0
