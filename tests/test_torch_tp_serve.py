"""The decoders' serving steps on a (data, model) mesh against the JAX
reference on one device, on the CPU: qwen2-72b and stablelm-1.6b here,
granite-moe-3b-a800m and hymba-1.5b in ``test_torch_tp_serve_moe.py``.

The reference's ``lm.prefill`` and four ``lm.decode_step``s run whole in
fp32 (its ``layers.COMPUTE_DTYPE`` patched) on its own weights; GSPMD does
not change what it computes, so one device stands for every mesh.  The
port places the same weights (``params_from_numpy``) over ``[cpu] * n``
positions by ``steps/serve.serve_shardings`` and runs
``build_prefill_step`` / ``build_decode_step`` on them, fed the
reference's tokens.  Held: each step's logits within 1e-5 of their largest
magnitude and the same greedy tokens; the cache (``lm.unshard_cache``)
within 1e-5 of each leaf's largest magnitude, its slot positions equal.

Cases: meshes (1, 4), (2, 2), (4, 1) and (2, 4) under ``serve_tp_only``
with ``decode_shard_map`` off (heads as the projections leave them) and on
(the sequence over ``model``); B 1 on (2, 4) (the sequence over data and
model jointly, the batch whole at every position); and on (2, 2) with
``serve_tp_only`` off, the train-mode rules' weights split over data too
(gathered at their use).  B 4, a 20-token prompt, a 24-slot cache (hymba's
16-slot ring wraps in prefill).  Then the mesh steps traced on eight meta
positions report each position's kernel calls.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import api, lm  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402
from repro_torch.steps import serve  # noqa: E402

REL = 1e-5
PROMPT, STEPS, B = 20, 4, 4
MAX_LEN = PROMPT + STEPS
# (mesh, B, decode_shard_map, serve_tp_only)
CASES = ([(m, B, f, True) for m in ((1, 4), (2, 2), (4, 1), (2, 4))
          for f in (False, True)]
         + [((2, 4), 1, True, True), ((2, 2), B, False, False)])


def case_id(case):
    (d, m), b, flag, tp_only = case
    return (f"{d}x{m}-B{b}-{'seq' if flag else 'heads'}"
            f"{'' if tp_only else '-fsdp'}")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference(arch, batch):
    """The reference's fp32 prefill and forced decode steps on one device:
    (numpy tree, tokens, forced tokens, logits, cache)."""
    jc = jax_get_config(arch).smoke()
    tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(0),
                                                     jc))
    rng = np.random.default_rng(7)
    attn = tree["blocks"].get("attn", {})
    for name in ("bq", "bk", "bv"):          # qwen2: non-zero biases
        if name in attn:
            attn[name] = (0.1 * rng.standard_normal(attn[name].shape)
                          ).astype(np.float32)
    toks = rng.integers(0, jc.vocab_size, (batch, PROMPT)).astype(np.int32)
    forced = rng.integers(0, jc.vocab_size, (STEPS, batch)).astype(np.int32)
    params = jax.tree.map(jnp.asarray, tree)
    saved = jL.COMPUTE_DTYPE
    jL.COMPUTE_DTYPE = jnp.float32
    try:
        log, cache = jlm.prefill(params, jc, jnp.asarray(toks),
                                 max_len=MAX_LEN, cache_dtype=jnp.float32)
        logits = [np.asarray(log)]
        for t in range(STEPS):
            log, cache = jlm.decode_step(params, jc, jnp.asarray(forced[t]),
                                         cache)
            logits.append(np.asarray(log))
    finally:
        jL.COMPUTE_DTYPE = saved
    return tree, toks, forced, logits, {k: np.asarray(v)
                                        for k, v in cache.items()}


def run_case(arch, case, ref):
    """The port's builders on the case's mesh; returns (logits a step,
    whole cache, the cache as the steps left it)."""
    (d, m), batch, flag, tp_only = case
    tree, toks, forced, _, _ = ref
    cfg = get_config(arch).smoke()
    mesh = Mesh(["cpu"] * (d * m), (d, m), ("data", "model"))
    shape = ShapeConfig("t", MAX_LEN, batch, "decode")
    perf_flags.set_flags(decode_shard_map=flag, serve_tp_only=tp_only)
    try:
        params = lm.params_from_numpy(tree, device="cpu")
        placed = sharding.shard_tree(
            params, serve.serve_shardings(cfg, shape, mesh, params)[0])
        log, cache = serve.build_prefill_step(
            cfg, shape, mesh, cache_dtype=torch.float32, max_len=MAX_LEN,
            compute_dtype=torch.float32)(
                placed, {"tokens": torch.from_numpy(toks)})
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
    return logits, lm.unshard_cache(cache), cache


def check_case(arch, case, ref):
    _, _, _, want_logits, want_cache = ref
    logits, whole, cache = run_case(arch, case, ref)
    for got, want in zip(logits, want_logits):
        got = got.numpy()
        assert np.abs(got - want).max() <= REL * np.abs(want).max()
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert whole["pos"] == int(want_cache["pos"])
    for key, want in want_cache.items():
        if key == "pos":
            continue
        got = whole[key].numpy()
        if key == "kpos":
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= REL * np.abs(want).max(), key
    if "k" in cache:
        seq = cache["k"].spec[2]
        assert (seq is not None) == case[2]
        batch_split = cache["k"].spec[1] is not None
        assert batch_split == (case[1] >= case[0][0] > 1)


@pytest.fixture(scope="module")
def refs():
    out = {}

    def get(arch, batch):
        if (arch, batch) not in out:
            out[(arch, batch)] = reference(arch, batch)
        return out[(arch, batch)]

    return get


@pytest.mark.parametrize("case", CASES, ids=case_id)
@pytest.mark.parametrize("arch", ["qwen2-72b", "stablelm-1.6b"])
def test_mesh_steps_match_the_reference(arch, case, refs):
    check_case(arch, case, refs(arch, case[1]))


# ------------------------------------------------------------------ meta --
def meta_calls(arch, flag):
    """Kernel calls of the prefill and one decode step on 8 meta
    positions, (2, 4), B 4."""
    cfg = get_config(arch).smoke()
    mesh = Mesh(["meta"] * 8, (2, 4), ("data", "model"))
    shape = ShapeConfig("t", MAX_LEN, B, "decode")
    perf_flags.set_flags(decode_shard_map=flag, serve_tp_only=True)
    try:
        shapes = api.param_shapes(cfg, torch.bfloat16)
        placed = sharding.shard_tree(
            shapes, serve.serve_shardings(cfg, shape, mesh, shapes)[0])
        pre = serve.build_prefill_step(cfg, shape, mesh, max_len=MAX_LEN)
        batch = {"tokens": torch.zeros((B, PROMPT), dtype=torch.int32,
                                       device="meta")}
        c_pre = op_cost.analyse_step(pre, placed, batch)
        _, cache = pre(placed, batch)
        step = serve.build_decode_step(cfg, shape, mesh)
        c_dec = op_cost.analyse_step(
            step, placed, cache,
            {"token": torch.zeros(B, dtype=torch.int32, device="meta")})
    finally:
        perf_flags.reset_flags()
    return cfg, c_pre, c_dec


@pytest.mark.parametrize("flag", [False, True], ids=["heads", "seq"])
@pytest.mark.parametrize("arch", ["qwen2-72b", "hymba-1.5b"])
def test_the_mesh_steps_trace_on_meta_positions(arch, flag):
    """Every position's kernel calls: rmsnorm twice a layer and once for
    the head, attention once a layer, hymba's scan once a layer, at each
    of the 8 positions; a decode step's reads one a layer a position (its
    heads, or its sequence shard)."""
    cfg, c_pre, c_dec = meta_calls(arch, flag)
    Lc, n = cfg.num_layers, 8
    want = {"rmsnorm": n * (2 * Lc + 1), "flash_attention": n * Lc}
    if cfg.has_ssm:
        want["ssm_scan"] = n * Lc
    assert c_pre.kernel_calls == want
    assert c_dec.kernel_calls == {"rmsnorm": n * (2 * Lc + 1),
                                  "flash_decode": n * Lc}
    assert c_pre.ops > 0 and c_dec.kernel_flops > 0
