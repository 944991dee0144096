"""The port's sequence-sharded decode against the reference's
``decode_shard_map`` path, and qwen2-72b against the reference, on the CPU.

The reference runs ``steps/serve.build_decode_step`` with the flag on over
a (1, 4) mesh of a forced 4-device host pool (a subprocess under
``XLA_FLAGS``, as ``tests/test_mesh.py`` does) and over the 1 x 1 host
mesh, in fp32 compute (its ``layers.COMPUTE_DTYPE`` patched).  The port
runs its builders over a (1, 4) mesh of ``[cpu] * 4`` (and a 1 x 1 one)
on the reference's own weights (``params_from_numpy``): its prefill lays
the cache out over the mesh, and each decode step attends the shards with
the plain version of the combine, the reference's pmax/psum formula step
by step.  Held: the greedy tokens equal the reference's, and every fp32
cache leaf within 1e-6 of its largest magnitude of the port's own steps on
the whole cache (as ``tests/test_perf_flags.py`` holds the reference's
flash-decode path against its baseline) and within 2e-6 of the
reference's (the two packages' fp32 sums differ by about 1e-6).  Cases: stablelm-1.6b (dense), starcoder2-7b
(window 16 at smoke size: the ring wraps in prefill), hymba-1.5b (hybrid:
its SSM state stays on the home device) and qwen2-72b (q/k/v biases).

Then the flash-decode combine's identities on plain tensors, and
qwen2-72b's smoke prefill and decode against the reference without a mesh.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_decode.ref import \
    decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels.flash_decode import (combine_shards,  # noqa: E402
                                              decode_attention_ref,
                                              flash_decode_sharded,
                                              sharded_decode_ref)
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import embedder, lm  # noqa: E402
from repro_torch.steps import serve  # noqa: E402
from tests.test_torch_mesh import run_forced  # noqa: E402

# (arch, prompt tokens, cache length, decode steps, mesh)
CASES = [("stablelm-1.6b", 13, 32, 8, "1x4"),
         ("starcoder2-7b", 21, 32, 6, "1x4"),
         ("hymba-1.5b", 21, 32, 6, "1x4"),
         ("qwen2-72b", 13, 32, 8, "1x4"),
         ("stablelm-1.6b", 13, 32, 4, "1x1")]
# the sharded path against the port's own whole-cache steps: within 1e-6
# of each leaf's largest magnitude.  Against the reference, across
# packages, whose fp32 matmuls sum in other orders: 2e-6 (measured up to
# 1.1e-6, hymba-1.5b's ssm and v; 7.4e-7 for the dense configs)
CACHE_REL, CROSS_REL = 1e-6, 2e-6
FP32_REL, BF16_REL = 1e-4, 5e-2


def case_id(case):
    return f"{case[0]}-{case[4]}"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One subprocess on a forced 4-device pool runs every case through the
    reference's decode_shard_map path; returns {case id: npz contents}."""
    out = tmp_path_factory.mktemp("sharded_decode")
    run_forced(4, f"""
        import numpy as np
        import jax
        import jax.numpy as jnp
        from repro import perf_flags
        from repro.configs import get_config
        from repro.configs.base import ShapeConfig
        from repro.launch.mesh import _mesh, make_host_mesh, mesh_context
        from repro.models import api, layers as L, lm
        from repro.steps.serve import build_decode_step

        assert len(jax.devices()) == 4
        L.COMPUTE_DTYPE = jnp.float32          # the fp32 oracle
        for arch, prompt, max_len, steps, mesh_kind in {CASES!r}:
            cfg = get_config(arch).smoke()
            params = api.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
            toks = np.random.default_rng(5).integers(
                0, cfg.vocab_size, (2, prompt)).astype(np.int32)
            logits, cache = lm.prefill(params, cfg, jnp.asarray(toks),
                                       max_len=max_len,
                                       cache_dtype=jnp.float32)
            mesh = (_mesh((1, 4), ("data", "model"))
                    if mesh_kind == "1x4" else make_host_mesh())
            shape = ShapeConfig("t", max_len, 2, "decode")
            perf_flags.set_flags(decode_shard_map=True)
            with mesh_context(mesh):
                step = jax.jit(build_decode_step(cfg, shape, mesh))
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                fed = [np.asarray(tok)]
                for _ in range(steps):
                    tok, cache = step(params, cache, {{"token": tok}})
                    fed.append(np.asarray(tok))
            perf_flags.reset_flags()
            arrays = {{"toks": toks, "fed": np.stack(fed)}}
            for k, v in cache.items():
                arrays["cache:" + k] = np.asarray(v)
            flat = jax.tree_util.tree_flatten_with_path(params)[0]
            for path, leaf in flat:
                key = "/".join(p.key for p in path)
                arrays["param:" + key] = np.asarray(leaf)
            np.savez(r"{out}/" + arch + "-" + mesh_kind + ".npz", **arrays)
    """, timeout=600)
    res = {}
    for case in CASES:
        data = np.load(out / f"{case_id(case)}.npz")
        res[case_id(case)] = {k: data[k] for k in data.files}
    return res


def port_run(case, ref, sharded=True):
    """The port's prefill + decode steps over the case's mesh, fp32, with
    the flash-decode path on (the cache laid out over the mesh) or off."""
    arch, prompt, max_len, steps, mesh_kind = case
    cfg = get_config(arch).smoke()
    params = lm.params_from_numpy(
        embedder.unflatten({k: v for k, v in ref.items()
                            if k.startswith("param:")}, "param:"),
        device="cpu")
    n = 4 if mesh_kind == "1x4" else 1
    mesh = Mesh(["cpu"] * n, (1, n), ("data", "model"))
    shape = ShapeConfig("t", max_len, 2, "decode")
    perf_flags.set_flags(decode_shard_map=sharded)
    try:
        logits, cache = serve.build_prefill_step(
            cfg, shape, mesh, cache_dtype=torch.float32, max_len=max_len,
            compute_dtype=torch.float32)(
                params, {"tokens": torch.from_numpy(ref["toks"])})
        step = serve.build_decode_step(cfg, shape, mesh,
                                       compute_dtype=torch.float32)
        tok = logits.argmax(-1).to(torch.int32)
        fed = [tok]
        for _ in range(steps):
            tok, cache = step(params, cache, {"token": tok})
            fed.append(tok)
    finally:
        perf_flags.reset_flags()
    return torch.stack(fed), cache


def assert_leaves_close(got, want, rel):
    for key in sorted(k for k in want if k not in ("pos", "kpos")):
        w = np.asarray(want[key], np.float32)
        err = np.abs(np.asarray(got[key], np.float32) - w).max()
        assert err <= rel * np.abs(w).max(), (key, err, np.abs(w).max())


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_sharded_decode_matches_the_reference(reference, case):
    ref = reference[case_id(case)]
    fed, cache = port_run(case, ref)
    n = 4 if case[4] == "1x4" else 1
    assert isinstance(cache["k"], lm.sharding.Sharded)
    assert len(cache["k"].along(2)) == n
    np.testing.assert_array_equal(fed.numpy(), ref["fed"])
    whole = lm.unshard_cache(cache)
    assert whole["pos"] == int(ref["cache:pos"])
    np.testing.assert_array_equal(whole["kpos"].numpy(), ref["cache:kpos"])
    assert_leaves_close(whole, {k[6:]: v for k, v in ref.items()
                                if k.startswith("cache:")}, CROSS_REL)
    # the sharding alone: the port's own steps on the whole cache
    base_fed, base = port_run(case, ref, sharded=False)
    assert not isinstance(base["k"], lm.sharding.Sharded)
    assert torch.equal(base_fed, fed)
    assert torch.equal(base["kpos"], whole["kpos"])
    assert_leaves_close(whole, base, CACHE_REL)


def test_only_the_owner_shard_takes_the_new_token():
    """A step writes the new token's k and v into the one shard whose slot
    range holds its slot; the other shards' blocks stay bit for bit."""
    cfg = get_config("stablelm-1.6b").smoke()
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = Mesh(["cpu"] * 4, (1, 4), ("data", "model"))
    ctx = (mesh, "data", ("model",))
    toks = torch.randint(0, cfg.vocab_size, (2, 13),
                         generator=torch.Generator().manual_seed(1))
    _, cache = lm.prefill(params, cfg, toks, cache_dtype=torch.float32,
                          max_len=32, compute_dtype=torch.float32,
                          shard_ctx=ctx)
    before = [t.clone() for t in cache["k"].along(2)]
    perf_flags.set_flags(decode_shard_map=True)
    try:
        lm.decode_step(params, cfg, toks[:, -1], cache,
                       compute_dtype=torch.float32, shard_ctx=ctx)
    finally:
        perf_flags.reset_flags()
    after = cache["k"].along(2)
    changed = [not torch.equal(a, b) for a, b in zip(after, before)]
    assert changed == [False, True, False, False]          # slot 13 of 32
    assert cache["kpos"].along(0)[1][5] == 13
    assert (cache["kpos"].along(0)[2] == -1).all()


def test_init_cache_lays_out_an_empty_cache_over_the_mesh():
    """hymba's empty cache over a (1, 4) mesh: k, v and kpos in 4 sequence
    shards of 4 slots (its 16-slot ring), the SSM state whole."""
    cfg = get_config("hymba-1.5b").smoke()
    ctx = (Mesh(["cpu"] * 4, (1, 4), ("data", "model")), "data", ("model",))
    cache = lm.init_cache(cfg, 2, 64, torch.float32, "cpu", shard_ctx=ctx)
    for name in ("k", "v"):
        assert [t.shape[2] for t in cache[name].along(2)] == [4] * 4
    assert all((t == -1).all() for t in cache["kpos"].along(0))
    assert isinstance(cache["ssm"], torch.Tensor) and cache["pos"] == 0
    whole = lm.unshard_cache(cache)
    assert whole["k"].shape == (cfg.num_layers, 2, 16, cfg.num_kv_heads,
                                cfg.resolved_head_dim)


def test_sharded_decode_refuses_a_whole_cache_and_a_data_axis():
    """A whole cache under decode_shard_map is refused; a cache laid out
    over a data axis (each row on its own position) holds the whole
    cache's values, and a whole tree's sequence-split read refuses it (a
    batch over data runs on a tree placed over the mesh, models/tp.py)."""
    cfg = get_config("stablelm-1.6b").smoke()
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((2, 5), dtype=torch.int32)
    _, cache = lm.prefill(params, cfg, toks, max_len=8)
    ctx = (Mesh(["cpu"] * 4, (1, 4), ("data", "model")), "data", ("model",))
    perf_flags.set_flags(decode_shard_map=True)
    try:
        with pytest.raises(TypeError, match="not laid out"):
            lm.decode_step(params, cfg, toks[:, -1], cache, shard_ctx=ctx)
    finally:
        perf_flags.reset_flags()
    data_ctx = (Mesh(["cpu"] * 4, (2, 2), ("data", "model")), "data",
                ("model",))
    split = lm.shard_cache(cache, data_ctx)
    assert [tuple(b.shape) for b in split["k"].blocks] == [
        (cfg.num_layers, 1, 4, cfg.num_kv_heads, cfg.resolved_head_dim)] * 4
    assert [i[1] for i in split["k"].index] == [slice(0, 1)] * 2 + [
        slice(1, 2)] * 2
    whole = lm.unshard_cache(split)
    assert whole["pos"] == cache["pos"]
    for key in ("k", "v", "kpos"):
        assert torch.equal(whole[key], cache[key]), key
    perf_flags.set_flags(decode_shard_map=True)
    try:
        with pytest.raises(TypeError, match="batch is whole"):
            lm.decode_step(params, cfg, toks[:, -1], split,
                           shard_ctx=data_ctx)
    finally:
        perf_flags.reset_flags()


# ------------------------------------------------ the combine's identities --
def _inputs(seed, B=2, KV=2, G=4, hd=32, Sc=64, filled=40):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sc, KV, hd)).astype(np.float32)
            for _ in range(2))
    kpos = np.full(Sc, -1, np.int32)
    kpos[:filled] = np.arange(filled)
    return q, k, v, kpos


@pytest.mark.parametrize("filled", [64, 40, 9, 0])
def test_plain_lse_combine_is_the_whole_cache_read(filled):
    """Per-shard (output, log-sum-exp) pairs of the plain version, combined,
    equal the read of the whole cache, and so do the reference's shard_map
    formula (``sharded_decode_ref``) and the router on CPU tensors; all
    equal the reference's jnp oracle.  Shards with no valid slot carry
    lse -1e30 and weigh nothing; with none at all the output is zeros."""
    q, k, v, kpos = (torch.from_numpy(a) for a in _inputs(3, filled=filled))
    pos = max(filled - 1, 0) if filled else -1
    whole = decode_attention_ref(q, k, v, kpos, pos)
    ks, vs, kps = (list(t.split(16, d)) for t, d in ((k, 1), (v, 1),
                                                      (kpos, 0)))
    parts = [decode_attention_ref(q, a, b, c, pos, lse=True)
             for a, b, c in zip(ks, vs, kps)]
    for (_, lse), kp in zip(parts, kps):
        if not ((kp >= 0) & (kp <= pos)).any():
            assert (lse == -1e30).all()
    combined = combine_shards(*zip(*parts))
    formula = sharded_decode_ref(q, ks, vs, kps, pos)
    routed = flash_decode_sharded(q, ks, vs, kps, pos)
    want = np.asarray(jax_decode_ref(*(jnp.asarray(t.numpy())
                                       for t in (q, k, v, kpos)), pos))
    for got in (whole, combined, formula, routed):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if not filled:
        assert (formula == 0).all() and (combined == 0).all()


def test_plain_lse_is_the_log_of_the_softmax_denominator():
    q, k, v, kpos = (torch.from_numpy(a) for a in _inputs(4))
    _, lse = decode_attention_ref(q, k, v, kpos, 39, lse=True)
    s = torch.einsum("bkgh,bskh->bkgs", q, k[:, :40]) / np.sqrt(32)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)


# ------------------------------------------------------------ qwen2-72b --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_smoke_prefill_and_decode_match_the_reference(dtype,
                                                            monkeypatch):
    """qwen2-72b's smoke config (2 layers, q/k/v biases, rope 1e6) with the
    reference's weights: prefill logits and cache, then three decode steps
    on forced tokens; fp32 within 1e-4 of the largest logit (and equal
    greedy tokens), bf16 within 5e-2."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jdt)
    jc, tc = jax_get_config("qwen2-72b").smoke(), get_config(
        "qwen2-72b").smoke()
    assert tc.qkv_bias and tc == tc.replace()
    params = japi.init_params(jax.random.PRNGKey(0), jc)
    tree = jax.tree.map(np.asarray, params)
    assert {"bq", "bk", "bv"} <= set(tree["blocks"]["attn"])
    # non-zero biases, so the bias path is exercised
    rng = np.random.default_rng(2)
    for name in ("bq", "bk", "bv"):
        tree["blocks"]["attn"][name] = 0.1 * rng.standard_normal(
            tree["blocks"]["attn"][name].shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    toks = rng.integers(0, jc.vocab_size, (2, 24)).astype(np.int32)
    forced = rng.integers(0, jc.vocab_size, (3, 2)).astype(np.int32)
    jlog, jcache = jlm.prefill(jparams, jc, jnp.asarray(toks), max_len=28,
                               cache_dtype=jnp.float32)
    want = [np.asarray(jlog, np.float32)]
    for t in range(3):
        jlog, jcache = jlm.decode_step(jparams, jc, jnp.asarray(forced[t]),
                                       jcache)
        want.append(np.asarray(jlog, np.float32))
    tparams = lm.params_from_numpy(tree, device="cpu")
    log, cache = lm.prefill(tparams, tc, torch.from_numpy(toks), max_len=28,
                            cache_dtype=torch.float32, compute_dtype=tdt)
    got = [log.float().numpy()]
    for t in range(3):
        log, cache = lm.decode_step(tparams, tc, torch.from_numpy(forced[t]),
                                    cache, compute_dtype=tdt)
        got.append(log.float().numpy())
    scale = max(np.abs(w).max() for w in want)
    rel = FP32_REL if dtype == "float32" else BF16_REL
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= rel * scale
        if dtype == "float32":
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    for key in ("k", "v"):
        w = np.asarray(jcache[key], np.float32)
        assert np.abs(cache[key].numpy() - w).max() <= rel * np.abs(w).max()
    np.testing.assert_array_equal(cache["kpos"].numpy(),
                                  np.asarray(jcache["kpos"]))
