"""The port's serving backends and driver against the JAX reference, on the
CPU (``device="cpu"``: the same code path with the kernels' plain
versions)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.bucketing import \
    BucketedEmbedderBackend as JaxBucketed  # noqa: E402
from repro.core.routing import Query as JaxQuery  # noqa: E402
from repro.core.sharded_backend import \
    ShardedEmbedderBackend as JaxSharded  # noqa: E402
from repro.core.windve import JaxEmbedderBackend  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.bucketing import BucketedEmbedderBackend  # noqa: E402
from repro_torch.core.device_detector import (detect,  # noqa: E402
                                              probe_torch_devices)
from repro_torch.core.routing import Query  # noqa: E402
from repro_torch.core.sharded_backend import \
    ShardedEmbedderBackend  # noqa: E402
from repro_torch.core.windve import (TorchEmbedderBackend,  # noqa: E402
                                     resolve_device)
from repro_torch.models.embedder import (init_embedder,  # noqa: E402
                                         params_from_numpy, unflatten)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_embed.npz")
MAX_TOKENS = 32
GOLDEN_KW = dict(name="bge-golden", num_layers=1, d_model=32, num_heads=2,
                 num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=128,
                 embed_dim=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread each, so parallel test workers do
    not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    data = np.load(GOLDEN)
    tree = unflatten({k: data[k] for k in data.files}, "param:")
    payloads = [data[f"query:{i}"] for i in range(8)]
    return tree, payloads, data["golden"]


def serve(backend, payloads, query_cls=Query):
    return np.stack(backend.embed_batch(
        [query_cls(qid=i, payload=p, length=len(p))
         for i, p in enumerate(payloads)]))


PORT = {"fixed": (TorchEmbedderBackend, {}),
        "bucketed": (BucketedEmbedderBackend, {"min_seq_bucket": 8}),
        "sharded": (ShardedEmbedderBackend, {"min_seq_bucket": 8})}
JAX = {"fixed": JaxEmbedderBackend, "bucketed": JaxBucketed,
       "sharded": JaxSharded}


@pytest.mark.parametrize("kind", sorted(PORT))
def test_fp32_backend_matches_golden_and_jax_backend(golden, kind):
    tree, payloads, want = golden
    cls, kw = PORT[kind]
    be = cls(dataclasses.replace(get_config("bge-large-zh-v1.5").smoke(),
                                 **GOLDEN_KW),
             params_from_numpy(tree, "cpu"), max_tokens=MAX_TOKENS,
             dtype="fp32", device="cpu", **kw)
    got = serve(be, payloads)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)
    jcfg = dataclasses.replace(jax_get_config("bge-large-zh-v1.5").smoke(),
                               **GOLDEN_KW)
    jbe = JAX[kind](jcfg, tree, max_tokens=MAX_TOKENS, dtype="fp32", **kw)
    np.testing.assert_allclose(got, serve(jbe, payloads, JaxQuery),
                               atol=1e-6)


@pytest.fixture(scope="module")
def bge_smoke():
    cfg = get_config("bge-large-zh-v1.5").smoke()
    return cfg, init_embedder(cfg, torch.Generator().manual_seed(0),
                              device="cpu")


def queries(lengths, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [Query(qid=i, payload=rng.integers(1, vocab, n), length=n)
            for i, n in enumerate(lengths)]


def test_bucketed_output_equals_fixed_window(bge_smoke):
    cfg, params = bge_smoke
    qs = queries([3, 17, 9, 40, 1, 64, 12], vocab=cfg.vocab_size)
    fixed = TorchEmbedderBackend(cfg, params, 64, dtype="fp32", device="cpu")
    bucketed = BucketedEmbedderBackend(cfg, params, 64, dtype="fp32",
                                       device="cpu")
    np.testing.assert_allclose(np.stack(bucketed.embed_batch(qs)),
                               np.stack(fixed.embed_batch(qs)), atol=1e-5)
    assert bucketed.padded_waste < fixed.padded_waste


def test_prewarm_then_zero_new_shapes(bge_smoke):
    cfg, params = bge_smoke
    be = ShardedEmbedderBackend(cfg, params, 64, dtype="fp32", device="cpu",
                                async_dispatch=True)
    grid = be.warm_grid(max_batch=8)
    assert be.prewarm(grid) == len(grid) == be.traces
    assert be.prewarm(grid) == 0                       # idempotent
    for lengths in ([5], [20, 3], [64, 64, 2], [9] * 7, [33] * 8):
        be.embed_batch_async(queries(lengths, vocab=cfg.vocab_size))()
    assert be.traces == len(grid)                      # no new shape
    assert be.bucket_hits > 0


def test_staging_ring_overrun_raises(bge_smoke):
    cfg, params = bge_smoke
    be = ShardedEmbedderBackend(cfg, params, 32, dtype="fp32", device="cpu",
                                staging_slots=2)
    fetches = [be.embed_batch_async(queries([10] * 4, seed=s,
                                            vocab=cfg.vocab_size))
               for s in range(2)]                   # both slots staged
    with pytest.raises(RuntimeError, match="staging ring overrun"):
        be.embed_batch_async(queries([10] * 4, seed=9, vocab=cfg.vocab_size))
    for f in fetches:
        f()
    # the failed call rolled back its count: the ring serves again
    assert len(be.embed_batch(queries([10] * 4, vocab=cfg.vocab_size))) == 4


def test_async_fetch_matches_sync(bge_smoke):
    cfg, params = bge_smoke
    be = ShardedEmbedderBackend(cfg, params, 32, dtype="fp32", device="cpu")
    qs = queries([7, 30, 2], vocab=cfg.vocab_size)
    f = be.embed_batch_async(qs)
    np.testing.assert_allclose(np.stack(f()), np.stack(be.embed_batch(qs)),
                               atol=0)


def test_sharded_backend_refuses_several_devices(bge_smoke):
    """Several devices fan out, and a model axis splits the weights (the
    embedder served tensor parallel, ``tests/test_torch_tp_embed.py``);
    what is still refused: an empty pool and a data axis that is not a
    power of two."""
    from repro_torch.launch.mesh import Mesh

    cfg, params = bge_smoke
    with pytest.raises(ValueError, match="at least one"):
        ShardedEmbedderBackend(cfg, params, devices=[])
    with pytest.raises(ValueError, match="power of two, got 3"):
        ShardedEmbedderBackend(cfg, params, mesh=Mesh(
            ["cpu"] * 3, (3, 1), ("data", "model")))
    tp = ShardedEmbedderBackend(cfg, params, mesh=Mesh(
        ["cpu"] * 4, (2, 2), ("data", "model")))
    assert tp.device_count == 2 and tp.tensor_parallel
    assert tp.min_batch_bucket == 2 and "@2devx2tp" in tp.name
    be = ShardedEmbedderBackend(cfg, params, devices=["cpu", "cpu"])
    assert be.device_count == 2 and "@2dev" in be.name
    assert not be.tensor_parallel


def test_sharded_dtype_defaults_to_the_serving_flag(bge_smoke):
    cfg, params = bge_smoke
    try:
        perf_flags.set_flags(embed_dtype="bf16")
        be = ShardedEmbedderBackend(cfg, params, 32, device="cpu")
    finally:
        perf_flags.reset_flags()
    assert be.dtype == "bf16" and be.serve_dtype == torch.bfloat16
    assert be.params["embed"].dtype == torch.bfloat16
    be = ShardedEmbedderBackend(cfg, params, 32, device="cpu", dtype="int8")
    assert be.serve_dtype == torch.float32 and not be.act_quant
    assert be.params["blocks"]["ffn"]["w_in"].dtype == torch.int8


def test_cuda_without_a_card_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_probe_counts_cuda_devices():
    inv = probe_torch_devices()
    assert inv.npus == torch.cuda.device_count() and inv.cpus == 1
    assert detect(inv).heter_enable == (inv.npus > 0)


def test_build_engine_serves_queries_end_to_end():
    from repro_torch.core.routing import CPU, NPU
    from repro_torch.data.workload import make_queries
    from repro_torch.launch.serve import build_engine

    engine, cfg = build_engine(smoke=True, device="cpu", prewarm=True)
    try:
        be = engine.backends[CPU]
        traces = be.traces
        engine.qm.set_depth(NPU, 0)     # every query to the real tier
        # the depth calibrated from this host's timings shrinks when the
        # CPU is busy; the test is about serving, so give it room for all
        engine.qm.set_depth(CPU, 64)
        futs = [engine.submit(payload=q, length=40)
                for q in make_queries(16, cfg.vocab_size, 40, seed=3)]
        vecs = np.stack([f.result(timeout=60) for f in futs])
    finally:
        engine.shutdown()
    assert vecs.shape == (16, cfg.d_model)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=-1), 1.0, atol=1e-5)
    assert engine.stats.per_device.get(CPU) == 16
    assert be.traces == traces
    assert engine.stats.clean_shutdown


def test_threads_sharing_one_backend_serve_unrotated_vectors(bge_smoke):
    """More worker threads than cores share one backend's staging ring:
    every batch gets its own vectors back and the pending counts drain."""
    import sys
    import threading

    cfg, params = bge_smoke
    n_threads = (os.cpu_count() or 4) + 4
    be = ShardedEmbedderBackend(cfg, params, 32, dtype="fp32", device="cpu",
                                staging_slots=2 * n_threads)
    batches = [queries([12] * 3, seed=s, vocab=cfg.vocab_size)
               for s in range(n_threads)]
    want = [np.stack(be.embed_batch(b)) for b in batches]
    got, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            try:
                for _ in range(3):
                    fetch = be.embed_batch_async(batches[i])
                    got[i] = np.stack(fetch())
            except Exception as e:          # reported by the assert below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for i in range(n_threads):
        np.testing.assert_allclose(got[i], want[i], atol=1e-6)
    assert be._staging_pending == {}


# ------------------------------------------------- fan-out over 8 devices --
FANOUT_LENGTHS = [9, 30, 22, 15, 27, 12, 18, 31, 8, 25]


@pytest.fixture(scope="module")
def reference_fanout(tmp_path_factory):
    """The reference's 8-device probe (``tests/test_sharded_backend.py``):
    bge's smoke config on a forced 8-device host pool, in fp32, bf16 and
    int8, one subprocess; returns (param tree, {dtype: vectors})."""
    from tests.test_torch_mesh import run_forced

    out = tmp_path_factory.mktemp("fanout") / "fanout.npz"
    run_forced(8, f"""
        import numpy as np
        import jax
        from repro.configs import get_config
        from repro.core.routing import Query
        from repro.core.sharded_backend import ShardedEmbedderBackend
        from repro.models import embedder

        assert len(jax.devices()) == 8
        cfg = get_config("bge-large-zh-v1.5").smoke()
        params = embedder.init_embedder(jax.random.PRNGKey(0), cfg)
        qs = [Query(qid=i, length=n) for i, n in enumerate({FANOUT_LENGTHS})]
        arrays = {{}}
        for dtype in ("fp32", "bf16", "int8"):
            be = ShardedEmbedderBackend(cfg, params, max_tokens=32,
                                        dtype=dtype, min_seq_bucket=8)
            assert be.device_count == 8 and be.min_batch_bucket == 8
            arrays["vec:" + dtype] = np.stack(be.embed_batch(qs))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            arrays["param:" + "/".join(p.key for p in path)] = np.asarray(leaf)
        np.savez(r"{out}", **arrays)
    """, timeout=600)
    data = np.load(out)
    return (unflatten({k: data[k] for k in data.files}, "param:"),
            {k[4:]: data[k] for k in data.files if k.startswith("vec:")})


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_eight_device_fanout_matches_the_reference_probe(reference_fanout,
                                                         dtype):
    """The port's backend over ``[cpu] * 8``: 8 row blocks of every padded
    batch, each through its own forward, against the reference's 8-device
    mesh on the same weights and queries (fp32 within 1e-6, int8 within
    1e-5, bf16 within 1e-2 cosine distance, the port's bars against the
    JAX package), and bit for bit what the one-device backend serves."""
    tree, vecs = reference_fanout
    cfg = get_config("bge-large-zh-v1.5").smoke()
    qs = [Query(qid=i, length=n) for i, n in enumerate(FANOUT_LENGTHS)]
    be = ShardedEmbedderBackend(cfg, params_from_numpy(tree, "cpu"),
                                max_tokens=32, dtype=dtype,
                                devices=["cpu"] * 8, min_seq_bucket=8,
                                async_dispatch=True)
    assert be.device_count == 8 and be.min_batch_bucket == 8
    assert "@8dev" in be.name
    got = np.stack(be.embed_batch_async(qs)())
    want = vecs[dtype]
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype == "bf16":
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert 1.0 - cos.min() <= 1e-2
    else:
        np.testing.assert_allclose(got, want,
                                   atol=1e-6 if dtype == "fp32" else 1e-5)
    one = ShardedEmbedderBackend(cfg, params_from_numpy(tree, "cpu"),
                                 max_tokens=32, dtype=dtype, device="cpu",
                                 min_seq_bucket=8)
    np.testing.assert_array_equal(got, np.stack(one.embed_batch(qs)))


@pytest.mark.parametrize("n,fanout", [(1, 1), (2, 2), (3, 2), (6, 4), (8, 8)])
def test_pool_clamps_to_a_power_of_two_and_floors_the_batch(bge_smoke, n,
                                                            fanout):
    """The reference's ``_serve_devices``: the largest power of two of the
    pool; batch buckets floored at the fan-out, so a batch of 3 pads to it
    and every device gets rows (the staging ring counts it once)."""
    from repro_torch.core.sharded_backend import _serve_devices

    assert len(_serve_devices(["cpu"] * n)) == fanout
    cfg, params = bge_smoke
    be = ShardedEmbedderBackend(cfg, params, 32, dtype="fp32",
                                devices=["cpu"] * n, min_batch_bucket=1)
    assert be.device_count == fanout and be.min_batch_bucket == fanout
    assert all(c >= fanout and c % fanout == 0 for c in be._batch_plan(3))
    assert all(b >= fanout for b, _ in be.warm_grid(8))
    fetch = be.embed_batch_async(queries([10, 4, 7], vocab=cfg.vocab_size))
    # one staging a chunk, whatever the fan-out
    assert sum(be._staging_pending.values()) == len(be._batch_plan(3))
    assert len(fetch()) == 3 and not be._staging_pending
    with pytest.raises(ValueError, match="at least one"):
        _serve_devices([])


def test_prewarm_runs_every_device_once_per_bucket(bge_smoke):
    cfg, params = bge_smoke
    be = ShardedEmbedderBackend(cfg, params, 32, dtype="fp32",
                                devices=["cpu"] * 4)
    calls = []
    embed = be._embedder.embed

    def spy(p, *a, **kw):
        calls.append(a[1].shape)        # this position's tokens
        return embed(p, *a, **kw)

    be._embedder = type("E", (), {"embed": staticmethod(spy)})
    grid = be.warm_grid(max_batch=8)
    assert be.prewarm(grid) == len(grid) == be.traces
    assert len(calls) == 4 * len(grid)
    assert sorted(set(calls)) == sorted({(b // 4, s) for b, s in grid})
