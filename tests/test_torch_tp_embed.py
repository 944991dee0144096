"""The embedders served over a (data, model) mesh against the JAX reference
on one device, on the CPU.

bge-large-zh-v1.5 and jina-v2 at smoke size (2 layers, d_model 128, 4
query heads and 2 KV heads of 32, vocab 512) with the reference's own
weights carried over by ``params_from_numpy``; ragged queries from a
numpy seed.  The reference's ``embedder.embed`` runs whole on its
``serve_params`` tree; GSPMD does not change what it computes, so one
device stands for every mesh.  The port serves the same tree through
``ShardedEmbedderBackend(mesh=...)`` (serve-mode specs: ``wq``/``wk``/
``wv``/``w_in`` by columns, ``wo``/``w_out`` by rows, the vocab over
``model``, an int8 tree's ``_scale`` leaves whole), and through
``models.tp.embed`` on a tree placed by the train-mode rules (the
data-split leaves gathered at their use).

Held: fp32 (bge, jina) and bge int8 within 1e-5 max-abs; bge bf16 and
int8_w8a8 at cosine >= 0.999.  Under W8A8 the codes and scales that
each position's ``wo`` of layer 0 multiplies equal the reference's
quantization of the whole row, which a position quantizing its own block
against its own absmax would miss.  Then ``tp.embed`` traced on eight meta
positions reports each position's kernel calls.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.quant_matmul.quant_matmul import \
    quantize_activations as jax_quantize  # noqa: E402
from repro.models import embedder as jemb  # noqa: E402
from repro.models import quantize as jq  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.routing import Query  # noqa: E402
from repro_torch.core.sharded_backend import \
    ShardedEmbedderBackend  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import api, embedder, tp  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import quantize as Q  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.roofline import kernel_cost, op_cost  # noqa: E402

MESHES = [(1, 4), (2, 2), (4, 1), (2, 4)]
LENGTHS = [24, 11, 1, 17, 5, 20, 9, 13]
S = 24
# (arch, policy, bar): max-abs for the float and int8 paths, else cosine
POLICIES = [("bge-large-zh-v1.5", "fp32", "abs"),
            ("jina-v2", "fp32", "abs"),
            ("bge-large-zh-v1.5", "int8", "abs"),
            ("bge-large-zh-v1.5", "bf16", "cos"),
            ("bge-large-zh-v1.5", "int8_w8a8", "cos")]
ABS, COS = 1e-5, 0.999


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape):
    return Mesh(["cpu"] * (shape[0] * shape[1]), shape, ("data", "model"))


def case_id(x):
    return "x".join(map(str, x)) if isinstance(x, tuple) else str(x)


@pytest.fixture(scope="module")
def refs():
    """Per (arch, policy): (port cfg, numpy tree, tokens, mask, the
    reference's vectors)."""
    out = {}

    def get(arch, policy):
        if (arch, policy) in out:
            return out[(arch, policy)]
        jc, tc = jax_get_config(arch).smoke(), get_config(arch).smoke()
        tree = jax.tree.map(np.asarray,
                            jemb.init_embedder(jax.random.PRNGKey(5), jc))
        rng = np.random.default_rng(6)
        toks = rng.integers(1, tc.vocab_size, (len(LENGTHS), S)
                            ).astype(np.int32)
        mask = (np.arange(S)[None] < np.array(LENGTHS)[:, None]
                ).astype(np.float32)
        served, cdt = jq.serve_params(jax.tree.map(jnp.asarray, tree), policy)
        want = np.asarray(jemb.embed(served, jc, jnp.asarray(toks),
                                     jnp.asarray(mask), compute_dtype=cdt,
                                     act_quant=jq.wants_act_quant(policy)))
        out[(arch, policy)] = (tc, tree, toks, mask, want)
        return out[(arch, policy)]

    return get


def held(got, want, bar):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-3)
    if bar == "abs":
        assert np.abs(got - want).max() <= ABS
    else:
        assert (got * want).sum(-1).min() >= COS


def queries(toks, mask):
    return [Query(qid=i, payload=t[:int(m.sum())], length=int(m.sum()))
            for i, (t, m) in enumerate(zip(toks, mask))]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=case_id)
@pytest.mark.parametrize("arch,policy,bar", POLICIES)
def test_backend_on_a_mesh_matches_the_reference(arch, policy, bar,
                                                 mesh_shape, refs):
    """The WindVE serving path: the backend's buckets, staging and fetch
    over the mesh, fed the ragged queries."""
    tc, tree, toks, mask, want = refs(arch, policy)
    be = ShardedEmbedderBackend(
        tc, embedder.params_from_numpy(tree, "cpu"), max_tokens=S,
        dtype=policy, mesh=cpu_mesh(mesh_shape))
    assert be.device_count == mesh_shape[0]
    assert be.tensor_parallel == (mesh_shape[1] > 1)
    assert be.min_batch_bucket >= mesh_shape[0]
    held(np.stack(be.embed_batch(queries(toks, mask))), want, bar)


def place(tree, mesh, mode):
    if mode == "serve":
        return sharding.shard_tree(
            tree, sharding.serve_embed_shardings(mesh, tree)[0])
    return sharding.shard_tree(tree, sharding.param_shardings(mesh, tree,
                                                              mode))


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("arch,policy,bar", POLICIES)
def test_tp_embed_matches_the_reference(arch, policy, bar, mode, refs):
    """``tp.embed`` on (2, 2) under the serve-mode rules and the
    train-mode ones (wq/wk/wv/w_in rows and wo/w_out columns over data too,
    gathered at their use), fed whole tensors."""
    tc, tree, toks, mask, want = refs(arch, policy)
    served, cdt = Q.serve_params(embedder.params_from_numpy(tree, "cpu"),
                                 policy)
    mesh = cpu_mesh((2, 2))
    placed = place(served, mesh, mode)
    if mode == "train":
        assert placed["blocks"]["attn"]["wq"].spec == (None, "data", "model")
    got = tp.embed(placed, tc, torch.from_numpy(toks),
                   torch.from_numpy(mask), mesh, compute_dtype=cdt,
                   act_quant=Q.wants_act_quant(policy))
    held(got.numpy(), want, bar)


def test_int8_scales_stay_whole_and_are_cut_at_use(refs):
    """An int8 tree's ``_scale`` leaves are placed whole (no rule names
    them); each position reads the columns of its weight block."""
    tc, tree, _, _, _ = refs("bge-large-zh-v1.5", "int8")
    served, _ = Q.serve_params(embedder.params_from_numpy(tree, "cpu"),
                               "int8")
    mesh = cpu_mesh((2, 4))
    placed = place(served, mesh, "serve")
    attn, ffn = placed["blocks"]["attn"], placed["blocks"]["ffn"]
    for leaf in (attn["wq_scale"], attn["wo_scale"], ffn["w_in_scale"]):
        assert all(s is None for s in leaf.spec)
    assert attn["wq"].spec == (None, None, "model")
    assert attn["wo"].spec == (None, "model", None)
    run = tp.Run(tc, mesh, placed, 8)
    lp = run.layer(0)
    whole = served["blocks"]["attn"]["wq_scale"][0]
    n = whole.shape[0] // 4
    for p, layer in enumerate(lp):
        m = run.mi[p]
        assert torch.equal(layer["attn"]["wq_scale"], whole[m * n:(m + 1) * n])
        assert torch.equal(layer["attn"]["wo_scale"],
                           served["blocks"]["attn"]["wo_scale"][0])


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)], ids=case_id)
def test_w8a8_row_split_quantizes_the_whole_row(mesh_shape, refs):
    """Layer 0's ``wo``: each position multiplies its columns of the codes
    of the whole row (its heads' attention output beside the other
    positions'), with the whole row's scale, as the reference quantizes
    it."""
    tc, tree, toks, mask, _ = refs("bge-large-zh-v1.5", "int8_w8a8")
    served, cdt = Q.serve_params(embedder.params_from_numpy(tree, "cpu"),
                                 "int8_w8a8")
    mesh = cpu_mesh(mesh_shape)
    placed = place(served, mesh, "serve")
    events = []
    saved = L.flash_attention, L.w8a8_matmul

    def fa(*a, **kw):
        out = saved[0](*a, **kw)
        events.append(("fa", out))
        return out

    def w8(x8, w, xs, ws, **kw):
        events.append(("w8", x8, xs, w))
        return saved[1](x8, w, xs, ws, **kw)

    L.flash_attention, L.w8a8_matmul = fa, w8
    try:
        tp.embed(placed, tc, torch.from_numpy(toks), torch.from_numpy(mask),
                 mesh, compute_dtype=cdt, act_quant=True)
    finally:
        L.flash_attention, L.w8a8_matmul = saved
    n = mesh.size
    first = [i for i, e in enumerate(events) if e[0] == "fa"][:n]
    outs = [events[i][1] for i in first]
    wo = [e for e in events[first[-1] + 1:] if e[0] == "w8"][:n]
    hd = tc.resolved_head_dim
    k = tc.num_heads * hd // mesh_shape[1]
    for g in C.groups(mesh, ("model",)):
        # (b, Hl, S, hd) -> (b, S, Hl * hd): the position's heads of the row
        blocks = [outs[p].transpose(1, 2).flatten(2) for p in g]
        whole = torch.cat(blocks, -1)
        assert whole.shape[-1] == tc.num_heads * hd
        want8, want_s = jax_quantize(jnp.asarray(whole.numpy()))
        want8, want_s = np.asarray(want8), np.asarray(want_s)
        for j, p in enumerate(g):
            _, x8, xs, w = wo[p]
            assert w.shape == (k, tc.d_model)
            np.testing.assert_array_equal(x8.numpy(),
                                          want8[..., j * k:(j + 1) * k])
            np.testing.assert_array_equal(xs.numpy(), want_s)


@pytest.mark.parametrize("policy", ["fp32", "int8", "int8_w8a8"])
@pytest.mark.parametrize("arch", ["bge-large-zh-v1.5", "jina-v2"])
def test_tp_embed_traces_on_meta_positions(arch, policy):
    """Every position's kernel calls on (2, 4) meta positions: attention
    once a layer on its heads, pool_norm once on its data group's rows; an
    int8 tree's six projections a layer through quant_matmul, or under
    W8A8 through w8a8_matmul after four quantize_rows (q, k and v share
    one; wo and w_out each quantize the gathered row)."""
    cfg = get_config(arch).smoke()
    mesh = Mesh(["meta"] * 8, (2, 4), ("data", "model"))
    tree, cdt = Q.serve_params(api.param_shapes(cfg, torch.float32), policy)
    placed = place(tree, mesh, "serve")
    toks = torch.zeros((8, S), dtype=torch.int32, device="meta")
    mask = torch.ones((8, S), dtype=torch.float32, device="meta")
    got = op_cost.analyse_step(tp.embed, placed, cfg, toks, mask, mesh,
                               compute_dtype=cdt,
                               act_quant=Q.wants_act_quant(policy))
    Lc, n = cfg.num_layers, 8
    want = {"flash_attention": n * Lc, "pool_norm": n}
    if policy == "int8":
        want["quant_matmul"] = 6 * n * Lc
    if policy == "int8_w8a8":
        want.update(quantize_rows=4 * n * Lc, w8a8_matmul=6 * n * Lc)
    assert got.kernel_calls == want
    assert got.kernel_flops > 0


def test_the_whole_and_the_mesh_cost_the_same_attention():
    """The attention's and the projections' flops over the 8 positions
    equal the whole forward's (the heads and the weight blocks split the
    work); pool_norm's are M times (each of a group's M positions pools
    the replicated hidden state)."""
    cfg = get_config("bge-large-zh-v1.5").smoke()
    mesh = Mesh(["meta"] * 8, (2, 4), ("data", "model"))
    tree, cdt = Q.serve_params(api.param_shapes(cfg, torch.float32), "int8")
    placed = place(tree, mesh, "serve")
    toks = torch.zeros((8, S), dtype=torch.int32, device="meta")
    mask = torch.ones((8, S), dtype=torch.float32, device="meta")

    def flops(fn, *a, **kw):
        acc = {}

        def sink(name, f, _b):
            acc[name] = acc.get(name, 0.0) + f

        kernel_cost.listen(sink)
        try:
            fn(*a, **kw)
        finally:
            kernel_cost.unlisten(sink)
        return acc

    mesh_f = flops(tp.embed, placed, cfg, toks, mask, mesh,
                   compute_dtype=cdt)
    whole_f = flops(embedder.embed, tree, cfg, toks, mask,
                    compute_dtype=cdt)
    assert mesh_f["flash_attention"] == pytest.approx(
        whole_f["flash_attention"], rel=1e-12)
    assert mesh_f["quant_matmul"] == pytest.approx(whole_f["quant_matmul"],
                                                   rel=1e-12)
    assert mesh_f["pool_norm"] == pytest.approx(4 * whole_f["pool_norm"],
                                                rel=1e-12)


def test_the_tp_embed_part_rehearses_on_the_cpu():
    """``chip_smoke.mesh_tp_embed`` at smoke size on 8 CPU positions: every
    (model, policy) held at the card's bars, bge fp32 through the WindVE
    engine too, the split kernels' flops over the positions equal to the
    whole run's and pool_norm's M times, and the meta trace's calls of
    every counted forward reported (the plain versions count no
    launches)."""
    from tests.test_torch_tp_serve_moe import _chip_smoke

    cs = _chip_smoke()
    dev = torch.device("cpu")
    out, counts = cs.mesh_tp_embed(dev, cs.mesh_devices(dev, 8))
    cases = out["cases"]
    assert [(c["model"].replace("-smoke", ""), c["policy"])
            for c in cases] == list(cs.TP_EMBED)
    for case in cases:
        assert case["held"] and case["device_count"] == 2
        assert case["forwards"] >= 2
        for k in cs.TP_EMBED_SPLIT:
            if k in case["flops_over_whole"]:
                assert case["flops_over_whole"][k] == 1.0
        assert case["flops_over_whole"]["pool_norm"] == 4.0
        calls = case["meta_kernel_calls"]
        assert calls["flash_attention"] == 8 * 2 * case["forwards"]
        assert (calls["quant_matmul"] > 0) == (case["policy"] == "int8")
        assert (calls["w8a8_matmul"] > 0) == (case["policy"] == "int8_w8a8")
    assert cases[0]["engine"]["held"]
    assert set(counts) >= set(cs.TP_EMBED_KERNELS)
