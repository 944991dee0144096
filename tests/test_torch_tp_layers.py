"""The layers on a (data, model) mesh's positions (``models/tp.py``) against
the JAX package's layer functions and the port's own whole ones, on the CPU.

Each layer's weights come from the reference's initialisers
(``params_from_numpy``), stacked as one layer and placed over a mesh of
``[cpu] * n`` positions by ``param_shardings``; ``tp.Run`` runs every
position on its blocks with the explicit collectives of
``parallel/collectives.py``.  Inputs are numpy draws from a seed.  The
comparisons are fp32 and held within 1e-5 of the largest magnitude: the
partial sums over ``model`` add in another order than one product.

Meshes (1, 4), (2, 2), (4, 1) and (2, 4): the smoke configs' 2 KV heads of
32 cut a head on a 4-wide model axis, and a 6-head config cuts query heads
(48 columns a position), as hymba-1.5b's 25 heads do on 4.  The MoE block
runs with its experts over ``model`` and, on a model axis of 8 (4
experts), with its FFN dims there instead; the global dispatch on a batch
split over ``data`` whose capacity binds equals the whole, where a
dispatch a data shard does not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import tp  # noqa: E402
from repro_torch.models.embedder import params_from_numpy  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

MESHES = [(1, 4), (2, 2), (4, 1), (2, 4)]
REL = 1e-5
B, S = 4, 12


def mesh_id(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_mesh(shape):
    return Mesh(["cpu"] * (shape[0] * shape[1]), shape, ("data", "model"))


def configs(arch, **kw):
    return (jax_get_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


def run_for(cfg, mesh, blocks, top=None, batch=B, mode="serve"):
    """A ``tp.Run`` over ``mesh`` for a tree of one layer's ``blocks`` (numpy,
    unstacked) and top-level leaves ``top``, placed under ``mode``'s
    rules."""
    tree = {"blocks": jax.tree.map(lambda a: np.asarray(a)[None], blocks)}
    tree.update(top or {})
    tree = params_from_numpy(tree, device="cpu")
    placed = sharding.shard_tree(tree, sharding.param_shardings(mesh, tree,
                                                                mode))
    return tp.Run(cfg, mesh, placed, batch)


def whole_rows(run, ys, dim=0):
    """The whole batch from each position's rows (a model group's copies
    checked equal to its first)."""
    firsts = {}
    for p, y in enumerate(ys):
        key = run.di[p]
        if key in firsts:
            torch.testing.assert_close(y, firsts[key], rtol=0, atol=0)
        else:
            firsts[key] = y
    parts = [firsts[k] for k in sorted(firsts)]
    return torch.cat(parts, dim) if run.b_split else parts[0]


def assert_rel(got, want, rel=REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, mag = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * mag, f"max err {err} > {rel} x {mag}"


def rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ------------------------------------------------------------ collectives --
def test_collectives_sum_max_and_gather_in_position_order():
    mesh = make_mesh((2, 4))
    xs = [torch.full((2,), float(p)) + torch.arange(2.0) for p in range(8)]
    sums = C.all_reduce_sum(xs, mesh, ("model",))
    assert torch.equal(sums[1], torch.tensor([6.0, 10.0]))
    assert torch.equal(sums[5], torch.tensor([22.0, 26.0]))
    assert sums[0] is sums[3]                    # one device: one result
    maxes = C.all_reduce_max(xs, mesh, ("data",))
    assert torch.equal(maxes[2], torch.tensor([6.0, 7.0]))
    got = C.all_gather(xs, mesh, ("data", "model"), 0)
    assert torch.equal(got[7], torch.cat(xs))
    assert C.groups(mesh, ("data",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert C.coords(mesh, 6) == {"data": 1, "model": 2}
    assert C.axis_index(mesh, 6, ("data", "model")) == 6
    with pytest.raises(ValueError, match="8 positions"):
        C.all_reduce_sum(xs[:4], mesh, ("model",))


def test_a_sum_is_repeatable_bit_for_bit():
    mesh = make_mesh((1, 8))
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
          for _ in range(8)]
    a = C.all_reduce_sum(xs, mesh, ("model",))[0]
    b = C.all_reduce_sum(xs, mesh, ("model",))[5]
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    assert torch.equal(a, b) and torch.equal(a, acc)


# -------------------------------------------------------------- placement --
def test_shard_tree_places_leaf_by_leaf_freeing_each_whole_leaf():
    cfg = get_config("hymba-1.5b").smoke()
    mesh = make_mesh((2, 4))
    tree = {"blocks": {"mamba": L.init_mamba(
        torch.Generator().manual_seed(0), cfg, (2,), torch.float32, "cpu")}}
    want = {k: v.clone() for k, v in tree["blocks"]["mamba"].items()}
    psh = sharding.param_shardings(mesh, tree, "serve")
    placed = sharding.shard_tree(tree, psh, free=True)
    assert tree == {"blocks": {"mamba": {}}}          # every leaf let go
    assert sharding.is_placed(placed) and not sharding.is_placed(want)
    got = placed["blocks"]["mamba"]
    DI = cfg.d_inner
    # in_proj: each position holds its 64 channels of x and of z
    assert got["in_proj"].shape == (2, cfg.d_model, 2, DI)
    blk = got["in_proj"].blocks[5].flatten(-2)       # model coordinate 1
    torch.testing.assert_close(
        blk, torch.cat([want["in_proj"][..., 64:128],
                        want["in_proj"][..., DI + 64:DI + 128]], -1),
        rtol=0, atol=0)
    for name, t in got.items():
        whole = sharding.unshard(t)
        torch.testing.assert_close(whole.reshape(want[name].shape),
                                   want[name], rtol=0, atol=0)


def test_shard_places_meta_tensors_and_layouts_from_blocks():
    mesh = Mesh(["meta"] * 8, (2, 4), ("data", "model"))
    t = torch.empty((3, 16, 8), device="meta")
    s = sharding.shard(t, (None, "model", "data"), mesh)
    assert all(b.device.type == "meta" and b.shape == (3, 4, 4)
               for b in s.blocks)
    again = sharding.Sharded.of(mesh, s.spec, s.shape, s.blocks)
    assert again.index == s.index


# -------------------------------------------------------------- attention --
ATTN = {"qwen2": {}, "cut": {"num_heads": 6}}


def attn_params(jc, seed=0):
    p = jax.tree.map(np.asarray, jL.init_attention(jax.random.PRNGKey(seed),
                                                   jc, jnp.float32))
    rng = np.random.default_rng(seed + 1)
    for name in ("bq", "bk", "bv"):
        if name in p:
            p[name] = (0.1 * rng.standard_normal(p[name].shape)
                       ).astype(np.float32)
    return p


@pytest.mark.parametrize("kind", sorted(ATTN))
@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_attention_prefill_on_the_mesh(shape, kind):
    jc, tc = configs("qwen2-72b", **ATTN[kind])
    p = attn_params(jc)
    x = rand(3, B, S, tc.d_model)
    pos = np.arange(S, dtype=np.int32)
    want = np.asarray(jL.attn_forward(jax.tree.map(jnp.asarray, p), jc,
                                      jnp.asarray(x), jnp.asarray(pos)))
    own = L.attn_forward(params_from_numpy(p, "cpu"), tc,
                         torch.from_numpy(x), torch.from_numpy(pos))
    mesh = make_mesh(shape)
    run = run_for(tc, mesh, {"attn": p})
    ps = [lp["attn"] for lp in run.layer(0)]
    ys, ks, _ = run.attn_prefill(ps, run.split_rows(torch.from_numpy(x)),
                                 [torch.from_numpy(pos)] * run.n)
    got = whole_rows(run, ys)
    assert_rel(got, want)
    assert_rel(got, own.numpy())
    heads = ks[0].shape[2]
    assert heads == (1 if shape[1] == 2 else 2)      # 2 KV heads over model
    assert run.q_heads == (tc.num_heads % shape[1] == 0)


@pytest.mark.parametrize("seq", [False, True], ids=["heads", "seq"])
@pytest.mark.parametrize("kind", sorted(ATTN))
@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_attention_decode_on_the_mesh(shape, kind, seq):
    """One token against a 16-slot cache holding 9 positions, its blocks
    laid out by heads or, as under decode_shard_map, by sequence."""
    jc, tc = configs("qwen2-72b", **ATTN[kind])
    p = attn_params(jc, 4)
    Sc, pos, KV, hd = 16, 9, tc.num_kv_heads, tc.resolved_head_dim
    x1 = rand(5, B, 1, tc.d_model)
    ck, cv = rand(6, B, Sc, KV, hd), rand(7, B, Sc, KV, hd)
    kpos = np.full(Sc, -1, np.int32)
    kpos[:pos + 1] = np.arange(pos + 1)
    want, wk, wv, _ = jL.attn_decode(
        jax.tree.map(jnp.asarray, p), jc, jnp.asarray(x1), jnp.int32(pos),
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kpos))
    mesh = make_mesh(shape)
    run = run_for(tc, mesh, {"attn": p})
    ps = [lp["attn"] for lp in run.layer(0)]
    xs = run.split_rows(torch.from_numpy(x1))
    if seq:
        axes = run.seq_axes()
        spec = (run.b_spec, axes if len(axes) > 1 else axes[0], None, None)
        kspec = (spec[1],)
    else:
        spec = (run.b_spec, None, "model" if run.kv_heads else None, None)
        kspec = ()
    kb, vb = (sharding.shard(torch.from_numpy(t.copy()), spec, mesh)
              for t in (ck, cv))
    kp = sharding.shard(torch.from_numpy(kpos), kspec, mesh)
    if seq:
        ys = run.attn_decode_seq(ps, xs, pos, kb.blocks, vb.blocks,
                                 kp.blocks, axes)
    else:
        ys = run.attn_decode(ps, xs, pos, kb.blocks, vb.blocks, kp.blocks)
    assert_rel(whole_rows(run, ys), np.asarray(want))
    assert_rel(sharding.unshard(kb).numpy(), np.asarray(wk))
    assert_rel(sharding.unshard(vb).numpy(), np.asarray(wv))


# ---------------------------------------------------------------- the MLP --
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "starcoder2-7b"],
                         ids=["silu", "gelu"])
@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_mlp_on_the_mesh(shape, arch):
    jc, tc = configs(arch)
    key = jax.random.PRNGKey(1)
    p = jax.tree.map(np.asarray, jL.init_mlp(key, jc, jnp.float32))
    norm = jax.tree.map(np.asarray, jL.init_norm(jc, jnp.float32))
    h = rand(2, B, S, tc.d_model)
    jn = jax.tree.map(jnp.asarray, norm)
    want = h + np.asarray(jL.apply_mlp(jax.tree.map(jnp.asarray, p), jc,
                                       jL.apply_norm(jn, jc, jnp.asarray(h))))
    run = run_for(tc, make_mesh(shape), {"ffn": p, "norm2": norm})
    got = whole_rows(run, run.ffn(run.layer(0),
                                  run.split_rows(torch.from_numpy(h))))
    assert_rel(got, want)


def test_a_train_mode_tree_gathers_its_data_blocks_at_use():
    """serve_tp_only off: the train-mode rules split d_model over data
    (FSDP); each layer gathers its weights over data and drops them."""
    jc, tc = configs("qwen2-72b")
    p = attn_params(jc, 2)
    mesh = make_mesh((2, 2))
    run = run_for(tc, mesh, {"attn": p}, mode="train")
    assert run.specs[("blocks", "attn", "wq")] == (None, "data", "model")
    assert run.local[0]["blocks"]["attn"]["wq"].shape[1] == tc.d_model // 2
    lp = run.layer(0)
    assert lp[0]["attn"]["wq"].shape[0] == tc.d_model
    x = rand(3, B, S, tc.d_model)
    pos = np.arange(S, dtype=np.int32)
    want = np.asarray(jL.attn_forward(jax.tree.map(jnp.asarray, p), jc,
                                      jnp.asarray(x), jnp.asarray(pos)))
    ys, _, _ = run.attn_prefill([q["attn"] for q in lp],
                                run.split_rows(torch.from_numpy(x)),
                                [torch.from_numpy(pos)] * run.n)
    assert_rel(whole_rows(run, ys), want)


# -------------------------------------------------------------------- MoE --
MOE_MESHES = MESHES + [(1, 8)]


def moe_case(jc, seed=0):
    p = jax.tree.map(np.asarray, jL.init_moe(jax.random.PRNGKey(seed), jc,
                                              jnp.float32))
    norm = jax.tree.map(np.asarray, jL.init_norm(jc, jnp.float32))
    h = rand(seed + 9, B, S, jc.d_model)
    jn = jax.tree.map(jnp.asarray, norm)
    with jax.disable_jit():
        y, _ = jL.apply_moe(jax.tree.map(jnp.asarray, p), jc,
                            jL.apply_norm(jn, jc, jnp.asarray(h)))
    return p, norm, h, h + np.asarray(y)


@pytest.mark.parametrize("row", [False, True], ids=["global", "row"])
@pytest.mark.parametrize("shape", MOE_MESHES, ids=mesh_id)
def test_moe_on_the_mesh(shape, row):
    """Experts over model where 4 divides it; on 8 the FFN dims."""
    jc, tc = configs("granite-moe-3b-a800m")
    p, norm, h, _ = moe_case(jc)
    jn = jax.tree.map(jnp.asarray, norm)
    perf_flags.set_flags(moe_row_dispatch=row)
    try:
        fn = jL._apply_moe_row if row else jL.apply_moe
        with jax.disable_jit():
            y, _ = fn(jax.tree.map(jnp.asarray, p), jc,
                      jL.apply_norm(jn, jc, jnp.asarray(h)))
        run = run_for(tc, make_mesh(shape), {"ffn": p, "norm2": norm})
        got = whole_rows(run, run.ffn(run.layer(0),
                                      run.split_rows(torch.from_numpy(h))))
    finally:
        perf_flags.reset_flags()
    assert_rel(got, h + np.asarray(y))
    experts = run.split(("blocks", "ffn", "w_gate"), 1)
    assert experts == (shape[1] != 8)
    assert run.split(("blocks", "ffn", "w_down"), 2) == (shape[1] == 8)


def test_the_global_dispatch_counts_capacity_over_the_whole_batch():
    """Capacity factor 0.5 drops assignments; the batch split over data
    gathers the router's inputs first, so the mesh equals the whole (and
    the reference); a dispatch a data shard would drop others."""
    jc, tc = configs("granite-moe-3b-a800m", capacity_factor=0.5)
    p, norm, h, want = moe_case(jc, 3)
    tp_ = params_from_numpy({"ffn": p, "norm2": norm}, "cpu")
    x = L.apply_norm(tp_["norm2"], tc, torch.from_numpy(h))
    keeps = []
    slots = L.moe_slots
    L.moe_slots = lambda *a: keeps.append(slots(*a)[1]) or slots(*a)
    try:
        own = L.apply_moe(tp_["ffn"], tc, x)[0]
    finally:
        L.moe_slots = slots
    assert not keeps[0].all()                       # capacity binds
    per_shard = torch.cat([L.apply_moe(tp_["ffn"], tc, x[i:i + 2])[0]
                           for i in (0, 2)])
    assert (per_shard - own).abs().max() > 1e-3     # other drops
    run = run_for(tc, make_mesh((2, 2)), {"ffn": p, "norm2": norm})
    got = whole_rows(run, run.ffn(run.layer(0),
                                  run.split_rows(torch.from_numpy(h))))
    assert_rel(got, want)
    assert_rel(got, (torch.from_numpy(h) + own).numpy())


# ------------------------------------------------------------------ mamba --
def mamba_params(jc):
    return jax.tree.map(np.asarray, jL.init_mamba(jax.random.PRNGKey(5), jc,
                                                  jnp.float32))


def whole_states(run, sts, dim):
    """A state from every position's (rows, channels) block."""
    by_data = {}
    for p in range(run.n):
        by_data.setdefault(run.di[p], {})[run.mi[p]] = sts[p]
    rows = []
    for d in sorted(by_data):
        parts = by_data[d]
        if sts[0].shape[dim] == run.cfg.d_inner:
            rows.append(parts[0])
        else:
            rows.append(torch.cat([parts[m] for m in sorted(parts)], dim))
    return torch.cat(rows, 0) if run.b_split else rows[0]


@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_mamba_prefill_and_decode_on_the_mesh(shape):
    jc, tc = configs("hymba-1.5b")
    p = mamba_params(jc)
    jp = jax.tree.map(jnp.asarray, p)
    x = rand(11, B, S, tc.d_model)
    wy, wh, wc = jL.mamba_prefill(jp, jc, jnp.asarray(x))
    run = run_for(tc, make_mesh(shape), {"mamba": p})
    ps = [lp["mamba"] for lp in run.layer(0)]
    ys, hs, cs = run.mamba_prefill(ps, run.split_rows(torch.from_numpy(x)))
    assert run._mamba_split()
    assert_rel(whole_rows(run, ys), np.asarray(wy))
    assert_rel(whole_states(run, hs, 1), np.asarray(wh))
    assert_rel(whole_states(run, cs, 2), np.asarray(wc))
    x1 = rand(12, B, 1, tc.d_model)
    dy, dh, dc = jL.mamba_decode(jp, jc, jnp.asarray(x1), wh, wc)
    ys, hs2, cs2 = run.mamba_decode(ps, run.split_rows(torch.from_numpy(x1)),
                                    hs, cs)
    assert_rel(whole_rows(run, ys), np.asarray(dy))
    assert_rel(whole_states(run, hs2, 1), np.asarray(dh))
    assert_rel(whole_states(run, cs2, 2), np.asarray(dc))


# ----------------------------------------------------- embedding and head --
HEADS = {"untied": {}, "tied": {"tie_embeddings": True},
         "vocab-510": {"vocab_size": 510}}


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_embed_and_unembed_on_the_mesh(shape, head, monkeypatch):
    """The vocab rows (and head columns) over model: a token outside a
    position's rows adds zeros; the logits are gathered.  510 does not
    split over 4: the table is whole at every position."""
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    jc, tc = configs("qwen2-72b", **HEADS[head])
    V, D = tc.vocab_size, tc.d_model
    top = {"embed": rand(1, V, D, scale=0.02),
           "final_norm": jax.tree.map(np.asarray,
                                      jL.init_norm(jc, jnp.float32))}
    top["final_norm"]["scale"] = 1 + rand(2, D, scale=0.1)
    if not tc.tie_embeddings:
        top["lm_head"] = rand(3, D, V, scale=D ** -0.5)
    toks = np.random.default_rng(4).integers(0, V, (B, S)).astype(np.int32)
    jt = jax.tree.map(jnp.asarray, top)
    wh, _ = jlm._embed(jt, jc, jnp.asarray(toks), None)
    want = np.asarray(jlm._unembed(jt, jc, wh))
    run = run_for(tc, make_mesh(shape), {"norm1": {"scale": np.ones(D)}},
                  top)
    hs, _ = run.embed(run.split_rows(torch.from_numpy(toks)), 0,
                      torch.float32)
    np.testing.assert_array_equal(whole_rows(run, hs).numpy(),
                                  np.asarray(wh))
    assert_rel(run.unembed(hs), want)
    assert run.split(("embed",), 0) == (V % shape[1] == 0)
