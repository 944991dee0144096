"""The train step over a (data, model) mesh against the JAX reference on one
device, on the CPU: stablelm-1.6b, hymba-1.5b and whisper-tiny here,
internvl2-2b, granite-moe-3b-a800m and the MoE row dispatch in
``test_torch_tp_train_moe.py``.

The reference's fp32 train step (its ``layers.COMPUTE_DTYPE`` patched) and
``jax.value_and_grad`` of its loss run whole on one device: GSPMD does not
change what it computes, so one device stands for every mesh.  The port
places the same weights (``params_from_numpy``) over ``[cpu] * n``
positions by ``train_shardings`` and ``sharding.shard_tree`` and runs
``build_loss_fn`` / ``build_train_step`` on them in fp32 compute, fed the
reference's batch.  Held, as ``test_torch_train_families`` holds the
whole tree: loss, ce and moe_aux within 1e-5 relative, grad_norm within
1e-4, every gradient leaf (unsharded) within 1e-4 of its largest
magnitude.

Cases: meshes (1, 4), (2, 2), (4, 1) and (2, 4) at B 4; B 1 on (2, 2)
(the batch whole at every data position, its loss counted once); and on
(2, 2) a tree whose replicated slices are separate copies
(``Sharded.of`` from cloned blocks), where the explicit sum over the
copies (``sharding.sum_copies``) is what makes the gradients right: the
same check fails with the copies left unsummed or summed twice.  hymba
runs 6 heads on 2 KV heads and whisper 6 heads (a model axis of 4 cuts a
head, so the projections are gathered, as at full width).  Then AdamW's
moments and step on a placed tree against the whole tree's, the training
CLI over a mesh (checkpoint resume, the production mesh's refusal), and
the mesh step traced on eight meta positions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import perf_flags as jflags  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch.mesh import make_host_mesh, mesh_context  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.steps import optim as joptim  # noqa: E402
from repro.steps.inputs import make_batch as jmake_batch  # noqa: E402
from repro.steps.train import build_train_step as jbuild  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.embedder import params_from_numpy  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.roofline import op_cost  # noqa: E402
from repro_torch.steps import optim  # noqa: E402
from repro_torch.steps.checkpoint import _flatten  # noqa: E402
from repro_torch.steps.train import (build_loss_fn,  # noqa: E402
                                     build_train_step, train_shardings,
                                     value_and_grad)
from tests.test_torch_train_families import _flat, _ref_loss  # noqa: E402

S = 32
MESHES = ((1, 4), (2, 2), (4, 1), (2, 4))
# hymba's and whisper's heads cut over a model axis of 4, as at full width
OVERRIDES = {"hymba-1.5b": dict(num_heads=6, num_kv_heads=2),
             "whisper-tiny": dict(num_heads=6, num_kv_heads=6)}
ARCHS = ("stablelm-1.6b", "hymba-1.5b", "whisper-tiny")
# (mesh, batch): every mesh at B 4, and B 1 on (2, 2)
CASES = [(m, 4) for m in MESHES] + [((2, 2), 1)]


def case_id(case):
    (d, m), b = case
    return f"{d}x{m}-B{b}"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch):
    kw = OVERRIDES.get(arch, {})
    return (jax_get_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


def reference(arch, batch, row_dispatch=False):
    """The reference's fp32 step on one device: (numpy tree, numpy batch,
    the step's metrics, every gradient leaf by path)."""
    jc, _ = configs(arch)
    jshape = JShape("smoke", seq_len=S, global_batch=batch, kind="train")
    jparams = japi.init_params(jax.random.PRNGKey(3), jc)
    data = {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                          else v)
            for k, v in jmake_batch(jc, jshape,
                                    jax.random.PRNGKey(4)).items()}
    saved, flags = jL.COMPUTE_DTYPE, jflags.FLAGS
    jL.COMPUTE_DTYPE = jnp.float32
    jflags.FLAGS = jflags.PerfFlags(moe_row_dispatch=row_dispatch)
    try:
        mesh = make_host_mesh()
        jstep = jbuild(jc, jshape, mesh)
        jvg = jax.value_and_grad(_ref_loss(jc), has_aux=True)
        with mesh_context(mesh):
            jm, (_, jgrads) = jax.jit(
                lambda p, o, b: (jstep(p, o, b)[2], jvg(p, b)))(
                    jparams, joptim.init(jparams), data)
    finally:
        jL.COMPUTE_DTYPE, jflags.FLAGS = saved, flags
    return (jax.tree.map(np.asarray, jparams), data,
            {k: float(v) for k, v in jm.items()}, _flat(jgrads))


@pytest.fixture(scope="module")
def refs():
    out = {}

    def get(arch, batch, row_dispatch=False):
        key = (arch, batch, row_dispatch)
        if key not in out:
            out[key] = reference(arch, batch, row_dispatch)
        return out[key]

    return get


def cpu_mesh(d, m):
    return Mesh(["cpu"] * (d * m), (d, m), ("data", "model"))


def separate_copies(tree):
    """``tree`` with every position's block a clone of its own: a slice
    held by several positions is held as separate copies."""
    return optim.tree_map(lambda s: sharding.Sharded.of(
        s.mesh, s.spec, s.shape, [b.clone() for b in s.blocks]), tree)


def placed_tree(cfg, shape, mesh, np_params, copies=False):
    params = params_from_numpy(np_params, device="cpu")
    placed = sharding.shard_tree(
        params, train_shardings(cfg, shape, mesh, params)[0][0])
    return separate_copies(placed) if copies else placed


def whole(tree) -> dict:
    """A tree's leaves by path as numpy arrays, placed leaves unsharded
    (mamba's halved ``in_proj`` as its whole)."""
    out = {}
    for key, leaf in _flatten(tree):
        if isinstance(leaf, sharding.Sharded):
            t = sharding.unshard(leaf)
            leaf = t.flatten(-2) if key.split("/")[-1] in sharding.HALVED \
                else t
        out[key] = leaf.detach().numpy()
    return out


def worst_leaf(got: dict, want: dict):
    """(the largest error over a leaf's largest magnitude, its path)."""
    assert sorted(got) == sorted(want)
    return max((np.abs(got[k] - want[k]).max()
                / max(np.abs(want[k]).max(), 1e-30), k) for k in want)


def mesh_grads(arch, mesh_shape, ref, copies=False):
    """The port's loss and gradients on the case's mesh."""
    np_params, data, _, _ = ref
    _, tc = configs(arch)
    B = data["tokens"].shape[0]
    shape = ShapeConfig("smoke", S, B, "train")
    mesh = cpu_mesh(*mesh_shape)
    placed = placed_tree(tc, shape, mesh, np_params, copies)
    loss_fn = build_loss_fn(tc, shape, mesh, compute_dtype=torch.float32)
    (loss, (ce, aux)), grads = value_and_grad(loss_fn, placed, data)
    return tc, shape, mesh, placed, (loss, ce, aux), grads


def check_case(arch, mesh_shape, ref, copies=False):
    _, data, jm, jgrads = ref
    tc, shape, mesh, placed, metrics, grads = mesh_grads(arch, mesh_shape,
                                                         ref, copies)
    for name, got in zip(("loss", "ce", "moe_aux"), metrics):
        assert got.dim() == 0
        assert float(got) == pytest.approx(jm[name], rel=1e-5, abs=1e-7), \
            name
    if tc.is_moe:
        assert float(metrics[2]) > 0
    err, leaf = worst_leaf(whole(grads), jgrads)
    assert err <= 1e-4, f"{leaf}: {err} of its largest magnitude"

    step = build_train_step(tc, shape, mesh, compute_dtype=torch.float32)
    params, opt, m = step(placed, optim.init(placed), data)
    assert params is placed and sharding.is_placed(opt["m"])
    assert float(m["loss"]) == pytest.approx(jm["loss"], rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(jm["grad_norm"], rel=1e-4)
    assert int(opt["step"]) == 1


@pytest.mark.parametrize("case", CASES, ids=case_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_the_reference(arch, case, refs):
    mesh_shape, batch = case
    check_case(arch, mesh_shape, refs(arch, batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_separate_copies_of_a_slice_are_summed_once(arch, refs):
    check_case(arch, (2, 2), refs(arch, 4), copies=True)


def _unsummed(s, grad_of):
    return sharding.Sharded(s.mesh, s.spec, s.shape,
                            [grad_of(b) for b in s.blocks], list(s.index))


def _twice(s, grad_of):
    out = _right(s, grad_of)
    return sharding.Sharded(s.mesh, s.spec, s.shape,
                            [2 * b for b in out.blocks], list(s.index))


_right = sharding.sum_copies


@pytest.mark.parametrize("variant", ["unsummed", "twice"])
def test_the_copies_check_fails_a_wrong_reduction(variant, refs,
                                                  monkeypatch):
    """The separate-copies case above is what the reduction answers for:
    a copy's partial gradient left alone, or the sum counted twice, misses
    the bar on the replicated leaves."""
    arch = "stablelm-1.6b"
    ref = refs(arch, 4)
    monkeypatch.setattr(sharding, "sum_copies",
                        {"unsummed": _unsummed, "twice": _twice}[variant])
    grads = mesh_grads(arch, (2, 2), ref, copies=True)[-1]
    err, leaf = worst_leaf(whole(grads), ref[3])
    assert err > 1e-2, f"{variant}: {leaf} within {err}"


# ------------------------------------------------------------------ AdamW --
@pytest.mark.parametrize("copies", [False, True], ids=["shared", "copies"])
def test_update_on_a_placed_tree_matches_the_whole(copies):
    """m, v, step, grad_norm and the params after one ``optim.update`` on a
    tree placed over (2, 2), unsharded, against the update of the whole
    tree within 1e-6: each distinct block is updated once (a block shared
    by positions is not stepped twice), and copies of a slice stay equal."""
    _, tc = configs("hymba-1.5b")
    shape = ShapeConfig("smoke", S, 4, "train")
    mesh = cpu_mesh(2, 2)
    rng = np.random.default_rng(5)
    tree = optim.tree_map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), api.param_shapes(tc))
    gtree = optim.tree_map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), tree)
    params = params_from_numpy(tree, device="cpu")
    grads = params_from_numpy(gtree, device="cpu")
    psh = train_shardings(tc, shape, mesh, params)[0][0]
    placed = placed_tree(tc, shape, mesh, tree, copies)
    pgrads = sharding.shard_tree(params_from_numpy(gtree, device="cpu"), psh)
    opt_w, opt_p = optim.init(params), optim.init(placed)
    cfg = optim.AdamWConfig(lr=1e-2, grad_clip=1e9)
    for _ in range(2):
        _, opt_w, mw = optim.update(grads, opt_w, params, cfg)
        _, opt_p, mp = optim.update(pgrads, opt_p, placed, cfg)
    assert int(opt_p["step"]) == int(opt_w["step"]) == 2
    assert float(mp["grad_norm"]) == pytest.approx(float(mw["grad_norm"]),
                                                   rel=1e-6)
    for got, want in ((opt_p["m"], opt_w["m"]), (opt_p["v"], opt_w["v"]),
                      (placed, params)):
        err, leaf = worst_leaf(whole(got), whole(want))
        assert err <= 1e-6, f"{leaf}: {err}"
    if copies:
        for s in optim.tree_leaves(placed):
            for idx, blk in zip(s.index, s.blocks):
                first = s.blocks[s.index.index(idx)]
                assert torch.equal(blk, first)


# -------------------------------------------------------------------- CLI --
def test_the_cli_resumes_a_placed_state_exactly(tmp_path):
    """``launch.train.train`` over (2, 2) CPU positions: 2 steps, a
    checkpoint and 2 resumed steps equal 4 straight ones within 1e-6
    (losses and params, unsharded)."""
    ck = str(tmp_path / "ck.npz")
    kw = dict(batch=4, seq=32, smoke=True, seed=3, log_every=100,
              mesh=cpu_mesh(2, 2), arch="hymba-1.5b")
    p_full, o_full, l_full = train(steps=4, **kw)
    train(steps=2, ckpt=ck, **kw)
    p_res, o_res, l_res = train(steps=2, resume=ck, **kw)
    assert sharding.is_placed(p_res) and int(o_res["step"]) == 4
    assert l_res == pytest.approx(l_full[2:], rel=1e-6)
    err, leaf = worst_leaf(whole(p_res), whole(p_full))
    assert err <= 1e-6, f"{leaf}: {err}"
    err, leaf = worst_leaf(whole(o_res), whole(o_full))
    assert err <= 1e-6, f"{leaf}: {err}"


def test_the_cli_loss_falls_over_a_mesh():
    _, _, losses = train("stablelm-1.6b", steps=12, batch=4, seq=32,
                         smoke=True, lr=1e-3, log_every=100,
                         mesh=cpu_mesh(2, 2))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_the_production_mesh_needs_256_devices():
    with pytest.raises(ValueError, match="needs 256 device"):
        train("stablelm-1.6b", steps=1, batch=4, seq=32,
              production_mesh=True)


# ------------------------------------------------------------------ meta --
def meta_calls(arch, mesh_shape=(2, 4), batch=4):
    """The mesh train step's kernel calls on 8 meta positions."""
    _, tc = configs(arch)
    d, m = mesh_shape
    mesh = Mesh(["meta"] * (d * m), (d, m), ("data", "model"))
    shape = ShapeConfig("smoke", S, batch, "train")
    shapes = api.param_shapes(tc)
    placed = sharding.shard_tree(
        shapes, train_shardings(tc, shape, mesh, shapes)[0][0])
    data = {"tokens": torch.zeros((batch, S), dtype=torch.int32,
                                  device="meta"),
            "labels": torch.zeros((batch, S), dtype=torch.int32,
                                  device="meta")}
    if tc.cross_attention:
        data["frames"] = torch.zeros((batch, tc.num_frames, tc.d_model),
                                     device="meta")
    step = build_train_step(tc, shape, mesh)
    return tc, op_cost.analyse_step(step, placed, optim.init(placed), data)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_mesh_step_traces_on_meta_positions(arch):
    """Every position's kernel calls, forward (each layer twice: the step
    and its recompute) and backward: attention once a layer a position
    each way, rmsnorm twice a layer and once for the final norm (whisper:
    layernorm, no rmsnorm), hymba's scan once a layer; the encoder's
    attention (not rematerialised) once a layer a position each way."""
    tc, cost = meta_calls(arch)
    Lc, n = tc.num_layers, 8
    if tc.cross_attention:
        # the decoder's self and cross attention, twice each (remat), and
        # the encoder's once
        want = {"flash_attention": n * (4 * Lc + tc.encoder_layers),
                "flash_attention_bwd": n * (2 * Lc + tc.encoder_layers)}
    else:
        want = {"flash_attention": n * 2 * Lc,
                "flash_attention_bwd": n * Lc,
                "rmsnorm": n * (4 * Lc + 1),
                "rmsnorm_bwd": n * (2 * Lc + 1)}
    if tc.has_ssm:
        want.update(ssm_scan=n * 2 * Lc, ssm_scan_bwd=n * Lc)
    assert cost.kernel_calls == want
    assert cost.ops > 0 and cost.kernel_flops > 0
