"""The port's training path on the CPU: the reference's train step, AdamW,
the chunked loss, remat policies, input specs and shardings, and the
training CLI (``repro_torch.launch.train``), each against the reference on
the same inputs where the reference has a counterpart.

- The mamba families (hymba-1.5b, falcon-mamba-7b) under ``mamba_chunk``
  0 and 16: one train step against the reference's
  (``tests/test_torch_train_families.check_train_step``).
- AdamW: three ``optim.update`` steps on the same numpy gradients, port
  against reference within 1e-6.
- The CLI, the port's mirrors of ``tests/test_train_loop.py``: the loss
  falls over 12 steps (``device="cpu"``), resuming from a checkpoint is
  exact, and ``checkpoint.load`` checks shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_MODULES as JAX_ARCHS  # noqa: E402
from repro.configs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro.steps import inputs as jinputs  # noqa: E402
from repro.steps import optim as joptim  # noqa: E402
from repro.steps.train import chunked_ce as jchunked_ce  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import api, layers as L  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.steps import checkpoint, inputs, optim  # noqa: E402
from repro_torch.steps.train import (build_loss_fn,  # noqa: E402
                                     build_train_step, chunked_ce,
                                     train_shardings, value_and_grad)
from tests.test_sharding import FakeMesh  # noqa: E402
from tests.test_torch_train_families import check_train_step  # noqa: E402

SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "falcon-mamba-7b"])
@pytest.mark.parametrize("chunk", [0, 16])
def test_mamba_train_step_matches_the_reference(arch, chunk, monkeypatch):
    check_train_step(arch, chunk, monkeypatch)


# ------------------------------------------------------------------ AdamW --
def _np_tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": rng.standard_normal((2, 2, 3)).astype(np.float32)}}


@pytest.mark.parametrize("grad_scale", [0.1, 10.0])   # unclipped, clipped
def test_adamw_matches_the_reference(grad_scale):
    rng = np.random.default_rng(0)
    p0 = _np_tree(rng)
    grads = [optim.tree_map(lambda g: g * grad_scale, _np_tree(rng))
             for _ in range(3)]
    cfg = optim.AdamWConfig(lr=1e-2)
    jp, jo = jax.tree.map(jnp.asarray, p0), joptim.init(p0)
    tp = optim.tree_map(torch.from_numpy, optim.tree_map(np.copy, p0))
    to = optim.init(tp)
    for g in grads:
        jp, jo, jm = joptim.update(jax.tree.map(jnp.asarray, g), jo, jp,
                                   joptim.AdamWConfig(lr=1e-2))
        tp, to, tm = optim.update(optim.tree_map(torch.from_numpy, g), to, tp,
                                  cfg)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    assert int(to["step"]) == int(jo["step"]) == 3
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        for a, b in zip(optim.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)


def test_tree_leaves_follow_the_reference_order():
    tree = {"b": {"z": 1, "a": 2}, "a": (3, {"y": 4, "x": 5})}
    assert optim.tree_leaves(tree) == jax.tree.leaves(tree)


# ----------------------------------------------------------- chunked loss --
@pytest.mark.parametrize("S,target", [(48, 512), (48, 16), (30, 16)])
def test_chunked_ce_matches_the_reference(S, target):
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, S, 24)).astype(np.float32)
    head = rng.standard_normal((24, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, S)).astype(np.int32)
    want = float(jchunked_ce(jnp.asarray(h), jnp.asarray(head),
                             jnp.asarray(labels), target_chunk=target))
    ht, headt = (torch.from_numpy(x).requires_grad_() for x in (h, head))
    got = chunked_ce(ht, headt, torch.from_numpy(labels), target_chunk=target)
    assert float(got.detach()) == pytest.approx(want, rel=1e-6)
    jg = jax.grad(lambda a, b: jchunked_ce(a, b, jnp.asarray(labels),
                                           target_chunk=target),
                  argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    got.backward()
    for t, j in zip((ht.grad, headt.grad), jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-6)


# ------------------------------------------------------------------ remat --
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-moe-3b-a800m",
                                  "whisper-tiny"])
def test_remat_policies_give_the_same_gradients(arch):
    """Full remat, the "dots" policy and no remat differ only in what the
    backward keeps, never in what it computes."""
    from repro_torch.models import encdec, lm

    cfg = get_config(arch).smoke()
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = inputs.make_batch(cfg, SHAPE, torch.Generator().manual_seed(1))
    results = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        perf_flags.set_flags(remat_policy=policy)
        try:
            def loss_fn(p, b):
                if cfg.cross_attention:
                    h, aux = encdec.forward(p, cfg, b["tokens"], b["frames"],
                                            remat=remat, return_hidden=True,
                                            compute_dtype=torch.float32)
                else:
                    h, aux = lm.forward(p, cfg, b["tokens"], remat=remat,
                                        return_hidden=True,
                                        compute_dtype=torch.float32)
                ce = chunked_ce(h, lm.head_weights(p, cfg)
                                if not cfg.cross_attention
                                else p["lm_head"], b["labels"])
                return ce + 0.01 * aux, (ce, aux)

            results.append(value_and_grad(loss_fn, params, batch))
        finally:
            perf_flags.reset_flags()
    (l0, _), g0 = results[0]
    for (l, _), g in results[1:]:
        assert float(l) == float(l0)
        for a, b in zip(optim.tree_leaves(g), optim.tree_leaves(g0)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_unknown_remat_policy_raises():
    from repro_torch.models import lm

    cfg = get_config("stablelm-1.6b").smoke()
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    perf_flags.set_flags(remat_policy="everything")
    try:
        with pytest.raises(ValueError, match="remat_policy"):
            lm.forward(params, cfg, torch.zeros((1, 4), dtype=torch.int32),
                       remat=True)
    finally:
        perf_flags.reset_flags()


# ------------------------------------------------------- specs, shardings --
# an encoder (bge, jina) has no train or decode step
@pytest.mark.parametrize("arch", sorted(
    a for a in JAX_ARCHS if jax_get_config(a).arch_type != "encoder"))
def test_input_and_cache_specs_match_the_reference(arch):
    jc, tc = jax_get_config(arch), get_config(arch)
    for name, jshape in sorted(JAX_SHAPES.items()):
        shape = INPUT_SHAPES[name]
        assert inputs.text_len(tc, shape) == jinputs.text_len(jc, jshape)
        want = jinputs.input_specs(jc, jshape)
        got = inputs.input_specs(tc, shape)
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert got[k].is_meta and tuple(got[k].shape) == s.shape
            assert str(got[k].dtype).split(".")[1] == str(s.dtype)
    shape = INPUT_SHAPES["decode_32k"]
    want = jinputs.cache_specs(jc, JAX_SHAPES["decode_32k"])
    got = inputs.cache_specs(tc, shape)
    for k, s in want.items():
        if k == "pos":
            assert got[k] == 0
            continue
        assert got[k].is_meta and tuple(got[k].shape) == s.shape, k


def test_make_batch_draws_the_specs():
    cfg = get_config("internvl2-2b").smoke()
    shape = ShapeConfig("s", seq_len=40, global_batch=3, kind="train")
    b = inputs.make_batch(cfg, shape, torch.Generator().manual_seed(0))
    assert b["tokens"].shape == (3, 40 - cfg.num_patches)
    assert b["tokens"].dtype == torch.int32
    assert int(b["tokens"].max()) < cfg.vocab_size
    assert b["patches"].shape == (3, cfg.num_patches, cfg.d_model)
    assert b["patches"].dtype == torch.bfloat16


def test_train_shardings_equal_the_reference_specs():
    m = FakeMesh({"data": 16, "model": 16})
    arch = "stablelm-1.6b"
    jtree = jax.eval_shape(lambda: japi.init_params(jax.random.PRNGKey(0),
                                                    jax_get_config(arch)))
    ttree = api.param_shapes(get_config(arch))
    shape = ShapeConfig("train_4k", 4096, 256, "train")
    (psh, osh, bsh), (psh2, osh2, msh) = train_shardings(
        get_config(arch), shape, m, ttree)
    want = jsharding.param_pspecs(m, jtree)

    def pairs(tree, path=()):
        if isinstance(tree, dict):
            return {kk: vv for k, v in tree.items()
                    for kk, vv in pairs(v, path + (k,)).items()}
        return {path: tree}

    assert {p: s for p, (_, s) in pairs(psh).items()} == {
        p: tuple(s) for p, s in pairs(want).items()}
    assert osh["m"] is psh and osh["step"] == (m, ()) and psh2 is psh
    assert bsh == {"tokens": (m, ("data", None)),
                   "labels": (m, ("data", None))}
    assert sorted(msh) == ["ce", "grad_norm", "loss", "moe_aux"]


def test_a_mesh_of_several_devices_is_refused():
    """A mesh of several devices is no longer refused (the name is kept):
    a tree placed over (4, 1) (B 2, the batch whole at every data
    position) and over (2, 2) CPU positions takes the step, and its loss
    equals the one-device loss within 1e-6 relative."""
    cfg = get_config("stablelm-1.6b").smoke()
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = next(inputs.train_stream(cfg, SHAPE, 0))
    one = Mesh(["cpu"], (1, 1), ("data", "model"))
    (want, _), _ = value_and_grad(
        build_loss_fn(cfg, SHAPE, one, compute_dtype=torch.float32),
        params, batch)
    for shape in ((4, 1), (2, 2)):
        mesh = Mesh(["cpu"] * 4, shape, ("data", "model"))
        placed = sharding.shard_tree(
            optim.tree_map(torch.clone, params),
            train_shardings(cfg, SHAPE, mesh, params)[0][0])
        step = build_train_step(cfg, SHAPE, mesh,
                                compute_dtype=torch.float32)
        _, opt, m = step(placed, optim.init(placed), batch)
        assert sharding.is_placed(opt["m"]) and int(opt["step"]) == 1
        assert float(m["loss"]) == pytest.approx(float(want), rel=1e-6)


# -------------------------------------------------------------------- CLI --
def test_loss_decreases(tmp_path):
    _, _, losses = train("stablelm-1.6b", steps=12, batch=4, seq=32,
                         smoke=True, lr=1e-3, log_every=100, device="cpu")
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_checkpoint_resume_exact(tmp_path):
    ck = str(tmp_path / "ck.npz")
    kw = dict(batch=2, seq=32, smoke=True, seed=3, log_every=100,
              device="cpu")
    p_full, o_full, l_full = train("stablelm-1.6b", steps=6, **kw)
    train("stablelm-1.6b", steps=3, ckpt=ck, **kw)
    p_res, o_res, l_res = train("stablelm-1.6b", steps=3, resume=ck, **kw)
    assert l_res == pytest.approx(l_full[3:], abs=1e-5)
    for a, b in zip(optim.tree_leaves(p_full), optim.tree_leaves(p_res)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    assert int(o_res["step"]) == int(o_full["step"]) == 6


def test_checkpoint_shape_validation(tmp_path):
    path = str(tmp_path / "x.npz")
    tree = {"a": torch.ones((2, 3)), "b": {"c": torch.zeros((4,))}}
    checkpoint.save(path, tree, {"step": 7})
    back, meta = checkpoint.load(path, tree)
    assert meta["step"] == 7
    np.testing.assert_array_equal(back["a"].numpy(), np.ones((2, 3)))
    bad = {"a": torch.ones((2, 4)), "b": {"c": torch.zeros((4,))}}
    with pytest.raises(ValueError):
        checkpoint.load(path, bad)


def test_the_cli_runs_on_the_card_unless_told_otherwise(monkeypatch):
    import sys

    from repro_torch.launch import train as cli

    seen = {}
    monkeypatch.setattr(cli, "train", lambda *a, **kw: seen.update(kw))
    monkeypatch.setattr(sys, "argv", ["train", "--steps", "1"])
    cli.main()
    assert seen["device"] == "cuda"
    monkeypatch.setattr(sys, "argv", ["train", "--device", "cpu"])
    cli.main()
    assert seen["device"] == "cpu"


def test_mamba_scan_chunked_matches_the_reference():
    rng = np.random.default_rng(2)
    B, S, DI, N = 2, 20, 6, 4
    xc, dt = (rng.standard_normal((B, S, DI)).astype(np.float32) * 0.5
              for _ in range(2))
    dt = np.abs(dt)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    A = -np.abs(rng.standard_normal((DI, N))).astype(np.float32)
    want_y, want_h = jL.mamba_scan_chunked(*(jnp.asarray(a) for a in
                                             (xc, dt, Bm, Cm, A)), chunk=8)
    args = [torch.from_numpy(a).requires_grad_() for a in (xc, dt, Bm, Cm, A)]
    y, h = L.mamba_scan_chunked(*args, chunk=8)     # 8 -> 5, a divisor of 20
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h),
                               rtol=0, atol=1e-5)
    # the same gradients as the sequential scan
    g = torch.autograd.grad((y.sum() + h.sum()), args)
    y2, h2 = L.ssm_scan(*args)                      # the sequential scan
    g2 = torch.autograd.grad((y2.sum() + h2.sum()), args)
    for a, b in zip(g, g2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_the_train_example_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """examples/torch_train_lm.py, the twin of examples/train_lm.py:
    stream -> train step -> AdamW -> checkpoint, with ``--device cpu``."""
    import importlib.util
    import os
    import sys

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples", "torch_train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    ck = str(tmp_path / "lm.npz")
    monkeypatch.setattr(sys, "argv", [
        "torch_train_lm", "--steps", "6", "--batch", "2", "--seq", "16",
        "--ckpt", ck, "--device", "cpu"])
    example.main()
    out = capsys.readouterr().out
    assert "first-6 mean loss" in out and "last-6 mean loss" in out
    _, meta = checkpoint.load(ck, {})
    assert meta == {"step": 6, "arch": "stablelm-1.6b-smoke"}
