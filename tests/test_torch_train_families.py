"""One train step of every assigned architecture: the port against the
reference's jitted ``build_train_step``, on the CPU.

For each ``ASSIGNED_ARCHS`` entry at its smoke size (2 layers, d_model
128, as ``tests/test_models_smoke.py`` runs them) the reference's own
params and batch are carried across (``params_from_numpy``) and both
packages compute in fp32 (the reference through a monkeypatched
``layers.COMPUTE_DTYPE``).  Held:

- loss, ce and moe_aux of the reference's jitted train step within 1e-5
  relative, and its grad_norm within 1e-4;
- every gradient leaf, before the optimizer, within 1e-4 of the leaf's
  largest magnitude (the reference's gradients come from
  ``jax.value_and_grad`` of its train step's loss, whose value is held to
  the step's).  After AdamW's first step an update is nearly sign(g), and
  a gradient near zero would flip it, so the updated params are not
  compared.

This covers the MoE pair's load-balance loss, internvl2-2b's text-only
loss over its patch-prefixed sequence and whisper-tiny's
``encdec.forward(remat=True)``; hymba-1.5b and falcon-mamba-7b, under
``mamba_chunk`` 0 and 16, run the same check in
``tests/test_torch_train.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import perf_flags as jflags  # noqa: E402
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch.mesh import make_host_mesh, mesh_context  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.steps import optim as joptim  # noqa: E402
from repro.steps.inputs import make_batch as jmake_batch  # noqa: E402
from repro.steps.train import build_train_step as jbuild  # noqa: E402
from repro.steps.train import chunked_ce as jchunked_ce  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models.embedder import params_from_numpy  # noqa: E402
from repro_torch.steps import optim  # noqa: E402
from repro_torch.steps.train import (build_loss_fn,  # noqa: E402
                                     build_train_step, value_and_grad)

B, S = 2, 32
MAMBA = ("hymba-1.5b", "falcon-mamba-7b")
# the mamba families, under both scans, run in tests/test_torch_train.py
RUNS = [(a, 0) for a in ASSIGNED_ARCHS if a not in MAMBA]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_loss(cfg, aux_weight=0.01):
    """The loss of the reference's ``build_train_step``, for jax.grad."""
    def loss_fn(params, batch):
        if cfg.cross_attention:
            h, aux = jencdec.forward(params, cfg, batch["tokens"],
                                     batch["frames"], remat=True,
                                     return_hidden=True)
            head = params["lm_head"]
        else:
            h, aux = jlm.forward(params, cfg, batch["tokens"],
                                 extra_embed=batch.get("patches"), remat=True,
                                 return_hidden=True)
            head = jlm.head_weights(params, cfg)
            if cfg.frontend == "vision":
                h = h[:, cfg.num_patches:]
        ce = jchunked_ce(h, head, batch["labels"])
        return ce + aux_weight * aux, (ce, aux)

    return loss_fn


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree, np.float32)}


def check_train_step(arch, chunk, monkeypatch):
    """The port's loss, metrics and gradients of one step of ``arch``'s
    smoke config against the reference's, both in fp32 compute."""
    monkeypatch.setattr(jL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(jflags, "FLAGS",
                        jflags.PerfFlags(mamba_chunk=chunk))
    monkeypatch.setattr(perf_flags, "FLAGS",
                        perf_flags.PerfFlags(mamba_chunk=chunk))
    jc = jax_get_config(arch).smoke()
    tc = get_config(arch).smoke()
    jshape = JShape("smoke", seq_len=S, global_batch=B, kind="train")
    shape = ShapeConfig("smoke", seq_len=S, global_batch=B, kind="train")
    key = jax.random.PRNGKey(3)
    jparams = japi.init_params(key, jc)
    batch = {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                           else v)
             for k, v in jmake_batch(jc, jshape, jax.random.PRNGKey(4)).items()}
    np_params = jax.tree.map(np.asarray, jparams)

    mesh = make_host_mesh()
    jstep = jbuild(jc, jshape, mesh)
    jvg = jax.value_and_grad(_ref_loss(jc), has_aux=True)
    with mesh_context(mesh):
        # one compile for both (the step's metrics, the loss's gradients)
        jm, ((jloss, _), jgrads) = jax.jit(
            lambda p, o, b: (jstep(p, o, b)[2], jvg(p, b)))(
                jparams, joptim.init(jparams), batch)
    jm = {k: float(v) for k, v in jm.items()}
    assert float(jloss) == pytest.approx(jm["loss"], rel=1e-6)

    params = params_from_numpy(np_params, device="cpu")
    loss_fn = build_loss_fn(tc, shape, compute_dtype=torch.float32)
    (loss, (ce, aux)), grads = value_and_grad(loss_fn, params, batch)
    for name, got in (("loss", loss), ("ce", ce), ("moe_aux", aux)):
        assert float(got) == pytest.approx(jm[name], rel=1e-5, abs=1e-7), name
    if tc.is_moe:
        assert float(aux) > 0
    want, got = _flat(jgrads), _flat(
        optim.tree_map(lambda g: g.numpy(), grads))
    assert sorted(got) == sorted(want)
    for name in want:
        scale = np.abs(want[name]).max()
        err = np.abs(got[name] - want[name]).max()
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 x {scale}"

    step = build_train_step(tc, shape, compute_dtype=torch.float32)
    _, opt, m = step(params, optim.init(params), batch)
    assert float(m["loss"]) == pytest.approx(jm["loss"], rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(jm["grad_norm"], rel=1e-4)
    assert int(opt["step"]) == 1


@pytest.mark.parametrize("arch,chunk", RUNS,
                         ids=[f"{a}-chunk{c}" for a, c in RUNS])
def test_train_step_matches_the_reference(arch, chunk, monkeypatch):
    check_train_step(arch, chunk, monkeypatch)
