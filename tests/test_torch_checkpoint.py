"""The port's checkpoints (``repro_torch.steps.checkpoint``) against the
reference's ``steps/checkpoint.py``, on the CPU: a training state the port
saves loads in the reference's ``load`` and one the reference saves loads
in the port's, leaf for leaf; the same keys, the same metadata, the same
error messages; and bfloat16 leaves refused by name.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.steps import checkpoint as jcheckpoint  # noqa: E402
from repro.steps import optim as joptim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.steps import checkpoint, optim  # noqa: E402

ARCHS = ["stablelm-1.6b", "hymba-1.5b", "whisper-tiny"]


def _port_state(arch, seed=0):
    cfg = get_config(arch).smoke()
    params = api.init_params(cfg, torch.Generator().manual_seed(seed),
                             device="cpu")
    opt = optim.init(params)
    for m in optim.tree_leaves(opt["m"]):
        m.normal_(generator=torch.Generator().manual_seed(seed + 1))
    opt["step"].fill_(5)
    return params, opt


def _jax_like(arch):
    cfg = jax_get_config(arch).smoke()
    return jax.eval_shape(lambda: (
        lambda p: (p, joptim.init(p)))(japi.init_params(
            jax.random.PRNGKey(0), cfg)))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_port_checkpoint_loads_in_the_reference(arch, tmp_path):
    path = str(tmp_path / "port.npz")
    state = _port_state(arch)
    checkpoint.save(path, state, {"step": 5, "arch": arch})
    back, meta = jcheckpoint.load(path, _jax_like(arch))
    assert meta == {"step": 5, "arch": arch}
    got = jax.tree.leaves(back)
    want = optim.tree_leaves(state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == jnp.dtype(str(w.dtype).split(".")[1])
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_a_reference_checkpoint_loads_in_the_port(arch, tmp_path):
    path = str(tmp_path / "ref.npz")
    cfg = jax_get_config(arch).smoke()
    params = japi.init_params(jax.random.PRNGKey(2), cfg)
    opt = joptim.init(params)
    opt = {**opt, "m": jax.tree.map(lambda a: a + 0.5, opt["m"]),
           "step": jnp.asarray(9, jnp.int32)}
    jcheckpoint.save(path, (params, opt), {"step": 9})
    like = _port_state(arch, seed=7)
    back, meta = checkpoint.load(path, like)
    assert meta == {"step": 9}
    got = optim.tree_leaves(back)
    want = jax.tree.leaves((params, opt))
    assert len(got) == len(want)
    for g, w, ref in zip(got, want, optim.tree_leaves(like)):
        assert g.dtype == ref.dtype and g.device == ref.device
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the keys are the reference's tree paths
    with np.load(path) as data:
        assert "0/blocks/attn/wq" in data or "0/blocks/mamba/in_proj" in data \
            or "0/dec_blocks/attn/wq" in data
        assert "1/step" in data and "__metadata__" in data


def test_keys_and_errors_match_the_reference(tmp_path):
    tree = {"a": torch.ones((2, 3)), "b": {"c": torch.zeros((4,))}}
    jtree = {"a": jnp.ones((2, 3)), "b": {"c": jnp.zeros((4,))}}
    p, jp = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    checkpoint.save(p, tree, {"step": 7})
    jcheckpoint.save(jp, jtree, {"step": 7})
    with np.load(p) as a, np.load(jp) as b:
        assert sorted(a.files) == sorted(b.files) == [
            "__metadata__", "a", "b/c"]
        assert bytes(a["__metadata__"]) == bytes(b["__metadata__"])
    cases = [({"a": torch.ones((2, 4)), "b": {"c": torch.zeros((4,))}},
              {"a": jnp.ones((2, 4)), "b": {"c": jnp.zeros((4,))}},
              ValueError),
             ({"a": torch.ones((2, 3)), "x": torch.zeros((1,))},
              {"a": jnp.ones((2, 3)), "x": jnp.zeros((1,))}, KeyError)]
    for like, jlike, err in cases:
        with pytest.raises(err) as mine:
            checkpoint.load(p, like)
        with pytest.raises(err) as theirs:
            jcheckpoint.load(p, jlike)
        assert str(mine.value) == str(theirs.value)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_bfloat16_leaves_are_refused_by_name(tmp_path):
    path = str(tmp_path / "x.npz")
    with pytest.raises(TypeError, match="b/c"):
        checkpoint.save(path, {"a": torch.ones(2),
                               "b": {"c": torch.ones(2, dtype=torch.bfloat16)}})
    assert not os.path.exists(path)
    jcheckpoint.save(path, {"w": jnp.ones((3,), jnp.bfloat16)})
    with pytest.raises(TypeError, match="'?w'?"):
        checkpoint.load(path, {"w": torch.ones(3)})


def test_load_places_leaves_like_the_reference_tree(tmp_path):
    path = str(tmp_path / "x.npz")
    checkpoint.save(path, {"a": torch.arange(6.0).reshape(2, 3),
                           "n": torch.tensor(3, dtype=torch.int32)})
    like = {"a": torch.empty((2, 3), dtype=torch.float64, device="meta"),
            "n": torch.empty((), dtype=torch.int32, device="meta")}
    back, meta = checkpoint.load(path, like)
    assert meta == {}
    assert back["a"].dtype == torch.float64 and back["a"].device.type == "cpu"
    assert int(back["n"]) == 3
