"""The port's sharding rules and placement (``repro_torch.parallel.sharding``)
against the reference's ``parallel/sharding.py``, on the CPU.

Specs: for every registered config at its published size, the port's
``param_pspecs`` (read off a meta-device param tree) equal ``tuple(P)`` of
the reference's (read off ``jax.eval_shape``), leaf for leaf, in train and
serve mode, on the reference's 16x16 and 2x16x16 production meshes and on
an (8, 1) and a (1, 4) serving mesh (``tests/test_sharding.py``'s
``FakeMesh``).  ``cache_pspecs`` and ``batch_pspecs`` are held for every
``INPUT_SHAPES`` entry.  Placement: ``shard`` cuts the blocks the
reference's ``addressable_shards`` hold on a forced 8-device pool (a
subprocess), position for position, and ``unshard`` puts them back.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_MODULES as JAX_ARCHS  # noqa: E402
from repro.configs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shape_supported  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro.steps.inputs import cache_specs  # noqa: E402
from repro_torch import perf_flags  # noqa: E402
from repro_torch.configs import ARCH_MODULES, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.steps import serve  # noqa: E402
from tests.test_sharding import FakeMesh  # noqa: E402
from tests.test_torch_mesh import run_forced  # noqa: E402

MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
          "8x1": FakeMesh({"data": 8, "model": 1}),
          "1x4": FakeMesh({"data": 1, "model": 4})}
ARCHS = sorted(ARCH_MODULES)
DECODE_PAIRS = [(a, s) for a in ARCHS for s in sorted(JAX_SHAPES)
                if JAX_SHAPES[s].kind == "decode"
                and shape_supported(jax_get_config(a), JAX_SHAPES[s])[0]]


def flat(tree, path=()):
    """{key path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (k,)))
        return out
    return {path: tree}


_shapes = {}


def shapes(arch):
    """(the reference's eval_shape tree, the port's meta tree), cached."""
    if arch not in _shapes:
        jcfg = jax_get_config(arch)
        _shapes[arch] = (
            jax.eval_shape(lambda: japi.init_params(jax.random.PRNGKey(0),
                                                    jcfg, jnp.float32)),
            api.param_shapes(get_config(arch)))
    return _shapes[arch]


def test_registered_configs_are_the_reference_configs():
    assert sorted(ARCH_MODULES) == sorted(JAX_ARCHS)
    import dataclasses
    for arch in ARCHS:
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(jax_get_config(arch))), arch


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, mode):
    jtree, ttree = shapes(arch)
    jflat, tflat = flat(jtree), flat(ttree)
    assert sorted(jflat) == sorted(tflat)
    for path in jflat:
        assert tuple(tflat[path].shape) == jflat[path].shape, path
        assert tflat[path].device.type == "meta"
    want = flat(jsharding.param_pspecs(MESHES[mesh], jtree, mode))
    got = flat(sharding.param_pspecs(MESHES[mesh], ttree, mode))
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path] == tuple(want[path]), (path, got[path], want[path])


def _port_cache_shape(cfg, shape):
    return api.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device="meta")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("pair", DECODE_PAIRS, ids=lambda p: "-".join(p))
def test_cache_specs_equal_the_reference(pair, mesh):
    arch, shape_name = pair
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jshape, tshape = JAX_SHAPES[shape_name], INPUT_SHAPES[shape_name]
    jcache = cache_specs(jcfg, jshape)
    tcache = _port_cache_shape(tcfg, tshape)
    assert sorted(jcache) == sorted(tcache)
    want = jsharding.cache_pspecs(jcfg, jshape, MESHES[mesh], jcache)
    got = sharding.cache_pspecs(tcfg, tshape, MESHES[mesh], tcache)
    for name in jcache:
        if name != "pos":
            assert tuple(tcache[name].shape) == jcache[name].shape, name
        assert got[name] == tuple(want[name]), (name, got[name], want[name])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
def test_batch_and_logits_specs_equal_the_reference(shape_name, mesh):
    m = MESHES[mesh]
    for arch in ARCHS:
        want = jsharding.batch_pspecs(jax_get_config(arch),
                                      JAX_SHAPES[shape_name], m)
        got = sharding.batch_pspecs(get_config(arch),
                                    INPUT_SHAPES[shape_name], m)
        assert got == {k: tuple(v) for k, v in want.items()}, arch
    for big in (False, True):
        assert sharding.logits_pspec(m, big) == tuple(
            jsharding.logits_pspec(m, big))
    assert sharding.dp_axes(m) == jsharding.dp_axes(m)
    assert sharding._dp_size(m) == jsharding._dp_size(m)


def test_serve_embed_shardings_keep_weights_resident():
    """The embed tier's (8, 1) serving mesh: no weight spec names
    ``data`` (train mode does), and the batch splits over ``data``."""
    m = Mesh(["cpu"] * 8, (8, 1), ("data", "model"))
    tree = api.param_shapes(get_config("bge-large-zh-v1.5"))
    psh, (bmesh, bspec) = sharding.serve_embed_shardings(m, tree)
    assert bmesh is m and bspec == ("data", None)
    for mesh_, spec in flat(psh).values():
        assert mesh_ is m and "data" not in spec
    train = flat(sharding.param_pspecs(m, tree, "train")).values()
    assert any("data" in spec for spec in train)


@pytest.mark.parametrize("tp_only", [False, True])
def test_serve_shardings_equal_the_reference_specs(tp_only):
    """steps/serve.serve_shardings: the param specs of the mode
    ``serve_tp_only`` picks, the batch and cache specs, as (mesh, spec)
    pairs."""
    m = FakeMesh({"data": 16, "model": 16})
    arch = "qwen2-72b"
    jtree, ttree = shapes(arch)
    shape = INPUT_SHAPES["decode_32k"]
    cache = _port_cache_shape(get_config(arch), shape)
    try:
        perf_flags.set_flags(serve_tp_only=tp_only)
        psh, csh, bsh = serve.serve_shardings(get_config(arch), shape, m,
                                              ttree, cache)
    finally:
        perf_flags.reset_flags()
    want = flat(jsharding.param_pspecs(m, jtree,
                                       "serve" if tp_only else "train"))
    assert {p: s for p, (_, s) in flat(psh).items()} == {
        p: tuple(s) for p, s in want.items()}
    assert csh["k"] == (m, (None, "data", "model", None, None))
    assert bsh == {"token": (m, ("data",))}
    wq = flat(psh)[("blocks", "attn", "wq")][1]
    assert wq == ((None, None, "model") if tp_only
                  else (None, "data", "model"))


def test_hidden_constraint_is_the_identity():
    h = torch.randn(2, 3, 4)
    assert sharding.hidden_constraint(MESHES["8x1"], True)(h) is h


# ------------------------------------------------------------- placement --
# (mesh shape, axis names, array shape, spec): replicated, split over one
# axis, over two axes jointly, over two dims, a 1-D sequence split
PLACEMENTS = [
    ((8, 1), ("data", "model"), (16, 6), ("data", None)),
    ((8, 1), ("data", "model"), (16, 6), (None, None)),
    ((1, 8), ("data", "model"), (3, 16, 2), (None, "model", None)),
    ((2, 4), ("data", "model"), (4, 8, 2), ("data", "model")),
    ((2, 4), ("data", "model"), (8, 3), (("data", "model"), None)),
    ((2, 4), ("data", "model"), (2, 2, 8, 2, 4),
     (None, "data", "model", None, None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4),
     (("pod", "data"), "model")),
    ((1, 4), ("data", "model"), (8,), ("model",)),
]


@pytest.fixture(scope="module")
def reference_placements():
    """For each case, [(position, [(start, stop) per dim])] of the
    reference's addressable shards on 8 forced devices, and the data."""
    cases = [[list(s), list(a), list(sh),
              [list(e) if isinstance(e, tuple) else e for e in sp]]
             for s, a, sh, sp in PLACEMENTS]
    out = run_forced(8, f"""
        import json
        import numpy as np
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        res = []
        for shape, axes, arr_shape, spec in {cases!r}:
            n = int(np.prod(shape))
            mesh = jax.make_mesh(tuple(shape), tuple(axes),
                                 devices=jax.devices()[:n])
            spec = P(*[tuple(e) if isinstance(e, list) else e
                       for e in spec])
            x = np.arange(int(np.prod(arr_shape)), dtype=np.float32)
            arr = jax.device_put(x.reshape(arr_shape),
                                 NamedSharding(mesh, spec))
            flat = list(mesh.devices.flat)
            blocks = []
            for s in arr.addressable_shards:
                idx = [[sl.start or 0, arr_shape[i] if sl.stop is None
                        else sl.stop] for i, sl in enumerate(s.index)]
                blocks.append([flat.index(s.device), idx,
                               np.asarray(s.data).ravel().tolist()])
            res.append(sorted(blocks))
        print(json.dumps(res))
    """)
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(PLACEMENTS)))
def test_shard_cuts_the_reference_blocks(reference_placements, case):
    mesh_shape, axes, arr_shape, spec = PLACEMENTS[case]
    n = int(np.prod(mesh_shape))
    mesh = Mesh([torch.device("cpu", i) for i in range(n)], mesh_shape, axes)
    x = torch.arange(int(np.prod(arr_shape)),
                     dtype=torch.float32).reshape(arr_shape)
    s = sharding.shard(x, spec, mesh)
    got = sorted([pos, [[sl.start, sl.stop] for sl in idx],
                  blk.ravel().tolist()]
                 for pos, (idx, blk) in enumerate(zip(s.index, s.blocks)))
    assert got == reference_placements[case]
    # (a CPU tensor's device carries no index)
    assert all(b.device.type == "cpu" for b in s.blocks)
    assert torch.equal(sharding.unshard(s), x)


def test_shard_shares_a_block_a_device_and_raises_on_uneven_dims():
    """Positions on one device that hold the same block share it (one card
    carrying several logical positions holds a replicated weight once); a
    whole block where the tensor lies is the tensor itself."""
    mesh = Mesh(["cpu"] * 4, (4, 1), ("data", "model"))
    x = torch.randn(8, 3)
    rep = sharding.shard(x, (None, None), mesh)
    assert all(b is x for b in rep.blocks)
    split = sharding.shard(x, ("data", None), mesh)
    assert len({id(b) for b in split.blocks}) == 4
    assert [b.shape for b in split.along(0)] == [(2, 3)] * 4
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard(torch.randn(6, 3), ("data", None), mesh)
