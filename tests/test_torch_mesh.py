"""The port's mesh builders (``repro_torch.launch.mesh``) against the
reference's ``launch/mesh.py``, on the CPU.

The reference carves a forced 8-device host pool (a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_mesh.py`` does); the port carves a pool of 8 CPU devices
(``torch.device("cpu", i)``, so the groups can be read back by index).
Both must give the same groups in the same order.  Then the reference's
validation cases (``tests/test_mesh.py``), on pools the port is handed,
since the port's default pool is the visible CUDA cards.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOPOLOGIES = [(1, 1), (1, 2), (2, 2), (1, 4), (2, 4), (1, 8)]
CPU = torch.device("cpu")


def run_forced(devices: int, body: str, timeout: int = 300) -> str:
    """A JAX snippet in a subprocess with a forced CPU device count (the
    count is fixed when JAX starts, and the suite's own process keeps one
    device); its stdout.  Also used by the other multi-device port tests."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={devices} "
                        + env.get("XLA_FLAGS", "")).strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    return proc.stdout


@pytest.fixture(scope="module")
def reference_groups():
    """{(hosts, replicas): [(mesh shape, [device ids])]} from the
    reference on 8 forced devices."""
    out = run_forced(8, f"""
        import json
        import jax
        from repro.launch.mesh import make_replica_meshes
        res = {{}}
        for h, r in {TOPOLOGIES!r}:
            ms = make_replica_meshes(h, r)
            res[f"{{h}}x{{r}}"] = [
                [dict(m.shape), [d.id for d in m.devices.flat]] for m in ms]
        print(json.dumps(res))
    """)
    return json.loads(out.strip().splitlines()[-1])


def pool(n):
    return [torch.device("cpu", i) for i in range(n)]


@pytest.mark.parametrize("topology", TOPOLOGIES,
                         ids=lambda t: "{}x{}".format(*t))
def test_replica_groups_equal_the_reference(reference_groups, topology):
    hosts, replicas = topology
    got = [[m.shape, [d.index for d in m.devices.flat]]
           for m in M.make_replica_meshes(hosts, replicas, pool(8))]
    assert got == reference_groups[f"{hosts}x{replicas}"]


def test_carving_works_on_positions_not_device_identity():
    """One card carrying several logical positions: a pool of the same
    device eight times carves into the same group sizes."""
    ms = M.make_replica_meshes(2, 2, [CPU] * 8)
    assert [m.devices.size for m in ms] == [2, 2, 2, 2]
    assert all(m.shape == {"data": 2, "model": 1} for m in ms)
    assert all(d == CPU for m in ms for d in m.device_list)


def test_production_mesh_error_names_both_counts():
    with pytest.raises(ValueError) as e:
        M.make_production_mesh(devices=[CPU])
    msg = str(e.value)
    assert "256" in msg and "1" in msg


def test_multi_pod_error_names_both_counts():
    with pytest.raises(ValueError) as e:
        M.make_production_mesh(multi_pod=True, devices=pool(8))
    assert "512" in str(e.value) and "8" in str(e.value)


def test_production_mesh_over_a_full_pool():
    m = M.make_production_mesh(devices=[CPU] * 256)
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    m = M.make_production_mesh(multi_pod=True, devices=[CPU] * 512)
    assert m.axis_names == ("pod", "data", "model")


def test_host_mesh_fits_one_device():
    m = M.make_host_mesh([CPU])
    assert m.devices.size == 1 and m.shape == {"data": 1, "model": 1}
    assert M.make_host_mesh(pool(8)).device_list == [torch.device("cpu", 0)]


def test_serve_mesh_rejects_empty_pool():
    with pytest.raises(ValueError, match="at least one device"):
        M.make_serve_mesh([])


def test_default_pool_is_the_visible_cards():
    """No fallback to the CPU: without a card the default pool is empty
    and every builder raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert M.visible_devices() == []
    with pytest.raises(ValueError, match="at least one device"):
        M.make_serve_mesh()
    with pytest.raises(ValueError, match="needs 1 device"):
        M.make_host_mesh()
    with pytest.raises(ValueError, match="256"):
        M.make_production_mesh()


def test_replica_meshes_one_by_one_degrades_to_serve_mesh():
    ms = M.make_replica_meshes(1, 1, [CPU])
    assert len(ms) == 1
    assert ms[0].shape == M.make_serve_mesh([CPU]).shape


def test_replica_meshes_reject_oversubscription():
    with pytest.raises(ValueError) as e:
        M.make_replica_meshes(2, 2, [CPU])          # 4 groups, 1 device
    msg = str(e.value)
    assert "4" in msg and "1" in msg and "replica" in msg


def test_replica_meshes_reject_bad_shape():
    with pytest.raises(ValueError):
        M.make_replica_meshes(0, 1, [CPU])
    with pytest.raises(ValueError):
        M.make_replica_meshes(1, -1, [CPU])


def test_uneven_split_raises_named_error():
    with pytest.raises(ValueError) as e:
        M.make_replica_meshes(3, 1, pool(8))
    assert "8" in str(e.value) and "3" in str(e.value)


def test_pool_subset_and_full_serve_mesh():
    full = M.make_serve_mesh(pool(8))
    assert full.devices.size == 8 and full.shape == {"data": 8, "model": 1}
    half = M.make_replica_meshes(1, 2, pool(8)[:4])
    assert [m.devices.size for m in half] == [2, 2]


def test_mesh_grid_and_context():
    m = M.Mesh(pool(8), (2, 4), ("data", "model"))
    assert m.devices.shape == (2, 4) and m.size == 8
    assert m.devices[1, 2] == torch.device("cpu", 6)
    with M.mesh_context(m) as inside:
        assert inside is m
    with pytest.raises(ValueError, match="does not fit"):
        M.Mesh(pool(3), (2, 2), ("data", "model"))
