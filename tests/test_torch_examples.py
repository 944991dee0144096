"""The port's examples (``examples/torch_*.py``) run on the CPU with
``--device cpu``, and print what the JAX package's examples print where
the numbers do not depend on the host's clock."""
import ast
import importlib.util
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_reference(name, argv, monkeypatch, capsys):
    """The JAX package's example ``name`` with ``argv``; its stdout."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    load(name).main()
    return capsys.readouterr().out


def detector_and_estimator(out):
    """The quickstart's lines that no clock moves."""
    return [line for line in out.splitlines()
            if line.startswith(("detector:", "estimator:"))]


def test_quickstart_serves_a_burst_on_the_cpu(monkeypatch, capsys):
    c_npu, stats, embs = load("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    lines = detector_and_estimator(out)
    assert len(lines) == 2 and f"-> C_NPU={c_npu}" in lines[1]
    assert lines == detector_and_estimator(
        run_reference("quickstart", [], monkeypatch, capsys))
    assert stats.accepted + stats.rejected == c_npu + 4
    assert stats.accepted >= c_npu + 1 and stats.per_device.get("CPU", 0) >= 1
    real = [e for e in embs if np.abs(e).max() > 0]
    assert len(real) == stats.per_device["CPU"]
    for e in real:
        assert e.shape == (128,) and abs(np.linalg.norm(e) - 1.0) < 1e-3


@pytest.mark.parametrize("argv", [["--slo", "1.0"], ["--slo", "2.0"],
                                  ["--model", "jina", "--slo", "0.5"]],
                         ids=" ".join)
def test_estimate_depths_prints_the_reference_table(argv, monkeypatch,
                                                    capsys):
    load("torch_estimate_depths").main(argv)
    got = capsys.readouterr().out
    assert got == run_reference("estimate_depths", argv, monkeypatch, capsys)
    assert len(got.splitlines()) >= 3


def depths_and_gains(out):
    """The numbers of the offload printout that no clock moves."""
    return (re.findall(r"C=(\d+)", out),
            re.findall(r"concurrency \+[\d.]+%  peak-provisioned cost saving "
                       r"[\d.]+%", out))


@pytest.mark.parametrize("three", [False, True], ids=["two-tier",
                                                      "three-tier"])
def test_serve_offload_runs_the_table1_ab_on_the_cpu(three, monkeypatch,
                                                     capsys):
    argv = ["--queries", "56"] + (["--three-tier"] if three else [])
    base, wind, c_base, c_wind = load("torch_serve_offload").main(
        argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert c_base == 45 and c_wind == 45 + 2 + (2 if three else 0)
    # a burst outruns the first batch: every tier's depth is accepted
    assert base.accepted + base.rejected == wind.accepted + wind.rejected
    assert base.accepted >= c_base and wind.accepted >= c_wind
    assert wind.per_device.get("CPU", 0) >= 1
    for line in ("baseline (no offload):", "WindVE   (offload):",
                 "peak-provisioned cost saving"):
        assert line in out
    assert depths_and_gains(out) == depths_and_gains(
        run_reference("serve_offload", argv, monkeypatch, capsys))


def test_offload_run_engine_returns_each_querys_vector():
    """What the card's offload phase reads: vectors in query order, None
    where refused, zeros from the modeled tier, unit vectors from the real
    one."""
    from repro_torch.configs import get_config
    from repro_torch.core.routing import Query
    from repro_torch.core.windve import TorchEmbedderBackend
    from repro_torch.models import embedder

    ex = load("torch_serve_offload")
    cfg = get_config("bge-large-zh-v1.5").smoke()
    params = embedder.init_embedder(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    real = TorchEmbedderBackend(cfg, params, max_tokens=32, dtype="fp32",
                                device="cpu")
    stats, _, c, queries, outs = ex.run_engine(True, 56, cfg, real, 0.5)
    assert len(queries) == len(outs) == 56 and c == 47
    served = [o for o in outs if o is not None]
    assert len(served) == stats.accepted
    unit = [i for i, o in enumerate(outs) if o is not None
            and np.abs(o).max() > 0]
    assert len(unit) == stats.per_device["CPU"]
    for i in unit:
        want = real.embed_batch([Query(qid=0, payload=queries[i],
                                       length=ex.LENGTH)])[0]
        np.testing.assert_allclose(outs[i], want, atol=1e-6, rtol=0)


def pinned(fn):
    """``fn()`` with the GIL switch interval pinned at 5 s, so a burst of
    submits lands before an engine worker pops its first batch."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(5.0)
    try:
        return fn()
    finally:
        sys.setswitchinterval(old)


def served_and_adapted(out):
    """The serve-llm printout's numbers that no clock moves: generations,
    rejections, the per-tier split, the depth after adaptation and the
    calibrator's observations."""
    served = re.search(r"(\d+) generations in [\d.]+s  rejected\(BUSY\)=(\d+)"
                       r"  per-device=(\{.*\})", out)
    adapted = re.search(r"NPU depth after adaptation: .*", out)
    return (served.group(1), served.group(2),
            ast.literal_eval(served.group(3)), adapted.group(0))


@pytest.mark.parametrize("argv", [[], ["--queries", "5", "--new-tokens", "3"]],
                         ids=["defaults", "five-queries"])
def test_serve_llm_serves_the_reference_examples_burst(argv, monkeypatch,
                                                        capsys):
    stats, outs = pinned(lambda: load("torch_serve_llm").main(
        argv + ["--device", "cpu"]))
    out = capsys.readouterr().out
    assert "stablelm-1.6b-smoke: generation backend on cpu" in out
    want = served_and_adapted(pinned(lambda: run_reference(
        "serve_llm", argv, monkeypatch, capsys)))
    assert served_and_adapted(out) == want
    new = 3 if argv else 8
    assert len(outs) == stats.accepted and stats.n_completed == len(outs)
    real = [o for o in outs if o.dtype.kind in "iu"]
    assert len(real) == stats.per_device.get("CPU", 0)
    for o in real:
        assert o.shape == (new,) and ((o >= 0) & (o < 512)).all()
