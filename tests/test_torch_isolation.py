"""The port stands alone: it imports neither JAX nor the JAX package."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b)",
                       re.MULTILINE)


def port_modules():
    import repro_torch

    return ["repro_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = port_modules()
    assert "repro_torch.launch.serve" in mods
    assert "repro_torch.core.sharded_backend" in mods
    for m in ("quant_matmul.ops", "quant_matmul.ref"):
        assert f"repro_torch.kernels.{m}" in mods
    for m in ("models.lm", "models.api", "core.llm_backend",
              "launch.serve_llm", "configs.hymba_1_5b", "core.cost_model",
              "core.affinity", "core.faults", "core.planner",
              "configs.stablelm_1_6b", "configs.starcoder2_7b",
              "configs.falcon_mamba_7b", "configs.internlm2_20b",
              "configs.granite_moe_3b_a800m", "configs.qwen3_moe_30b_a3b",
              "configs.internvl2_2b", "configs.whisper_tiny",
              "models.encdec", "steps.serve", "launch.mesh",
              "parallel.sharding", "configs.qwen2_72b", "steps.train",
              "steps.optim", "steps.checkpoint", "steps.inputs",
              "launch.train"):
        assert f"repro_torch.{m}" in mods
    for k in ("rmsnorm", "flash_decode", "ssm_scan"):
        for part in ("ops", "ref"):
            assert f"repro_torch.kernels.{k}.{part}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or "
            "n.startswith('jax.') or n == 'repro' or "
            "n.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + env.get("PYTHONPATH", "").split(os.pathsep))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_port_examples_load_without_jax_or_repro():
    examples = sorted(os.path.join(ROOT, "examples", f) for f in
                      os.listdir(os.path.join(ROOT, "examples"))
                      if f.startswith("torch_") and f.endswith(".py"))
    assert len(examples) == 5, examples
    assert any(e.endswith("torch_train_lm.py") for e in examples)
    code = ("import importlib.util, sys\n"
            f"for i, path in enumerate({examples!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_no_source_file_imports_jax_or_repro():
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for m in FORBIDDEN.finditer(fh.read()):
                        offenders.append(f"{os.path.relpath(path, ROOT)}: "
                                         f"{m.group(0).strip()}")
    assert not offenders, offenders


def test_the_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "    from repro.core import routing", "import repro"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "# jax is the reference", "import jaxtyping"):
        assert not FORBIDDEN.search(line), line
