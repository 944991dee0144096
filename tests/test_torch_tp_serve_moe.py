"""The serving steps of granite-moe-3b-a800m and hymba-1.5b on a (data,
model) mesh against the JAX reference on one device, on the CPU: the cases
and the bars of ``test_torch_tp_serve.py`` (a file of its own so the two
halves run side by side).

granite's 4 experts run over ``model`` on 2 and 4 positions, whole on 1,
and its global dispatch gathers the batch over ``data`` first; hymba's
25-head attention is cut to 4 heads of 32 at smoke size (on heads), its
mamba channels run over ``model`` with each position's range of both
``in_proj`` halves, and its 16-slot window wraps in the 20-token prefill.
"""
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_tp_serve import (  # noqa: E402
    CASES, case_id, check_case, reference)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def refs():
    out = {}

    def get(arch, batch):
        if (arch, batch) not in out:
            out[(arch, batch)] = reference(arch, batch)
        return out[(arch, batch)]

    return get


@pytest.mark.parametrize("case", CASES, ids=case_id)
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "hymba-1.5b"])
def test_mesh_steps_match_the_reference(arch, case, refs):
    check_case(arch, case, refs(arch, case[1]))


# ---------------------------------------------- the card's phase, on CPU --
def _chip_smoke():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen2-72b", "granite-moe-3b-a800m",
                                  "hymba-1.5b"])
def test_the_mesh_phase_rehearses_on_the_cpu(arch):
    """``chip_smoke.mesh_tp`` at smoke size on 8 CPU positions: every case
    held at the card's bars (the plain versions count no launches, so the
    meta trace's calls are reported, not compared), the tree let go leaf by
    leaf, and the split kernels' flops over the positions equal to the
    whole run's."""
    from repro_torch.models import lm

    cs = _chip_smoke()
    dev = torch.device("cpu")
    cfg = cs.mesh_config(dev, arch)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device=dev,
                        dtype=torch.bfloat16)
    out, _ = cs.mesh_tp(dev, cs.mesh_devices(dev, 8), arch, params)
    assert not params["blocks"]["norm1"]            # placed leaf by leaf
    cases = out["cases"]
    assert len(cases) == len(cs.tp_cases(arch, False))
    for case in cases:
        assert case["held"] and case["tokens_equal"]
        if case["B"] == cs.TP_B:
            for k in cs.TP_SPLIT[arch]:
                assert case["flops_over_whole"][k] == 1.0
        assert case["meta_kernel_calls"]["rmsnorm"] > 0
