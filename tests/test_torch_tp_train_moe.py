"""The train step over a (data, model) mesh against the JAX reference on one
device, on the CPU: internvl2-2b (its patches before the text, the loss
over the text positions) and granite-moe-3b-a800m (4 experts over the
model axis where it divides them, else the FFN dims; the global dispatch
gathered over the data axes, its load-balance loss the whole batch's,
once), with ``test_torch_tp_train.py``'s setup and bars.

Cases: meshes (1, 4), (2, 2), (4, 1) and (2, 4) at B 4 and B 1 on (2, 2);
granite's replicated slices as separate copies on (2, 2); granite under
``moe_row_dispatch`` on (2, 2) and (2, 4) (each row dispatched where it
lies, the load-balance loss from the routing counts summed over the data
axes) against the reference under the same flag; and granite's mesh step
traced on eight meta positions.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import perf_flags  # noqa: E402
from tests.test_torch_tp_train import (CASES, case_id,  # noqa: E402
                                       check_case, meta_calls, refs)

ARCHS = ("internvl2-2b", "granite-moe-3b-a800m")
MOE = "granite-moe-3b-a800m"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES, ids=case_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_the_reference(arch, case, refs):
    mesh_shape, batch = case
    check_case(arch, mesh_shape, refs(arch, batch))


def test_separate_copies_of_a_slice_are_summed_once(refs):
    check_case(MOE, (2, 2), refs(MOE, 4), copies=True)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)],
                         ids=["2x2", "2x4"])
def test_the_row_dispatch_trains_over_a_mesh(mesh_shape, refs):
    ref = refs(MOE, 4, row_dispatch=True)
    perf_flags.set_flags(moe_row_dispatch=True)
    try:
        check_case(MOE, mesh_shape, ref)
    finally:
        perf_flags.reset_flags()


def test_the_moe_mesh_step_traces_on_meta_positions():
    """Each of the 8 positions: attention once a layer forward and once
    more in the recompute, its backward once; rmsnorm twice a layer (and
    the final norm), twice in the forward."""
    tc, cost = meta_calls(MOE)
    Lc, n = tc.num_layers, 8
    assert cost.kernel_calls == {"flash_attention": n * 2 * Lc,
                                 "flash_attention_bwd": n * Lc,
                                 "rmsnorm": n * (4 * Lc + 1),
                                 "rmsnorm_bwd": n * (2 * Lc + 1)}
