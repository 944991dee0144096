"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``) on the same configs and programs.

- ``count_params`` and ``model_flops``: equal to the reference's for every
  registered config (published and smoke widths) and the four shapes, the
  reference's tree from ``jax.eval_shape(api.init_params)``, the port's
  from ``api.param_shapes``.
- ``analyse``: the reference's formulas on the same counts once its TPU
  constants are swapped for the H100's.
- ``op_cost``: ``hlo_cost``'s rules on programs whose answers are known (a
  matmul, a loop over stacked weights, a slice write into a large buffer,
  a checkpointed block), and at smoke size the flops of whole steps: a
  bge forward and a causal LM train step against ``analyse_hlo`` of the
  reference's compiled step.
- ``kernel_cost``: three of PERF.md's kernel bounds at their shapes.

The reference's ``launch/dryrun.py`` sets a 512-device XLA host platform
when imported, so no test here imports it (``test_torch_dryrun.py`` holds
the port's dry run).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.configs import ARCH_MODULES as JAX_ARCHS  # noqa: E402
from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED  # noqa: E402
from repro.configs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shape_supported as jax_shape_supported  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch.mesh import make_host_mesh, mesh_context  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import embedder as jembedder  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import hlo_cost  # noqa: E402
from repro.steps import optim as joptim  # noqa: E402
from repro.steps.inputs import input_specs as jinput_specs  # noqa: E402
from repro.steps.train import build_train_step as jbuild_train  # noqa: E402
from repro_torch.configs import (ARCH_MODULES, ASSIGNED_ARCHS,  # noqa: E402
                                 INPUT_SHAPES, get_config, shape_supported)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_mask)
from repro_torch.models import api, embedder  # noqa: E402
from repro_torch.roofline import analysis, kernel_cost, op_cost  # noqa: E402
from repro_torch.steps import inputs, optim  # noqa: E402
from repro_torch.steps.train import build_train_step  # noqa: E402

META = dict(device="meta")


def _frac(cfg):
    return (cfg.experts_per_token / cfg.num_experts) if cfg.is_moe else None


# ------------------------------------------------------- configs, params --
def test_registry_and_shapes_match_the_reference():
    assert ASSIGNED_ARCHS == JAX_ASSIGNED
    assert set(ARCH_MODULES) == set(JAX_ARCHS)
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in INPUT_SHAPES.items()} == {
        k: (s.seq_len, s.global_batch, s.kind) for k, s in JAX_SHAPES.items()}
    for arch in JAX_ARCHS:
        for name in JAX_SHAPES:
            assert shape_supported(get_config(arch), INPUT_SHAPES[name]) == \
                jax_shape_supported(jax_get_config(arch), JAX_SHAPES[name])


@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_count_params_and_model_flops_equal_the_reference(arch, smoke):
    jc, tc = jax_get_config(arch), get_config(arch)
    if smoke:
        jc, tc = jc.smoke(), tc.smoke()
    key = jax.random.PRNGKey(0)
    jshape = jax.eval_shape(lambda: japi.init_params(key, jc, jnp.float32))
    tshape = api.param_shapes(tc)
    for frac in (None, _frac(jc), 0.25):
        assert analysis.count_params(tshape, frac) == \
            janalysis.count_params(jshape, frac)
    for name in JAX_SHAPES:
        assert analysis.model_flops(tc, INPUT_SHAPES[name], tshape) == \
            janalysis.model_flops(jc, JAX_SHAPES[name], jshape)


def test_moe_active_params_are_fewer_than_total():
    tc = get_config("qwen3-moe-30b-a3b")
    counts = analysis.count_params(api.param_shapes(tc), _frac(tc))
    assert counts["active"] < 0.2 * counts["total"]


# ------------------------------------------------------------- analyse --
def test_analyse_is_the_reference_formula_with_the_h100_constants(
        monkeypatch):
    cost = op_cost.Cost(flops=1.2e15, bytes=2.9e12,
                        coll={k: 0.0 for k in op_cost.COLLECTIVE_KINDS})
    cost.coll["all-reduce"] = 2.5e12
    got = analysis.analyse(cost, 4, 1.1e16)
    monkeypatch.setattr(janalysis, "PEAK_FLOPS_BF16", analysis.PEAK_FLOPS_BF16)
    monkeypatch.setattr(janalysis, "HBM_BW", analysis.HBM_BW)
    monkeypatch.setattr(janalysis, "ICI_BW", analysis.LINK_BW)
    ref_cost = hlo_cost.Cost(cost.flops, cost.bytes, dict(cost.coll))
    monkeypatch.setattr(hlo_cost, "analyse_hlo", lambda text: ref_cost)

    class Compiled:
        def as_text(self):
            return ""

    want = janalysis.analyse(Compiled(), 4, 1.1e16)
    assert got.as_dict() == want.as_dict()
    assert got.dominant == want.dominant == "collective"
    assert got.bound_s == max(got.compute_s, got.memory_s, got.collective_s)
    # one card: no collective bytes, whatever the kinds
    assert analysis.collective_bytes(op_cost.Cost()) == {
        k: 0 for k in op_cost.COLLECTIVE_KINDS}


def test_h100_constants():
    assert analysis.PEAK_FLOPS_BF16 == 989e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.LINK_BW == 450e9


# ----------------------------------------------- op_cost: hlo_cost's rules --
def _hlo(fn, *specs, elementwise=True, **jit_kw):
    text = jax.jit(fn, **jit_kw).lower(*specs).compile().as_text()
    if elementwise:
        return hlo_cost.analyse_hlo(text)
    saved = hlo_cost._ELEMENTWISE_FLOP_OPS
    hlo_cost._ELEMENTWISE_FLOP_OPS = frozenset()
    try:
        return hlo_cost.analyse_hlo(text)
    finally:
        hlo_cost._ELEMENTWISE_FLOP_OPS = saved


def _f32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _meta(*shape, grad=False):
    return torch.empty(shape, **META).requires_grad_(grad)


M, K, N = 128, 256, 512


def test_matmul_flops_and_bytes():
    c = op_cost.analyse_step(lambda x, w: torch.tanh(x @ w),
                             _meta(M, K), _meta(K, N))
    assert c.dot_flops == 2 * M * K * N
    assert c.flops == 2 * M * K * N + M * N            # + one tanh each
    # the mm reads x and w and writes its result; tanh reads and writes it
    assert c.bytes == 4 * (M * K + K * N + M * N) + 2 * 4 * M * N
    # hlo_cost counts the same flops (a fused elementwise op adds one)
    ref = _hlo(lambda x, w: jnp.tanh(x @ w), _f32(M, K), _f32(K, N))
    assert c.flops == pytest.approx(ref.flops, abs=2)


def test_loop_over_stacked_weights_counts_every_trip():
    L = 10

    def port(x, w):
        h = x
        for wi in w.unbind(0):               # a layer's slice: a view
            h = torch.tanh(h @ wi)
        return h

    def ref(x, w):
        return lax.scan(lambda h, wi: (jnp.tanh(h @ wi), None), x, w)[0]

    c = op_cost.analyse_step(port, _meta(M, K), _meta(L, K, K))
    r = _hlo(ref, _f32(M, K), _f32(L, K, K))
    assert c.dot_flops == L * 2 * M * K * K
    assert c.flops == pytest.approx(r.flops, rel=1e-6)
    # each trip reads its layer's slice of the stack: the stack once
    act = 4 * M * K
    assert c.bytes == 4 * L * K * K + L * (act + act) + L * 2 * act


def test_slice_write_counts_the_slice_not_the_buffer():
    rows, D = 4096, 1024

    def write(buf, val):
        buf[5:6] = val
        return buf

    c = op_cost.analyse_step(write, _meta(rows, D), _meta(1, D))
    assert c.bytes == 2 * 4 * D                 # read the update, write it
    r = _hlo(lambda b, v: lax.dynamic_update_slice(b, v, (5, 0)),
             _f32(rows, D), _f32(1, D), donate_argnums=(0,))
    assert c.bytes == r.bytes

    def put(buf, val, idx):
        buf[idx] = val
        return buf

    idx = torch.empty((3,), dtype=torch.int64, **META)
    c = op_cost.analyse_step(put, _meta(rows, D), _meta(3, D), idx)
    assert c.bytes == 2 * 4 * 3 * D + 8 * 3     # update twice, the index


def test_checkpointed_block_counts_its_recomputation():
    L = 3

    def block(h, a, b):
        return torch.tanh(h @ a) @ b

    def step(x, w, w2, g, remat):
        h = x
        for a, b in zip(w.unbind(0), w2.unbind(0)):
            h = (checkpoint(block, h, a, b, use_reentrant=False) if remat
                 else block(h, a, b))
        y = (h * g).sum()
        return y, torch.autograd.grad(y, [w, w2])

    args = (_meta(M, K), _meta(L, K, N, grad=True), _meta(L, N, K, grad=True),
            _meta(M, K))
    plain = op_cost.analyse_step(step, *args, False)
    remat = op_cost.analyse_step(step, *args, True)
    # forward 2 products a layer, backward dW, dW2, dh and dx (not for the
    # first layer's input); the recomputation runs until the saved tensors
    # of the backward are back: one product and one tanh a layer
    assert plain.dot_flops == 2 * M * K * N * (2 * L + 4 * L - 1)
    assert remat.dot_flops - plain.dot_flops == L * 2 * M * K * N
    assert remat.flops - plain.flops == L * (2 * M * K * N + M * N)

    # XLA's remat of the same scan is counted too
    def ref(w, w2, x, g, remat):
        def body(h, ws):
            f = jax.checkpoint(lambda h, a, b: jnp.tanh(h @ a) @ b) if remat \
                else (lambda h, a, b: jnp.tanh(h @ a) @ b)
            return f(h, *ws), None
        return (lax.scan(body, x, (w, w2))[0] * g).sum()

    specs = (_f32(L, K, N), _f32(L, N, K), _f32(M, K), _f32(M, K))
    r_plain = _hlo(jax.value_and_grad(lambda *a: ref(*a, False), (0, 1)),
                   *specs, elementwise=False)
    r_remat = _hlo(jax.value_and_grad(lambda *a: ref(*a, True), (0, 1)),
                   *specs, elementwise=False)
    # (XLA's scan backward also forms the first layer's dx, which the
    # port's unrolled loop skips) ...
    assert r_plain.flops == pytest.approx(plain.dot_flops + 2 * M * K * N,
                                          rel=1e-6)
    # ... and recomputes the same one product a layer
    assert r_remat.flops - r_plain.flops == pytest.approx(
        remat.dot_flops - plain.dot_flops, rel=1e-6)


def test_peak_temp_bytes_follow_the_live_storages():
    def fn(x):
        a = x * 2                      # 4 KB live
        b = a + 1                      # 8 KB live
        del a                          # 4 KB
        c = b.view(-1)                 # a view: nothing new
        return c * 3                   # 8 KB live at the peak

    c = op_cost.analyse_step(fn, _meta(32, 32))
    assert c.peak_temp_bytes == 2 * 4 * 32 * 32
    assert c.output_bytes == 4 * 32 * 32
    assert c.ops == 3


# ---------------------------------------------- whole steps vs analyse_hlo --
def test_bge_forward_flops_agree_with_the_reference():
    """Bidirectional attention over full rows: every pair is valid, so the
    port's product and kernel flops match the reference's products."""
    jc, tc = jax_get_config("bge-large-zh-v1.5").smoke(), \
        get_config("bge-large-zh-v1.5").smoke()
    B, S = 2, 24
    key = jax.random.PRNGKey(0)
    jps = jax.eval_shape(lambda: japi.init_params(key, jc, jnp.float32))
    ref = _hlo(lambda p, t: jembedder.embed(p, jc, t,
                                            compute_dtype=jnp.float32),
               jps, jax.ShapeDtypeStruct((B, S), jnp.int32),
               elementwise=False)
    c = op_cost.analyse_step(
        lambda p, t: embedder.embed(p, tc, t, compute_dtype=torch.float32),
        api.param_shapes(tc), torch.empty((B, S), dtype=torch.int32, **META))
    assert c.kernel_calls == {"flash_attention": tc.num_layers,
                              "pool_norm": 1}
    assert c.dot_flops + c.kernel_flops == pytest.approx(ref.flops, rel=0.01)


def test_causal_lm_train_step_flops_agree_with_the_reference():
    """stablelm-1.6b's smoke train step (B 2 x S 32, every layer remat'd).
    The reference's jnp attention computes every (query, key) product, the
    masked ones too, 16 hd flops a pair a head (forward 4, recomputed
    forward 4, backward 8); the port's kernels count the valid pairs only.
    So the masked products are taken off the reference's count.  What is
    left differs by the port's kernels' own work: the backward kernel
    recomputes q k^T (2 hd a valid pair a head) and the RMSNorm kernels'
    elementwise flops, which the reference's elementwise norm has and this
    comparison leaves out."""
    arch, B, S = "stablelm-1.6b", 2, 32
    jc, tc = jax_get_config(arch).smoke(), get_config(arch).smoke()
    key = jax.random.PRNGKey(0)
    jps = jax.eval_shape(lambda: japi.init_params(key, jc, jnp.float32))
    jshape = JShape("smoke", S, B, "train")
    mesh = make_host_mesh()
    with mesh_context(mesh):
        ref = _hlo(jbuild_train(jc, jshape, mesh), jps,
                   jax.eval_shape(joptim.init, jps),
                   jinput_specs(jc, jshape), elementwise=False)
    shape = ShapeConfig("smoke", S, B, "train")
    ps = api.param_shapes(tc)
    c = op_cost.analyse_step(build_train_step(tc, shape), ps, optim.init(ps),
                             inputs.input_specs(tc, shape))
    H, hd, L = tc.num_heads, tc.resolved_head_dim, tc.num_layers
    valid, _, _ = kernel_cost.attention_pairs(S, S, True, 0)
    masked = B * (S * S - valid)
    ref_valid = ref.flops - 16 * hd * H * L * masked
    port = c.dot_flops + c.kernel_flops
    assert port == pytest.approx(ref_valid, rel=0.01)
    rms = sum(kernel_cost.rmsnorm(B * S, tc.d_model, 4)[0]
              for _ in range(c.kernel_calls["rmsnorm"])) \
        + sum(kernel_cost.rmsnorm_bwd(B * S, tc.d_model, 4)[0]
              for _ in range(c.kernel_calls["rmsnorm_bwd"]))
    assert port == pytest.approx(
        ref_valid + 2 * hd * H * L * B * valid + rms, rel=1e-9)


# ------------------------------------------------------------ kernel_cost --
def _bound_ms(flops, nbytes, rate):
    return max(nbytes / analysis.HBM_BW, flops / rate) * 1e3


def test_kernel_cost_reproduces_perf_bounds():
    # bge fp32 attention (B 16, 16 heads of 64, S 96, kv_len 96, 75, 0, 48
    # a row), on the bf16 tensor cores as six products: 0.005429 ms
    kv_len = torch.tensor([96, 75, 0, 48] * 4)
    mask = attention_mask(16, 96, 96, causal=False, window=0, kv_len=kv_len,
                          device="cpu")
    flops, nbytes = kernel_cost.flash_attention(
        16, 16, 16, 96, 96, 64, 4, int(mask.sum()), int(mask.any(-1).sum()),
        int(mask.any(-2).sum()))
    assert round(_bound_ms(6 * flops, nbytes, analysis.PEAK_FLOPS_BF16),
                 6) == 0.005429
    # quantize_rows over bge's 1536 rows of K 1024, fp32: 0.002349 ms
    assert round(_bound_ms(*kernel_cost.quantize_rows(1536, 1024, 4),
                           analysis.PEAK_FLOPS_FP32), 6) == 0.002349
    # rmsnorm, hymba's prefill rows (16 x 64 of d 1600) in bf16: 0.001958
    assert round(_bound_ms(*kernel_cost.rmsnorm(1024, 1600, 2),
                           analysis.PEAK_FLOPS_FP32), 6) == 0.001958


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (96, 96, False, 0), (64, 64, True, 0), (130, 130, True, 48),
    (1100, 1100, True, 1024), (64, 1500, False, 0), (40, 17, True, 0),
    (70, 70, False, 16)])
def test_attention_pairs_count_the_kernels_mask(Sq, Sk, causal, window):
    mask = attention_mask(1, Sq, Sk, causal=causal, window=window,
                          kv_len=None, device="cpu")[0]
    assert kernel_cost.attention_pairs(Sq, Sk, causal, window) == (
        int(mask.sum()), int(mask.any(-1).sum()), int(mask.any(-2).sum()))


@pytest.mark.parametrize("Sc,pos,window", [(80, 64, 1024), (80, 79, 0),
                                           (1024, 1100, 1024), (16, -1, 0),
                                           (4096, 5000, 1000)])
def test_decode_slots_count_a_ring_filled_in_order(Sc, pos, window):
    from repro_torch.kernels.flash_decode.ref import slot_mask

    kpos = torch.full((Sc,), -1, dtype=torch.int64)
    p = np.arange(max(0, pos - Sc + 1), pos + 1)
    kpos[torch.from_numpy(p % Sc)] = torch.from_numpy(p)
    assert kernel_cost.decode_slots(Sc, pos, window) == \
        int(slot_mask(kpos, pos, window).sum())
