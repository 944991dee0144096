"""The port's dry run (``repro_torch.launch.dryrun``) and the kernel
routers' meta branches, on the CPU.

- Records for production (arch, shape) pairs at published widths: the
  reference's record keys, one card (``"mesh": "1"``), argument bytes exact
  from the meta tensors, parameter counts and model flops equal to the
  reference's (``jax.eval_shape`` of its ``init_params``), and the kernel
  calls a step makes.  Skipped pairs carry the reference's reasons.
- The production meshes (16x16, 2x16x16 / ``--multi-pod``) raise
  ``NotImplementedError`` naming ROADMAP Queue 1 item 6, and the CLI
  records that error for every pair.
- Every kernel router on meta tensors: empty outputs of the plain
  version's shapes and dtypes, one call reported with its
  ``kernel_cost``, the launch counters untouched.

The reference's own ``launch/dryrun.py`` is never imported here: it sets a
512-device XLA host platform at import.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_shape as jax_get_shape  # noqa: E402
from repro.configs import shape_supported as jax_shape_supported  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.kernels.pool_norm import pool_norm  # noqa: E402
from repro_torch.kernels.quant_matmul import (quant_matmul,  # noqa: E402
                                              quantize_rows, w8a8_matmul)
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.roofline import kernel_cost, op_cost  # noqa: E402
from repro_torch.steps import inputs, optim  # noqa: E402
from repro_torch.steps.train import build_train_step  # noqa: E402

RECORD_KEYS = {"arch", "shape", "mesh", "lower_s", "memory", "roofline",
               "kernel_calls", "params_total", "params_active"}


def _reference_counts(arch, shape_name):
    jc = jax_get_config(arch)
    key = jax.random.PRNGKey(0)
    dtype = jnp.float32 if shape_name == "train_4k" else jnp.bfloat16
    ps = jax.eval_shape(lambda: japi.init_params(key, jc, dtype))
    frac = (jc.experts_per_token / jc.num_experts) if jc.is_moe else None
    return (janalysis.count_params(ps, frac),
            janalysis.model_flops(jc, jax_get_shape(shape_name), ps))


# --------------------------------------------------------------- records --
@pytest.mark.parametrize("arch,shape_name", [
    ("stablelm-1.6b", "decode_32k"), ("hymba-1.5b", "long_500k"),
    ("falcon-mamba-7b", "decode_32k"), ("whisper-tiny", "train_4k")])
def test_production_pairs_give_records(arch, shape_name):
    rec = dryrun.dry_run(arch, shape_name, verbose=False)
    assert RECORD_KEYS <= set(rec) and "skipped" not in rec
    assert rec["mesh"] == "1" and (rec["arch"], rec["shape"]) == (arch,
                                                                  shape_name)
    counts, mflops = _reference_counts(arch, shape_name)
    assert rec["params_total"] == counts["total"]
    assert rec["params_active"] == counts["active"]
    roof = rec["roofline"]
    assert roof["model_flops"] == mflops
    assert roof["coll_bytes"] == {k: 0 for k in op_cost.COLLECTIVE_KINDS}
    assert roof["collective_s"] == 0.0
    assert roof["dominant"] in ("compute", "memory")
    assert roof["flops"] > 0 and roof["bytes_accessed"] > 0
    # the arguments' bytes, exact from the meta tensors
    cfg = get_config(arch)
    _, args = dryrun.build_step(cfg, dryrun.get_shape(shape_name))
    assert rec["memory"]["argument_size_in_bytes"] == op_cost.tree_bytes(args)
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["memory"]["output_size_in_bytes"] > 0
    L = cfg.num_layers
    if shape_name == "train_4k":
        # whisper: the decoder's layers (self and cross attention) run
        # under remat, the encoder's do not, as in the reference
        enc = cfg.encoder_layers
        want = {"flash_attention": enc + 2 * 2 * L,
                "flash_attention_bwd": enc + 2 * L}
    else:
        want = ({"flash_decode": L} if cfg.has_attention else {})
        if cfg.norm == "rmsnorm":
            want["rmsnorm"] = 2 * L + 1 if cfg.d_ff else L + 1
    assert rec["kernel_calls"] == want


def test_decode_reads_a_full_cache():
    """The decode step is the one at position seq_len - 1: every slot of a
    cache without a window is valid, a windowed ring holds the window."""
    cfg = get_config("stablelm-1.6b")
    shape = dryrun.get_shape("decode_32k")
    step, args = dryrun.build_step(cfg, shape)
    assert args[1]["pos"] == shape.seq_len - 1
    c = op_cost.analyse_step(step, *args)
    B, L, hd = shape.global_batch, cfg.num_layers, cfg.resolved_head_dim
    KV, G = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    one = kernel_cost.flash_decode(B, KV, G, hd, shape.seq_len,
                                   shape.seq_len, 2, 2)
    assert c.kernel_calls["flash_decode"] == L
    rms = kernel_cost.rmsnorm(B, cfg.d_model, 2)
    assert c.kernel_flops == L * one[0] + (2 * L + 1) * rms[0]


def test_cache_f32_doubles_the_cache_bytes():
    bf16 = dryrun.dry_run("hymba-1.5b", "decode_32k", verbose=False)
    f32 = dryrun.dry_run("hymba-1.5b", "decode_32k", verbose=False,
                         opt="cache_f32=1")
    assert f32["opt"] == "cache_f32=1"
    cfg = get_config("hymba-1.5b")
    cache = dryrun.cache_specs(cfg, dryrun.get_shape("decode_32k"))
    kv = op_cost.tree_bytes({k: cache[k] for k in ("k", "v")})
    conv = op_cost.tree_bytes(cache["conv"])
    assert (f32["memory"]["argument_size_in_bytes"]
            - bf16["memory"]["argument_size_in_bytes"]) == kv + conv


@pytest.mark.parametrize("arch,shape_name", [
    ("bge-large-zh-v1.5", "decode_32k"), ("qwen2-72b", "long_500k"),
    ("internvl2-2b", "long_500k"), ("jina-v2", "long_500k")])
def test_skipped_pairs_carry_the_reference_reason(arch, shape_name):
    rec = dryrun.dry_run(arch, shape_name, verbose=False)
    ok, why = jax_shape_supported(jax_get_config(arch),
                                  jax_get_shape(shape_name))
    assert not ok and rec["skipped"] == why
    assert set(rec) == {"arch", "shape", "mesh", "skipped"}


def test_an_embedder_has_a_forward_and_no_train_step():
    rec = dryrun.dry_run("bge-large-zh-v1.5", "train_4k", verbose=False)
    assert rec["skipped"] == "encoder-only arch has no train step"
    cfg = get_config("bge-large-zh-v1.5")
    step, args = dryrun.build_step(cfg, dryrun.get_shape("prefill_32k"))
    c = op_cost.analyse_step(step, *args)
    assert c.kernel_calls == {"flash_attention": cfg.num_layers,
                              "pool_norm": 1}


@pytest.mark.parametrize("kw", [{"multi_pod": True}, {"mesh": "16x16"}],
                         ids=["multi_pod", "16x16"])
def test_production_meshes_raise_naming_item_6(kw):
    with pytest.raises(NotImplementedError, match="item 6"):
        dryrun.dry_run("stablelm-1.6b", "train_4k", verbose=False, **kw)


def test_cli_records_every_shape_and_each_mesh_error(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    dryrun.main(["--arch", "whisper-tiny", "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["shape"] for r in recs] == list(dryrun.INPUT_SHAPES)
    assert all("error" not in r for r in recs)
    assert [("skipped" in r) for r in recs] == [False, False, False, True]
    bad = tmp_path / "pod.jsonl"
    dryrun.main(["--arch", "whisper-tiny", "--multi-pod", "--out", str(bad)])
    recs = [json.loads(line) for line in bad.read_text().splitlines()]
    assert len(recs) == 4
    assert all(r["mesh"] == "2x16x16" and "NotImplementedError" in r["error"]
               and "item 6" in r["error"] for r in recs)
    capsys.readouterr()


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "hymba-1.5b",
                                  "granite-moe-3b-a800m", "whisper-tiny",
                                  "internvl2-2b"])
def test_train_step_on_meta_calls_each_kernel_as_the_card_launches(arch):
    """A remat'd train step, counted by hand.  A decoder-only model: each
    layer's attention, norms and scan forward twice (the forward and its
    recompute), backward once, the final norm once each way (internvl2's
    patches add no call).  whisper-tiny: the encoder is not rematerialised
    (L_e attention calls each way); each decoder layer's self and cross
    attention run forward twice and backward once, so L_e + 4 L_d forward
    and L_e + 2 L_d backward calls; layernorm, so no rmsnorm.  The card's
    train phase (chip_smoke.train_arch) takes its expected launches from
    this trace."""
    cfg = get_config(arch).smoke()
    shape = ShapeConfig("smoke", 32, 2, "train")
    ps = api.param_shapes(cfg)
    kernels.reset_launch_counts()
    c = op_cost.analyse_step(build_train_step(cfg, shape), ps,
                             optim.init(ps), inputs.input_specs(cfg, shape))
    L = cfg.num_layers
    if cfg.cross_attention:
        Le = cfg.encoder_layers
        want = {"flash_attention": Le + 4 * L,
                "flash_attention_bwd": Le + 2 * L}
    else:
        want = {"rmsnorm": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1}
        if cfg.has_attention:
            want.update(flash_attention=2 * L, flash_attention_bwd=L)
        if cfg.has_ssm:
            want.update(ssm_scan=2 * L, ssm_scan_bwd=L)
    assert c.kernel_calls == want
    assert not any(kernels.launch_counts().values())


# --------------------------------------------------- routers' meta branches --
def _f(dev, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(dev)


def _i8(dev, *shape):
    g = torch.Generator().manual_seed(1)
    return torch.randint(-127, 128, shape, generator=g,
                         dtype=torch.int8).to(dev)


def _attn(dev, grad):
    q, k, v = (_f(dev, 2, h, 8, 16, seed=i).requires_grad_(grad)
               for i, h in enumerate((4, 2, 2)))
    return q, k, v


def _kpos(dev):
    return torch.tensor([0, 1, 2, 3, 4, 5, 6, -1, -1, -1],
                        dtype=torch.int32).to(dev)


def _scan(dev, grad):
    x, dt = _f(dev, 2, 20, 8), _f(dev, 2, 20, 8, seed=1).abs()
    Bm, Cm = _f(dev, 2, 20, 16, seed=2), _f(dev, 2, 20, 16, seed=3)
    A = -_f(dev, 8, 16, seed=4).abs()
    return tuple(t.requires_grad_(grad) for t in (x, dt, Bm, Cm, A))


def _grad_of(fn):
    def run(*args):
        out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum(o.float().sum() for o in outs)
        return torch.autograd.grad(loss, [a for a in args
                                          if a.requires_grad])
    return run


# (name, call, inputs on a device, the calls reported with their costs)
ATTN_PAIRS = tuple(2 * n for n in kernel_cost.attention_pairs(8, 8, True, 0))
CASES = {
    "flash_attention": (
        lambda q, k, v: flash_attention(q, k, v, causal=True),
        lambda dev: _attn(dev, False),
        {"flash_attention": kernel_cost.flash_attention(
            2, 4, 2, 8, 8, 16, 4, *ATTN_PAIRS)}),
    "flash_attention_grad": (
        _grad_of(lambda q, k, v: flash_attention(q, k, v, causal=True)),
        lambda dev: _attn(dev, True),
        {"flash_attention": kernel_cost.flash_attention(
            2, 4, 2, 8, 8, 16, 4, *ATTN_PAIRS, lse=True),
         "flash_attention_bwd": kernel_cost.flash_attention_bwd(
             2, 4, 2, 8, 8, 16, 4, ATTN_PAIRS[0])}),
    "pool_norm_cls": (
        lambda h, m: pool_norm(h, m, "cls"),
        lambda dev: (_f(dev, 2, 8, 32), torch.ones(2, 8).to(dev)),
        {"pool_norm": kernel_cost.pool_norm(2, 8, 32, 4, "cls", 2)}),
    "pool_norm_mean": (
        lambda h, m: pool_norm(h, m, "mean"),
        lambda dev: (_f(dev, 2, 8, 32, dtype=torch.bfloat16),
                     torch.ones(2, 8).to(dev)),
        {"pool_norm": kernel_cost.pool_norm(2, 8, 32, 2, "mean", 16)}),
    "quant_matmul": (
        quant_matmul,
        lambda dev: (_f(dev, 2, 5, 32), _i8(dev, 32, 16),
                     _f(dev, 16).abs()),
        {"quant_matmul": kernel_cost.quant_matmul(10, 32, 16, 4)}),
    "quantize_rows": (
        quantize_rows, lambda dev: (_f(dev, 6, 32),),
        {"quantize_rows": kernel_cost.quantize_rows(6, 32, 4)}),
    "w8a8_matmul": (
        lambda x8, w8, xs, ws: w8a8_matmul(x8, w8, xs, ws,
                                           out_dtype=torch.bfloat16),
        lambda dev: (_i8(dev, 6, 32), _i8(dev, 32, 16), _f(dev, 6).abs(),
                     _f(dev, 16).abs()),
        {"w8a8_matmul": kernel_cost.w8a8_matmul(6, 32, 16, 2)}),
    "rmsnorm": (
        rmsnorm,
        lambda dev: (_f(dev, 2, 5, 32, dtype=torch.bfloat16),
                     _f(dev, 32).abs()),
        {"rmsnorm": kernel_cost.rmsnorm(10, 32, 2)}),
    "rmsnorm_grad": (
        _grad_of(rmsnorm),
        lambda dev: (_f(dev, 2, 5, 32).requires_grad_(),
                     _f(dev, 32).abs().requires_grad_()),
        {"rmsnorm": kernel_cost.rmsnorm(10, 32, 4),
         "rmsnorm_bwd": kernel_cost.rmsnorm_bwd(10, 32, 4)}),
    "flash_decode": (
        lambda q, k, v, kp: flash_decode(q, k, v, kp, 6),
        lambda dev: (_f(dev, 2, 2, 3, 16, dtype=torch.bfloat16),
                     _f(dev, 2, 10, 2, 16, seed=1),
                     _f(dev, 2, 10, 2, 16, seed=2), _kpos(dev)),
        {"flash_decode": kernel_cost.flash_decode(2, 2, 3, 16, 10, 7, 2, 4)}),
    "flash_decode_lse": (
        lambda q, k, v, kp: flash_decode(q, k, v, kp, 6, window=4, lse=True),
        lambda dev: (_f(dev, 2, 2, 3, 16), _f(dev, 2, 10, 2, 16, seed=1),
                     _f(dev, 2, 10, 2, 16, seed=2), _kpos(dev)),
        {"flash_decode": kernel_cost.flash_decode(2, 2, 3, 16, 10, 4, 4, 4,
                                                  lse=True)}),
    "ssm_scan": (
        ssm_scan, lambda dev: _scan(dev, False),
        {"ssm_scan": kernel_cost.ssm_scan(2, 20, 8, 16, 4)}),
    "ssm_scan_grad": (
        _grad_of(lambda *a: ssm_scan(*a)[0]), lambda dev: _scan(dev, True),
        {"ssm_scan": kernel_cost.ssm_scan(2, 20, 8, 16, 4, states=True),
         "ssm_scan_bwd": kernel_cost.ssm_scan_bwd(2, 20, 8, 16, 4, False)}),
}


def _meta_like(t):
    m = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                            device="meta")
    return m.requires_grad_(t.requires_grad)


@pytest.mark.parametrize("case", sorted(CASES))
def test_router_meta_branch_reports_the_kernel_cost(case):
    fn, make, want = CASES[case]
    cpu_out = fn(*make("cpu"))                  # the plain version
    kernels.reset_launch_counts()
    with op_cost.CostMode() as mode:
        meta_out = fn(*(_meta_like(t) for t in make("cpu")))
    flat = (lambda o: list(o) if isinstance(o, (tuple, list)) else [o])
    for got, ref in zip(flat(meta_out), flat(cpu_out)):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (ref.shape, ref.dtype)
    assert mode.cost.kernel_calls == {name: 1 for name in want}
    assert mode.cost.kernel_flops == sum(f for f, _ in want.values())
    assert mode.cost.kernel_bytes == sum(b for _, b in want.values())
    assert not any(kernels.launch_counts().values())


def test_meta_tensors_outside_a_cost_mode_report_to_nobody():
    q, k, v = (_meta_like(t) for t in _attn("cpu", False))
    out = flash_attention(q, k, v)
    assert out.shape == q.shape and out.device.type == "meta"
    assert not any(kernels.launch_counts().values())
    assert np.isclose(kernel_cost.decode_slots(10, 6, 0), 7)
