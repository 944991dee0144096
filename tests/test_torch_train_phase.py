"""The train phase of ``chip_smoke.py`` and the batch stream it shares with
``launch/train.py``, on the CPU.

- ``steps/inputs.train_stream`` yields, for every assigned decoder family,
  batches with ``input_specs``' keys and shapes (the port's and the
  reference's), and the very arrays the reference's ``launch/train.py``
  draws from its ``TokenStream`` for the same (batch, seq, seed), bit for
  bit: moving that logic out of ``launch/train.py`` changed no batch.
- ``chip_smoke.train_arch`` (imported by path) at smoke size for the
  three families this slice trains on the card: its part (a), the fp32
  loss and gradients through the routers against the plain versions
  (loss within 1e-5 relative, every leaf at cosine >= 0.9999: on the CPU
  both sides are the plain versions), 20 finite losses, and the meta
  trace's kernel calls in its output, equal to a count by hand of what a
  remat'd step calls.  On the CPU no kernel launches.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data.workload import TokenStream as JTokenStream  # noqa: E402
from repro.data.workload import TrainBatchSpec as JSpec  # noqa: E402
from repro.steps.inputs import input_specs as jinput_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.steps import inputs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_FAMILIES = ("whisper-tiny", "internvl2-2b", "granite-moe-3b-a800m")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_stream(arch, batch, seq, seed):
    """The reference's launch/train.py stream, as it builds it."""
    cfg = jax_get_config(arch)
    extra = {}
    if cfg.frontend == "vision":
        extra["patches"] = (cfg.num_patches, cfg.d_model)
    if cfg.frontend == "audio":
        extra["frames"] = (cfg.num_frames, cfg.d_model)
    text = seq - cfg.num_patches if cfg.frontend == "vision" else seq
    return JTokenStream(JSpec(batch, text, cfg.vocab_size), seed=seed,
                        extra=extra)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_train_stream_has_the_specs_and_the_reference_batches(arch):
    B, S, seed = 2, 288, 5         # S above internvl2's 256 patches
    cfg = get_config(arch)
    shape = ShapeConfig("t", S, B, "train")
    specs = inputs.input_specs(cfg, shape)
    jspecs = jinput_specs(jax_get_config(arch), JShape("t", S, B, "train"))
    stream = inputs.train_stream(cfg, shape, seed)
    ref = _reference_stream(arch, B, S, seed)
    for _ in range(2):
        got, want = next(stream), next(ref)
        assert sorted(got) == sorted(specs) == sorted(jspecs)
        for k, v in got.items():
            assert v.shape == tuple(specs[k].shape) == tuple(jspecs[k].shape)
            assert v.dtype == (np.float32 if specs[k].dtype.is_floating_point
                               else np.int32)
            assert np.array_equal(v, want[k]), k
    stream.restore(1)
    ref.restore(1)
    assert all(np.array_equal(a, b) for a, b in
               zip(next(stream).values(), next(ref).values()))


def _hand_counts(cfg):
    """A remat'd train step's kernel calls, counted by hand: a
    decoder-only model's layers each call attention and two norms forward
    twice (the forward and its recompute) and backward once, the final
    norm once each way; whisper's encoder is not rematerialised (L_e
    attention calls each way), each decoder layer's self and cross
    attention run forward twice and backward once, and layernorm is plain
    ops."""
    L = cfg.num_layers
    if cfg.cross_attention:
        Le = cfg.encoder_layers
        return {"flash_attention": Le + 4 * L,
                "flash_attention_bwd": Le + 2 * L}
    return {"flash_attention": 2 * L, "flash_attention_bwd": L,
            "rmsnorm": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1}


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_train_arch_rehearses_on_the_cpu(arch):
    cs = _chip_smoke()
    out = cs.train_arch(torch.device("cpu"), arch)
    cfg = get_config(arch).smoke()
    a = out["fp32_kernels_vs_plain"]
    assert a["loss_rel"] <= cs.TRAIN_LOSS_REL
    assert a["min_grad_cosine"] >= cs.TRAIN_GRAD_COSINE
    assert len(out["losses"]) == cs.TRAIN_STEPS
    assert all(np.isfinite(out["losses"]))
    assert out["meta"]["kernel_calls"] == _hand_counts(cfg)
    assert out["meta"]["argument_bytes"] > 0
    assert out["meta"]["temp_bytes"] > 0
    assert out["launches"] == {}
    if cfg.is_moe:
        assert a["routes"] == cfg.num_layers * out["B"] * out["S"]
        assert a["routes_differ"] == 0
        assert a["dropped_share_kernels"] == a["dropped_share_plain"]
        assert 0 < a["dropped_share_kernels"] < 1
        assert len(out["moe_aux"]) == cs.TRAIN_STEPS
        assert all(x > 0 for x in out["moe_aux"])
    if cfg.frontend == "vision":
        assert out["text_tokens"] == out["S"] - cfg.num_patches
