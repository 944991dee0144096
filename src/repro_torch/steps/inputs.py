"""Stand-ins for every model input, the reference's ``steps/inputs.py``.

``input_specs(cfg, shape)`` returns the batch dict a step consumes as
tensors on the meta device: shapes and dtypes, no memory.  For the stubbed
modality frontends the specs are the stub: precomputed patch or frame
embeddings of the right shape.  ``cache_specs`` is the decode cache on the
meta device, ``make_batch`` a random batch matching the specs, and
``train_stream`` the zipf token stream a family's train step consumes.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.workload import TokenStream, TrainBatchSpec
from repro_torch.models import encdec, lm


def text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """VLM shapes budget ``seq_len`` across patches + text."""
    if cfg.frontend == "vision" and shape.kind != "decode":
        return shape.seq_len - cfg.num_patches
    return shape.seq_len


def input_specs(cfg: ModelConfig,
                shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    B = shape.global_batch
    S = text_len(cfg, shape)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    i32 = torch.int32
    if shape.kind == "train":
        batch = {"tokens": spec((B, S), i32), "labels": spec((B, S), i32)}
    elif shape.kind == "prefill":
        batch = {"tokens": spec((B, S), i32)}
    else:  # decode: ONE new token against a seq_len-deep cache
        batch = {"token": spec((B,), i32)}
    if cfg.frontend == "vision" and shape.kind != "decode":
        batch["patches"] = spec((B, cfg.num_patches, cfg.d_model),
                                torch.bfloat16)
    if cfg.frontend == "audio" and shape.kind != "decode":
        batch["frames"] = spec((B, cfg.num_frames, cfg.d_model),
                               torch.bfloat16)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                cache_dtype=torch.bfloat16) -> Any:
    """The decode cache on the meta device (no memory)."""
    assert shape.kind == "decode"
    model = encdec if cfg.cross_attention else lm
    return model.init_cache(cfg, shape.global_batch, shape.seq_len,
                            dtype=cache_dtype, device="meta")


def make_batch(cfg: ModelConfig, shape: ShapeConfig,
               generator: torch.Generator, device=None) -> Dict[str, Any]:
    """A random batch matching ``input_specs``: integer inputs uniform in
    the vocabulary, float ones standard normal (drawn in fp32, then cast),
    drawn from ``generator`` on its device and placed on ``device``
    (default: the generator's)."""
    gdev = generator.device
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if s.dtype.is_floating_point:
            t = torch.randn(s.shape, generator=generator, device=gdev,
                            dtype=torch.float32).to(s.dtype)
        else:
            t = torch.randint(0, cfg.vocab_size, s.shape, generator=generator,
                              device=gdev, dtype=s.dtype)
        out[name] = t.to(device or gdev)
    return out


def train_stream(cfg: ModelConfig, shape: ShapeConfig,
                 seed: int = 0) -> TokenStream:
    """The zipf ``TokenStream`` of a train ``shape``: ``text_len`` tokens
    and labels a row, plus the stubbed frontend's input, ``frames`` or
    ``patches`` (numpy fp32 standard normals), so each batch has
    ``input_specs``' keys and shapes."""
    extra = {}
    if cfg.frontend == "vision":
        extra["patches"] = (cfg.num_patches, cfg.d_model)
    if cfg.frontend == "audio":
        extra["frames"] = (cfg.num_frames, cfg.d_model)
    spec = TrainBatchSpec(shape.global_batch, text_len(cfg, shape),
                          cfg.vocab_size)
    return TokenStream(spec, seed=seed, extra=extra)
