"""Model-family dispatch: one entry point per step kind regardless of arch."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedder, lm

_ENCDEC = ("the encoder-decoder (cross attention) belongs to a later slice "
           "of the port (ROADMAP.md Queue 1)")


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=torch.float32):
    if cfg.arch_type == "encoder":
        return embedder.init_embedder(cfg, generator, device, dtype)
    if cfg.cross_attention:
        raise NotImplementedError(_ENCDEC)
    return lm.init_lm(cfg, generator, device, dtype)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda"):
    if cfg.cross_attention:
        raise NotImplementedError(_ENCDEC)
    return lm.init_cache(cfg, batch, seq_len, dtype, device)
