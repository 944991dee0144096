"""Model-family dispatch: one entry point per step kind regardless of arch."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedder, encdec, lm


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=torch.float32):
    if cfg.arch_type == "encoder":
        return embedder.init_embedder(cfg, generator, device, dtype)
    if cfg.cross_attention:
        return encdec.init_encdec(cfg, generator, device, dtype)
    return lm.init_lm(cfg, generator, device, dtype)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda"):
    model = encdec if cfg.cross_attention else lm
    return model.init_cache(cfg, batch, seq_len, dtype, device)
