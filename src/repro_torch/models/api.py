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


def param_shapes(cfg: ModelConfig, dtype=torch.float32):
    """The param tree on the meta device: every leaf's shape and dtype, no
    memory and no random draws (the sharding rules read only shapes)."""
    return init_params(cfg, None, device="meta", dtype=dtype)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda"):
    model = encdec if cfg.cross_attention else lm
    return model.init_cache(cfg, batch, seq_len, dtype, device)
