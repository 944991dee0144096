"""Serving-step builders: prefill (prompt -> cache) and decode (one token),
the reference's ``steps/serve.py`` on one device.

``build_prefill_step`` routes an encoder-decoder config to
``encdec.prefill`` on ``batch["frames"]`` and any other to ``lm.prefill``
on ``batch.get("patches")``; ``build_decode_step``'s step returns the
greedy next token and the cache.  The reference lays the residual stream
out over a device mesh between layers (``sharding.hidden_constraint``);
on one card that layout is the identity, so the builders take no mesh: a
``mesh`` other than None raises ``NotImplementedError`` until multi-card
serving is ported (ROADMAP.md Queue 1 item 6), and so the reference's
``decode_shard_map`` layout and ``serve_shardings`` wait for it too.
``shape`` is taken for the reference's signature; one card reads nothing
from it.  ``compute_dtype`` is the activation dtype (None:
``layers.COMPUTE_DTYPE``, bf16).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, lm


def _one_card(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "serving over a device mesh is not ported yet; the builders "
            "run on one card (ROADMAP.md Queue 1 item 6, multi-card)")


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                       cache_dtype=torch.bfloat16,
                       max_len: Optional[int] = None, compute_dtype=None):
    """``prefill_step(params, batch) -> (last-position logits, cache)``;
    ``batch`` holds ``tokens`` and, per family, ``frames`` or
    ``patches``."""
    _one_card(mesh)

    def prefill_step(params, batch):
        if cfg.cross_attention:
            return encdec.prefill(params, cfg, batch["tokens"],
                                  batch["frames"], cache_dtype=cache_dtype,
                                  max_len=max_len,
                                  compute_dtype=compute_dtype)
        return lm.prefill(params, cfg, batch["tokens"],
                          extra_embed=batch.get("patches"),
                          cache_dtype=cache_dtype, max_len=max_len,
                          compute_dtype=compute_dtype)

    return prefill_step


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                      greedy: bool = True, compute_dtype=None):
    """``serve_step(params, cache, batch) -> (next token (B,) int32,
    cache)`` for ``batch["token"]`` (B,); the cache is updated in place,
    as ``lm.decode_step`` and ``encdec.decode_step`` update it.  The next
    token is the argmax (``greedy`` is the reference's only mode too)."""
    _one_card(mesh)
    model = encdec if cfg.cross_attention else lm

    def serve_step(params, cache, batch):
        logits, cache = model.decode_step(params, cfg, batch["token"], cache,
                                          compute_dtype=compute_dtype)
        return logits.argmax(-1).to(torch.int32), cache

    return serve_step
