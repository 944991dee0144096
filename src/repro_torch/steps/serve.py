"""Serving-step builders: prefill (prompt -> cache) and decode (one token),
the reference's ``steps/serve.py`` over an optional device mesh.

``build_prefill_step`` routes an encoder-decoder config to
``encdec.prefill`` on ``batch["frames"]`` and any other to ``lm.prefill``
on ``batch.get("patches")``; ``build_decode_step``'s step returns the
greedy next token and the cache.  ``compute_dtype`` is the activation
dtype (None: ``layers.COMPUTE_DTYPE``, bf16).

A mesh (``launch.mesh``) is taken as the reference takes it.  With the
``decode_shard_map`` flag on, an attention decoder's cache is laid out
over the mesh's sequence axes: the prefill step returns it sharded
(``lm.shard_cache``) and the decode step attends the shards
(``lm.decode_step(shard_ctx=)``, the reference's flash-decode over
``shard_map``).  Without the flag, or with no mesh, the steps run on the
tensors where they lie.  The reference's residual-stream layout hint
(``sharding.hidden_constraint``) is the identity here.

Not ported: a mesh whose data axes hold more than one position (the batch
over ``data``), and weights split over the ``model`` axis, which
``serve_shardings`` specifies under ``serve_tp_only``.  The builders raise
``NotImplementedError`` for either; ``serve_shardings`` still returns the
reference's specs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import perf_flags
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, lm
from repro_torch.parallel import sharding

TP_ITEM = "ROADMAP.md Queue 1 item 6, tensor-parallel serving across cards"


def _check_mesh(mesh) -> None:
    """Refuse what the port does not execute on a mesh."""
    if mesh is None:
        return
    if sharding._dp_size(mesh) > 1:
        raise NotImplementedError(
            f"serving with the batch over the data axes of {mesh.shape} is "
            f"not ported ({TP_ITEM})")
    if perf_flags.FLAGS.serve_tp_only and mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"serve_tp_only places weights tensor-parallel over the model "
            f"axis of {mesh.shape}; executing that placement is not ported "
            f"({TP_ITEM})")


def _shard_ctx(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """The reference's ``(mesh, batch axes, seq axes)`` for the
    flash-decode path, or None where it does not apply."""
    if (mesh is None or not perf_flags.FLAGS.decode_shard_map
            or cfg.cross_attention or not cfg.has_attention):
        return None
    big = shape.global_batch >= sharding._dp_size(mesh)
    dp = sharding.dp_axes(mesh)
    dps = dp if len(dp) > 1 else (dp[0] if dp else None)
    b = dps if big else None
    seq_axes = ("model",) if big else tuple(dp) + ("model",)
    return mesh, b, seq_axes


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                       cache_dtype=torch.bfloat16,
                       max_len: Optional[int] = None, compute_dtype=None):
    """``prefill_step(params, batch) -> (last-position logits, cache)``;
    ``batch`` holds ``tokens`` and, per family, ``frames`` or
    ``patches``."""
    _check_mesh(mesh)
    shard_ctx = _shard_ctx(cfg, shape, mesh)

    def prefill_step(params, batch):
        if cfg.cross_attention:
            return encdec.prefill(params, cfg, batch["tokens"],
                                  batch["frames"], cache_dtype=cache_dtype,
                                  max_len=max_len,
                                  compute_dtype=compute_dtype)
        return lm.prefill(params, cfg, batch["tokens"],
                          extra_embed=batch.get("patches"),
                          cache_dtype=cache_dtype, max_len=max_len,
                          compute_dtype=compute_dtype, shard_ctx=shard_ctx)

    return prefill_step


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                      greedy: bool = True, compute_dtype=None):
    """``serve_step(params, cache, batch) -> (next token (B,) int32,
    cache)`` for ``batch["token"]`` (B,); the cache is updated in place,
    as ``lm.decode_step`` and ``encdec.decode_step`` update it.  The next
    token is the argmax (``greedy`` is the reference's only mode too)."""
    _check_mesh(mesh)
    shard_ctx = _shard_ctx(cfg, shape, mesh)

    def serve_step(params, cache, batch):
        if cfg.cross_attention:
            logits, cache = encdec.decode_step(params, cfg, batch["token"],
                                               cache,
                                               compute_dtype=compute_dtype)
        else:
            logits, cache = lm.decode_step(params, cfg, batch["token"], cache,
                                           compute_dtype=compute_dtype,
                                           shard_ctx=shard_ctx)
        return logits.argmax(-1).to(torch.int32), cache

    return serve_step


def serve_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    params_shape, cache_shape=None):
    """The reference's (param, [cache,] batch) shardings: trees of ``(mesh,
    spec)`` pairs, weights under the serve-mode rules when
    ``serve_tp_only`` is on, else the train-mode ones."""
    mode = "serve" if perf_flags.FLAGS.serve_tp_only else "train"
    psh = sharding.param_shardings(mesh, params_shape, mode)
    bsh = {k: (mesh, v)
           for k, v in sharding.batch_pspecs(cfg, shape, mesh).items()}
    if cache_shape is None:
        return psh, bsh
    csh = sharding.tree_map_with_path(
        lambda _, s: (mesh, s),
        sharding.cache_pspecs(cfg, shape, mesh, cache_shape))
    return psh, csh, bsh
