"""Serving-step builders: prefill (prompt -> cache) and decode (one token),
the reference's ``steps/serve.py`` over an optional device mesh.

``build_prefill_step`` routes an encoder-decoder config to
``encdec.prefill`` on ``batch["frames"]`` and any other to ``lm.prefill``
on ``batch.get("patches")``; ``build_decode_step``'s step returns the
greedy next token and the cache.  ``compute_dtype`` is the activation
dtype (None: ``layers.COMPUTE_DTYPE``, bf16).

A mesh (``launch.mesh``) is taken as the reference takes it, for every
family, with the param tree placed over it by ``serve_shardings`` and
``parallel.sharding.shard_tree``: the steps then run each position on its
blocks, weights split over ``model`` and the batch over the data axes, in
one process (``models.tp``; whisper's encoder-decoder through
``tp.encdec_prefill`` / ``tp.encdec_decode_step``), and return whole
logits and tokens on the first position's device.  Their cache is laid
out over the mesh: a decoder's under the ``decode_shard_map`` flag has its
sequence split (the reference's flash-decode over ``shard_map``), else
its heads (and whisper's cross ``k``/``v``) are as the K/V projections
leave them.  A tree of whole tensors runs on the device it lies on; under
``decode_shard_map`` a decoder's cache's sequence is still laid out over
the mesh (``lm.shard_cache``, ``lm.decode_step(shard_ctx=)``).  The
reference's residual-stream layout hint (``sharding.hidden_constraint``)
is the identity here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import perf_flags
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, lm, tp
from repro_torch.parallel import sharding

def _shard_ctx(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """A whole tree's ``(mesh, batch axes, seq axes)`` for the flash-decode
    path (the batch whole on the home device), or None where it does not
    apply."""
    if (mesh is None or not perf_flags.FLAGS.decode_shard_map
            or cfg.cross_attention or not cfg.has_attention):
        return None
    big = shape.global_batch >= sharding._dp_size(mesh)
    seq_axes = ("model",) if big else sharding.dp_axes(mesh) + ("model",)
    return mesh, None, seq_axes


def _placed(mesh, params) -> bool:
    """Whether the step runs on the mesh's positions: a tree placed over
    ``mesh``."""
    return mesh is not None and sharding.is_placed(params)


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                       cache_dtype=torch.bfloat16,
                       max_len: Optional[int] = None, compute_dtype=None):
    """``prefill_step(params, batch) -> (last-position logits, cache)``;
    ``batch`` holds ``tokens`` and, per family, ``frames`` or
    ``patches``."""
    shard_ctx = _shard_ctx(cfg, shape, mesh)

    def prefill_step(params, batch):
        if _placed(mesh, params) and cfg.cross_attention:
            return tp.encdec_prefill(params, cfg, batch["tokens"],
                                     batch["frames"], mesh,
                                     cache_dtype=cache_dtype,
                                     max_len=max_len,
                                     compute_dtype=compute_dtype)
        if _placed(mesh, params):
            return tp.prefill(params, cfg, batch["tokens"], mesh,
                              extra_embed=batch.get("patches"),
                              cache_dtype=cache_dtype, max_len=max_len,
                              compute_dtype=compute_dtype,
                              seq_shard=perf_flags.FLAGS.decode_shard_map)
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
                      greedy: bool = True, compute_dtype=None,
                      return_logits: bool = False):
    """``serve_step(params, cache, batch) -> (next token (B,) int32,
    cache)`` for ``batch["token"]`` (B,); the cache is updated in place,
    as ``lm.decode_step`` and ``encdec.decode_step`` update it.  The next
    token is the argmax (``greedy`` is the reference's only mode too).
    ``return_logits`` appends the step's logits (B, V) to the result."""
    shard_ctx = _shard_ctx(cfg, shape, mesh)

    def serve_step(params, cache, batch):
        if _placed(mesh, params) and cfg.cross_attention:
            logits, cache = tp.encdec_decode_step(
                params, cfg, batch["token"], cache, mesh,
                compute_dtype=compute_dtype)
        elif _placed(mesh, params):
            logits, cache = tp.decode_step(params, cfg, batch["token"], cache,
                                           mesh, compute_dtype=compute_dtype)
        elif cfg.cross_attention:
            logits, cache = encdec.decode_step(params, cfg, batch["token"],
                                               cache,
                                               compute_dtype=compute_dtype)
        else:
            logits, cache = lm.decode_step(params, cfg, batch["token"], cache,
                                           compute_dtype=compute_dtype,
                                           shard_ctx=shard_ctx)
        tok = logits.argmax(-1).to(torch.int32)
        return (tok, cache, logits) if return_logits else (tok, cache)

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
