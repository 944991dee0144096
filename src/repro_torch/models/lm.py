"""Decoder language model in PyTorch: the reference's ``models/lm.py`` on
its default per-layer path, for the dense-attention (stablelm-1.6b,
internlm2-20b; starcoder2-7b with layernorm, GELU and a 4096-token
window), MoE (granite-moe-3b-a800m, qwen3-moe-30b-a3b), mamba
(falcon-mamba-7b) and hybrid (hymba-1.5b) blocks, and the VLM internvl2-2b,
whose stub patch embeddings ``prefill`` takes as ``extra_embed``.

* ``init_lm``     -- seeded params, ``blocks`` leaves stacked on a leading
                     layer dim, as in the reference tree;
* ``forward``     -- the training path: every position's logits (or the
                     final-normed hidden states) and the MoE load-balance
                     loss, each layer optionally rematerialised in the
                     backward (``torch.utils.checkpoint``); ``head_weights``
                     is the unembedding the chunked loss multiplies by;
* ``prefill``     -- the prompt's last-position logits and the decode cache;
* ``decode_step`` -- one token against the cache.

Params and caches are the reference's nested dicts (``params_from_numpy``
carries a reference tree over).  A cache holds ``k``/``v`` (L, B, Sc, KV,
hd) with a slot-position array ``kpos`` (a ring buffer under a sliding
window), ``ssm`` (L, B, DI, N) fp32 and ``conv`` (L, B, CK-1, DI) states,
and ``pos``, the next position, as a Python int: a decode step needs no
device-to-host copy.  ``decode_step`` writes the new token's state into the
cache's tensors in place (the reference returns new arrays) and returns the
cache with ``pos`` advanced.

An MoE block's FFN is ``layers.apply_moe`` in prefill and decode alike,
its load-balance loss dropped there and summed over the layers in
``forward``, as in the reference.  The reference's
``decode_fori`` flag is an XLA layout of the same computation and is not
ported.

Under ``decode_shard_map`` a cache can be laid out over a mesh: with
``shard_ctx=(mesh, batch axes, seq axes)`` (``steps/serve.py`` builds it),
``init_cache`` and ``prefill`` place ``k``, ``v`` and ``kpos`` through
``parallel.sharding.shard`` under the reference's ``cache_pspecs`` entries
(the sequence over the seq axes; ``ssm``, ``conv`` and ``pos`` stay on
the home device), and ``decode_step(shard_ctx=)`` attends the shards with
``layers.attn_decode_sharded``; the tree and the batch stay whole on the
home device.  A tree placed over a mesh (weights over ``model``, the batch
over ``data``) runs on the mesh's positions: ``models.tp``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import perf_flags
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.embedder import layer_params, params_from_numpy
from repro_torch.parallel import sharding

Params = Dict[str, Any]

__all__ = ["init_lm", "forward", "head_weights", "init_cache", "prefill",
           "decode_step", "cache_len", "shard_cache", "unshard_cache",
           "params_from_numpy"]

# the products "dots" keeps for the backward: the weight matmuls' outputs
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable) -> Callable:
    """``fn`` rematerialised in the backward under the ``remat_policy``
    flag: "full" (baseline) keeps only its inputs, "dots" also keeps its
    matmul outputs (``torch.utils.checkpoint``'s selective policy)."""
    policy = perf_flags.FLAGS.remat_policy
    if policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {policy!r}: want 'full' or 'dots'")

    def run(*args):
        if policy == "dots":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=lambda: (
                                  create_selective_checkpoint_contexts(
                                      _save_dots)))
        return checkpoint(fn, *args, use_reentrant=False)

    return run


def layer_views(blocks: Params, n: int) -> list:
    """The ``n`` layers' slices of the stacked ``blocks`` tree, each leaf
    ``unbind`` along the layer dim: under autograd the layers' gradients
    are stacked into the leaf once, where ``layer_params``' indexing would
    add a zero-padded copy of the whole leaf for every layer."""
    if n == 0:
        return []
    per_leaf = {k: (layer_views(v, n) if isinstance(v, dict)
                    else torch.unbind(v, 0))
                for k, v in blocks.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def init_lm(cfg: ModelConfig, generator: torch.Generator, device="cuda",
            dtype=torch.float32) -> Params:
    """Random LM params of ``dtype`` on ``device``, drawn from
    ``generator`` on its own device one layer at a time: the reference's
    layout and initialisers (dense N(0, 1/fan_in), embedding N(0, 0.02^2),
    mamba's A_log = log(1..N), dt_bias = softplus^-1(1), D = 1), with
    torch's random numbers."""
    lead = (cfg.num_layers,)
    blocks: Params = {"norm1": L.init_norm(cfg, lead, dtype, device)}
    if cfg.has_attention:
        blocks["attn"] = L.init_attention(generator, cfg, lead, dtype, device)
    if cfg.has_ssm:
        blocks["mamba"] = L.init_mamba(generator, cfg, lead, dtype, device)
    if cfg.d_ff:
        blocks["norm2"] = L.init_norm(cfg, lead, dtype, device)
        blocks["ffn"] = (L.init_moe if cfg.is_moe else L.init_mlp)(
            generator, cfg, lead, dtype, device)
    p = {"embed": L.dense_init(generator, (cfg.vocab_size, cfg.d_model), (),
                               dtype, device, scale=0.02),
         "blocks": blocks,
         "final_norm": L.init_norm(cfg, (), dtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                    (), dtype, device)
    return p


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           pos_offset: int, compute_dtype,
           extra_embed: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = params["embed"][tokens.long()].to(compute_dtype)
    return add_positions(cfg, h, pos_offset, extra_embed)


def add_positions(cfg: ModelConfig, h: torch.Tensor, pos_offset: int,
                  extra_embed: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings h (B, S, D) -> (h with a VLM's patch embeddings
    prepended and, for a family without rotary positions, the sinusoids
    added; the (S,) int32 positions from ``pos_offset``)."""
    if extra_embed is not None:          # VLM: prepend stub patch embeddings
        h = torch.cat([extra_embed.to(h.dtype), h], dim=1)
    positions = torch.arange(pos_offset, pos_offset + h.shape[1],
                             dtype=torch.int32, device=h.device)
    if not cfg.rope_theta:               # learned/absolute-position families
        h = h + L.sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    return h, positions


def _unembed(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(params["final_norm"], cfg, h)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head.to(h.dtype)


def _mlp(bp: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if not cfg.d_ff:
        return h
    hin = L.apply_norm(bp["norm2"], cfg, h)
    if cfg.is_moe:
        return h + L.apply_moe(bp["ffn"], cfg, hin)[0]
    return h + L.apply_mlp(bp["ffn"], cfg, hin)


def _mix(cfg: ModelConfig, h, a, m) -> torch.Tensor:
    if cfg.block == "attn":
        return h + a
    if cfg.block == "mamba":
        return h + m
    return h + 0.5 * (a + m)             # hybrid: parallel heads, averaged


def _block_forward(bp: Params, cfg: ModelConfig, h: torch.Tensor,
                   positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer over the full sequence: (h, the MoE load-balance loss, 0
    for a dense block), the reference's ``_block_forward``."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    hin = L.apply_norm(bp["norm1"], cfg, h)
    a = m = None
    if cfg.has_attention:
        a = L.attn_forward(bp["attn"], cfg, hin, positions)
    if cfg.has_ssm:
        m = L.mamba_forward(bp["mamba"], cfg, hin)
    h = _mix(cfg, h, a, m)
    if cfg.d_ff:
        hin = L.apply_norm(bp["norm2"], cfg, h)
        if cfg.is_moe:
            y, aux = L.apply_moe(bp["ffn"], cfg, hin)
        else:
            y = L.apply_mlp(bp["ffn"], cfg, hin)
        h = h + y
    return h, aux


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extra_embed: Optional[torch.Tensor] = None, remat: bool = False,
            return_hidden: bool = False, constrain: Callable = lambda x: x,
            compute_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward.  tokens: (B, S_text) -> (logits (B, S, V) in
    the compute dtype, the MoE load-balance loss summed over the layers,
    fp32).  ``extra_embed`` (B, P, D), a VLM's patch embeddings, is
    prepended (S = P + S_text).

    ``remat`` runs every layer under ``_remat`` (the ``remat_policy``
    flag).  ``return_hidden`` returns the final-normed hidden states (B, S,
    D) instead of the logits (the chunked loss forms logits a chunk at a
    time).  ``constrain`` is the reference's layout hint for the residual
    stream, applied after each layer (the identity here, as
    ``parallel.sharding.hidden_constraint`` returns it).
    ``compute_dtype``: None is ``layers.COMPUTE_DTYPE``, bf16."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    h, positions = _embed(params, cfg, tokens, 0, cdt, extra_embed)

    def body(hh, bp):
        hh, aux = _block_forward(bp, cfg, hh, positions)
        return constrain(hh), aux

    step = _remat(body) if remat else body
    auxs = []
    for bp in layer_views(params["blocks"], cfg.num_layers):
        h, aux = step(h, bp)
        auxs.append(aux)
    aux = (torch.stack(auxs).sum() if auxs
           else torch.zeros((), dtype=torch.float32, device=h.device))
    if return_hidden:
        return L.apply_norm(params["final_norm"], cfg, h), aux
    return _unembed(params, cfg, h), aux


def head_weights(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The unembedding (D, V): the embedding's transpose when tied."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda", shard_ctx=None) -> Params:
    """Empty decode cache sized for a context of ``seq_len`` tokens, laid
    out over ``shard_ctx``'s mesh when one is given (``shard_cache``)."""
    if shard_ctx is not None:
        return shard_cache(init_cache(cfg, batch, seq_len, dtype, device),
                           shard_ctx)
    Lc, hd = cfg.num_layers, cfg.resolved_head_dim
    cache: Params = {"pos": 0}
    if cfg.has_attention:
        Sc = cache_len(cfg, seq_len)
        for name in ("k", "v"):
            cache[name] = torch.zeros((Lc, batch, Sc, cfg.num_kv_heads, hd),
                                      dtype=dtype, device=device)
        cache["kpos"] = torch.full((Sc,), -1, dtype=torch.int32, device=device)
    if cfg.has_ssm:
        cache["ssm"] = torch.zeros((Lc, batch, cfg.d_inner, cfg.ssm_state),
                                   dtype=torch.float32, device=device)
        cache["conv"] = torch.zeros((Lc, batch, cfg.ssm_conv - 1, cfg.d_inner),
                                    dtype=dtype, device=device)
    return cache


def shard_cache(cache: Params, shard_ctx) -> Params:
    """The cache with ``k``, ``v`` and ``kpos`` placed over the mesh of
    ``shard_ctx = (mesh, b, seq_axes)`` under the reference's
    ``cache_pspecs`` entries for them: (None, b, seq, None, None) and
    (seq,), an entry dropped where its axes do not divide the dim.  The
    rest stays where it is."""
    mesh, b, seq_axes = shard_ctx
    seq = seq_axes if len(seq_axes) > 1 else seq_axes[0]
    out = dict(cache)
    if "k" in cache:
        for name in ("k", "v"):
            out[name] = sharding.shard(cache[name], sharding._fit(
                mesh, cache[name].shape, (None, b, seq, None, None)), mesh)
        out["kpos"] = sharding.shard(cache["kpos"], sharding._fit(
            mesh, cache["kpos"].shape, (seq,)), mesh)
    return out


def unshard_cache(cache: Params, device=None) -> Params:
    """A sharded cache as whole tensors, on ``device`` (default: the first
    mesh position's): every ``Sharded`` leaf (a decoder's ``k``, ``v``,
    ``kpos``, ``ssm``, ``conv``; whisper's ``cross_k``, ``cross_v`` too),
    ``pos`` as it is."""
    return {name: (sharding.unshard(t, device)
                   if isinstance(t, sharding.Sharded) else t)
            for name, t in cache.items()}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extra_embed: Optional[torch.Tensor] = None, *,
            cache_dtype=torch.bfloat16, max_len: Optional[int] = None,
            compute_dtype=None, shard_ctx=None) -> Tuple[torch.Tensor, Params]:
    """Process the prompt tokens (B, S_text); return (last-position logits
    (B, V) in the compute dtype, cache).

    ``extra_embed`` (B, P, D), a VLM's patch embeddings, is prepended to
    the token embeddings in the compute dtype: the prompt is then S = P +
    S_text positions long, and the cache and ``pos`` count the patches.

    ``max_len`` sizes the cache for the decode that follows (a windowed
    config clamps it to the window).  The cache keeps the prompt's last
    ``min(S, Sc)`` keys; slot i holds absolute position S - keep + i, and
    when a windowed ring is already full the slots are rotated so that
    decode's write to slot ``pos % Sc`` lines up.  ``compute_dtype`` is the
    activation dtype (None: ``layers.COMPUTE_DTYPE``, bf16).  With
    ``shard_ctx`` the cache comes back laid out over its mesh
    (``shard_cache``)."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    h, positions = _embed(params, cfg, tokens, 0, cdt, extra_embed)
    B, S = h.shape[:2]
    cache = init_cache(cfg, B, max(S, max_len or S), cache_dtype, tokens.device)
    if cfg.has_attention:
        Sc = cache["k"].shape[2]
        keep = min(S, Sc)
        roll = S % Sc if Sc == keep and cfg.sliding_window else 0
        kpos = torch.full((Sc,), -1, dtype=torch.int32, device=tokens.device)
        kpos[:keep] = positions[S - keep:]
        cache["kpos"] = torch.roll(kpos, roll) if roll else kpos
    blocks = params["blocks"]
    a = m = None
    for i in range(cfg.num_layers):
        bp = layer_params(blocks, i)
        hin = L.apply_norm(bp["norm1"], cfg, h)
        if cfg.has_attention:
            a, k, v = L.attn_forward(bp["attn"], cfg, hin, positions,
                                     return_kv=True)
            for name, t in (("k", k), ("v", v)):
                tail = t[:, S - keep:]
                cache[name][i, :, :keep] = (torch.roll(tail, roll, 1) if roll
                                            else tail)
        if cfg.has_ssm:
            m, cache["ssm"][i], cache["conv"][i] = L.mamba_prefill(
                bp["mamba"], cfg, hin)
        h = _mlp(bp, cfg, _mix(cfg, h, a, m))
    cache["pos"] = S
    if shard_ctx is not None:
        cache = shard_cache(cache, shard_ctx)
    return _unembed(params, cfg, h[:, -1:])[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, *, compute_dtype=None, shard_ctx=None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  token: (B,) ints at position ``cache["pos"]``.
    Returns (logits (B, V) in the compute dtype, the cache with this token
    written into it in place and ``pos`` advanced).

    With the ``decode_shard_map`` flag on and ``shard_ctx`` given (an
    attention config), the cache is the sharded layout of ``shard_cache``
    and each layer's attention runs over its sequence shards
    (``layers.attn_decode_sharded``); the reference's shard_map branch."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    pos = cache["pos"]
    h, _ = _embed(params, cfg, token[:, None], pos, cdt)
    if (perf_flags.FLAGS.decode_shard_map and shard_ctx is not None
            and cfg.has_attention):
        return _decode_sharded(params, cfg, h, cache, shard_ctx)
    if cfg.has_attention:
        # slot positions are layer-invariant: update them once
        cache["kpos"][L.cache_slot(cfg, pos, cache["k"].shape[2])] = pos
    blocks = params["blocks"]
    a = m = None
    for i in range(cfg.num_layers):
        bp = layer_params(blocks, i)
        hin = L.apply_norm(bp["norm1"], cfg, h)
        if cfg.has_attention:
            a = L.attn_decode(bp["attn"], cfg, hin, pos, cache["k"][i],
                              cache["v"][i], cache["kpos"])[0]
        if cfg.has_ssm:
            m, cache["ssm"][i], cache["conv"][i] = L.mamba_decode(
                bp["mamba"], cfg, hin, cache["ssm"][i], cache["conv"][i])
        h = _mlp(bp, cfg, _mix(cfg, h, a, m))
    return _unembed(params, cfg, h)[:, 0], {**cache, "pos": pos + 1}


def _decode_sharded(params: Params, cfg: ModelConfig, h: torch.Tensor,
                    cache: Params, shard_ctx) -> Tuple[torch.Tensor, Params]:
    """``decode_step``'s layers over a sequence-sharded cache: attention on
    the shards, a hybrid block's SSM state on the home device."""
    if not isinstance(cache["k"], sharding.Sharded):
        raise TypeError("decode_shard_map: the cache is not laid out over "
                        "the mesh; build it with shard_ctx "
                        "(init_cache, prefill or lm.shard_cache)")
    if len({i[1].start for i in cache["k"].index}) > 1:
        raise TypeError("decode_shard_map on a whole tree needs a cache "
                        "whose batch is whole; a batch over the data axes "
                        "runs on a tree placed over the mesh (models.tp)")
    pos = cache["pos"]
    ks, vs = cache["k"].along(2), cache["v"].along(2)
    kposs = cache["kpos"].along(0)
    # slot positions are layer-invariant: the owner shard's, once
    i, slot = L.shard_slot(cfg, pos, [t.shape[0] for t in kposs])
    kposs[i][slot] = pos
    blocks = params["blocks"]
    m = None
    for layer in range(cfg.num_layers):
        bp = layer_params(blocks, layer)
        hin = L.apply_norm(bp["norm1"], cfg, h)
        a = L.attn_decode_sharded(bp["attn"], cfg, hin, pos,
                                  [t[layer] for t in ks],
                                  [t[layer] for t in vs], kposs)[0]
        if cfg.has_ssm:
            m, cache["ssm"][layer], cache["conv"][layer] = L.mamba_decode(
                bp["mamba"], cfg, hin, cache["ssm"][layer],
                cache["conv"][layer])
        h = _mlp(bp, cfg, _mix(cfg, h, a, m))
    return _unembed(params, cfg, h)[:, 0], {**cache, "pos": pos + 1}
