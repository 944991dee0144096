"""Decoder language model in PyTorch: the reference's ``models/lm.py`` on
its default per-layer path, for the dense-attention (stablelm-1.6b,
internlm2-20b; starcoder2-7b with layernorm, GELU and a 4096-token
window), MoE (granite-moe-3b-a800m, qwen3-moe-30b-a3b), mamba
(falcon-mamba-7b) and hybrid (hymba-1.5b) blocks, and the VLM internvl2-2b,
whose stub patch embeddings ``prefill`` takes as ``extra_embed``.

* ``init_lm``     -- seeded params, ``blocks`` leaves stacked on a leading
                     layer dim, as in the reference tree;
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
its load-balance loss dropped, as in the reference.  The reference's
``decode_fori`` and ``decode_shard_map`` flags are XLA layouts of the same
computation and are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.embedder import layer_params, params_from_numpy

Params = Dict[str, Any]

__all__ = ["init_lm", "init_cache", "prefill", "decode_step", "cache_len",
           "params_from_numpy"]


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
    if extra_embed is not None:          # VLM: prepend stub patch embeddings
        h = torch.cat([extra_embed.to(h.dtype), h], dim=1)
    positions = torch.arange(pos_offset, pos_offset + h.shape[1],
                             dtype=torch.int32, device=tokens.device)
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


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Empty decode cache sized for a context of ``seq_len`` tokens."""
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


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extra_embed: Optional[torch.Tensor] = None, *,
            cache_dtype=torch.bfloat16, max_len: Optional[int] = None,
            compute_dtype=None) -> Tuple[torch.Tensor, Params]:
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
    activation dtype (None: ``layers.COMPUTE_DTYPE``, bf16)."""
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
    return _unembed(params, cfg, h[:, -1:])[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, *, compute_dtype=None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  token: (B,) ints at position ``cache["pos"]``.
    Returns (logits (B, V) in the compute dtype, the cache with this token
    written into it in place and ``pos`` advanced)."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    pos = cache["pos"]
    h, _ = _embed(params, cfg, token[:, None], pos, cdt)
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
