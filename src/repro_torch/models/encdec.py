"""Whisper-style encoder-decoder in PyTorch: the reference's
``models/encdec.py``.

The modality frontend (mel spectrogram + conv downsampler) is a stub: the
caller passes precomputed frame embeddings (B, F, d_model).  This module
runs the transformer encoder over those frames and the decoder (causal
self-attention, then cross attention to the encoder's states, then the
MLP) that consumes them:

* ``init_encdec``  -- seeded params: ``enc_blocks`` and ``dec_blocks``
                      stacked on a leading layer dim, as in the reference;
* ``encode``       -- the encoder states (B, F, D);
* ``forward``      -- logits of every position (B, S, V);
* ``prefill``      -- the prompt's last-position logits and the cache;
* ``decode_step``  -- one token against the cache.

Where the kernels run: the encoder's bidirectional attention over the F
frames, the decoder's causal self-attention and, in ``forward`` and
``prefill``, its cross attention (S queries over F keys) go through
``flash_attention``; a decode step's self-attention goes through
``flash_decode`` and its cross attention is ``layers.cross_decode``, plain
ops, as the reference computes it outside any kernel.

The cache holds the self-attention ``k``/``v`` (L, B, Sc, KV, hd) with the
slot positions ``kpos`` (Sc,), the encoder's ``cross_k``/``cross_v`` (L,
B, F, KV, hd), computed once in ``prefill``, and ``pos``, the next
position, as a Python int, as in ``models.lm``.  ``decode_step`` writes
the new token's k and v into the cache's tensors in place and returns the
cache with ``pos`` advanced.  On a tree placed over a ``(data, model)``
mesh the same steps run on the mesh's positions (``models.tp``'s
``encdec_prefill`` and ``encdec_decode_step``).  The encoder-decoder
configs have no sliding window and no RoPE (whisper's positions are
sinusoidal).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.embedder import layer_params
from repro_torch.models.lm import _remat, cache_len, layer_views

Params = Dict[str, Any]

__all__ = ["init_encdec", "encode", "forward", "init_cache", "prefill",
           "decode_step"]


def init_enc_block(g: torch.Generator, cfg: ModelConfig, lead: tuple, dtype,
                   device) -> Params:
    return {"norm1": L.init_norm(cfg, lead, dtype, device),
            "attn": L.init_attention(g, cfg, lead, dtype, device),
            "norm2": L.init_norm(cfg, lead, dtype, device),
            "ffn": L.init_mlp(g, cfg, lead, dtype, device)}


def init_dec_block(g: torch.Generator, cfg: ModelConfig, lead: tuple, dtype,
                   device) -> Params:
    return {"norm1": L.init_norm(cfg, lead, dtype, device),
            "attn": L.init_attention(g, cfg, lead, dtype, device),
            "norm_x": L.init_norm(cfg, lead, dtype, device),
            "xattn": L.init_attention(g, cfg, lead, dtype, device,
                                      cross=True),
            "norm2": L.init_norm(cfg, lead, dtype, device),
            "ffn": L.init_mlp(g, cfg, lead, dtype, device)}


def init_encdec(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=torch.float32) -> Params:
    """Random params of ``dtype`` on ``device``, drawn from ``generator``
    on its own device a layer at a time: the reference's layout and
    initialisers (dense N(0, 1/fan_in), embedding N(0, 0.02^2)), with
    torch's random numbers."""
    g = generator
    return {
        "embed": L.dense_init(g, (cfg.vocab_size, cfg.d_model), (), dtype,
                              device, scale=0.02),
        "enc_blocks": init_enc_block(g, cfg, (cfg.encoder_layers,), dtype,
                                     device),
        "enc_norm": L.init_norm(cfg, (), dtype, device),
        "dec_blocks": init_dec_block(g, cfg, (cfg.num_layers,), dtype,
                                     device),
        "dec_norm": L.init_norm(cfg, (), dtype, device),
        "lm_head": L.dense_init(g, (cfg.d_model, cfg.vocab_size), (), dtype,
                                device),
    }


def _arange(start: int, n: int, device) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           compute_dtype=None) -> torch.Tensor:
    """frames: (B, F, D) stub frame embeddings -> encoder states (B, F, D)
    in the compute dtype (None: ``layers.COMPUTE_DTYPE``, bf16)."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    positions = _arange(0, frames.shape[1], frames.device)
    h = frames.to(cdt)
    h = h + L.sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    # unbound layer views: under autograd (``forward``) their gradients
    # stack into the leaf once (``lm.layer_views``)
    for bp in layer_views(params["enc_blocks"], cfg.encoder_layers):
        hin = L.apply_norm(bp["norm1"], cfg, h)
        h = h + L.attn_forward(bp["attn"], cfg, hin, positions, causal=False)
        hin = L.apply_norm(bp["norm2"], cfg, h)
        h = h + L.apply_mlp(bp["ffn"], cfg, hin)
    return L.apply_norm(params["enc_norm"], cfg, h)


def _dec_embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               pos0: int, compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    h = params["embed"][tokens.long()].to(compute_dtype)
    positions = _arange(pos0, h.shape[1], tokens.device)
    h = h + L.sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    return h, positions


def _dec_layers(params: Params, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, enc: torch.Tensor,
                cache: Optional[Params] = None) -> torch.Tensor:
    """The decoder stack over the prompt h (B, S, D) and the encoder's
    states; with a ``cache``, each layer's self-attention k and v go into
    its first S slots and its cross k and v into ``cross_k``/``cross_v``,
    cast to the cache's dtype."""
    enc_pos = _arange(0, enc.shape[1], enc.device)
    S = h.shape[1]
    for i in range(cfg.num_layers):
        bp = layer_params(params["dec_blocks"], i)
        hin = L.apply_norm(bp["norm1"], cfg, h)
        a, k, v = L.attn_forward(bp["attn"], cfg, hin, positions,
                                 return_kv=True)
        h = h + a
        hin = L.apply_norm(bp["norm_x"], cfg, h)
        # cross k and v are position-free: the prompt's cross attention
        # computes them (a cross block has no bias), the cache keeps them
        a, xk, xv = L.attn_forward(bp["xattn"], cfg, hin, positions,
                                   causal=False, kv_x=enc,
                                   kv_positions=enc_pos, return_kv=True)
        h = h + a
        if cache is not None:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            cache["cross_k"][i] = xk
            cache["cross_v"][i] = xv
        hin = L.apply_norm(bp["norm2"], cfg, h)
        h = h + L.apply_mlp(bp["ffn"], cfg, hin)
    return h


def _dec_layer(bp: Params, cfg: ModelConfig, h: torch.Tensor,
               positions: torch.Tensor, enc: torch.Tensor,
               enc_pos: torch.Tensor) -> torch.Tensor:
    """One decoder layer of the training forward: causal self-attention,
    cross attention to the encoder's states, the MLP."""
    hin = L.apply_norm(bp["norm1"], cfg, h)
    h = h + L.attn_forward(bp["attn"], cfg, hin, positions)
    hin = L.apply_norm(bp["norm_x"], cfg, h)
    h = h + L.attn_forward(bp["xattn"], cfg, hin, positions, causal=False,
                           kv_x=enc, kv_positions=enc_pos)
    hin = L.apply_norm(bp["norm2"], cfg, h)
    return h + L.apply_mlp(bp["ffn"], cfg, hin)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor, remat: bool = False,
            return_hidden: bool = False, compute_dtype=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: logits of every position (B, S, V) in the
    compute dtype and the auxiliary loss (0, fp32), or the final hidden
    states with ``return_hidden``.  ``remat`` runs each decoder layer under
    ``lm._remat`` (rematerialised in the backward), as the reference
    checkpoints its decoder's scan body."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    enc = encode(params, cfg, frames, cdt)
    h, positions = _dec_embed(params, cfg, tokens, 0, cdt)
    enc_pos = _arange(0, enc.shape[1], enc.device)
    step = _remat(_dec_layer) if remat else _dec_layer
    for bp in layer_views(params["dec_blocks"], cfg.num_layers):
        h = step(bp, cfg, h, positions, enc, enc_pos)
    h = L.apply_norm(params["dec_norm"], cfg, h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_hidden:
        return h, aux
    return h @ params["lm_head"].to(h.dtype), aux


def _empty_cache(cfg: ModelConfig, batch: int, slots: int, frames: int,
                 dtype, device) -> Params:
    Lc, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim

    def zeros(n):
        return torch.zeros((Lc, batch, n, KV, hd), dtype=dtype, device=device)

    return {"pos": 0, "k": zeros(slots), "v": zeros(slots),
            "kpos": torch.full((slots,), -1, dtype=torch.int32,
                               device=device),
            "cross_k": zeros(frames), "cross_v": zeros(frames)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Empty decode cache for a context of ``seq_len`` tokens and the
    config's ``num_frames`` encoder frames."""
    return _empty_cache(cfg, batch, cache_len(cfg, seq_len), cfg.num_frames,
                        dtype, device)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor, *, cache_dtype=torch.bfloat16,
            max_len: Optional[int] = None, compute_dtype=None
            ) -> Tuple[torch.Tensor, Params]:
    """Encode the frames (B, F, D), run the decoder over the prompt tokens
    (B, S) and build the decode cache; return (last-position logits (B, V)
    in the compute dtype, cache).  ``max_len`` sizes the self-attention
    cache for the decode that follows: slots past the prompt are empty
    (``kpos`` -1).  ``compute_dtype``: None is ``layers.COMPUTE_DTYPE``."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    enc = encode(params, cfg, frames, cdt)
    h, positions = _dec_embed(params, cfg, tokens, 0, cdt)
    B, S = tokens.shape
    cache = _empty_cache(cfg, B, cache_len(cfg, max(S, max_len or S)),
                         enc.shape[1], cache_dtype, tokens.device)
    cache["kpos"][:S] = positions
    h = _dec_layers(params, cfg, h, positions, enc, cache)
    cache["pos"] = S
    h = L.apply_norm(params["dec_norm"], cfg, h[:, -1:])
    return (h @ params["lm_head"].to(h.dtype))[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, *, compute_dtype=None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  token: (B,) ints at position ``cache["pos"]``.
    Returns (logits (B, V) in the compute dtype, the cache with this
    token's k and v written into it in place and ``pos`` advanced)."""
    cdt = L.COMPUTE_DTYPE if compute_dtype is None else compute_dtype
    pos = cache["pos"]
    h, _ = _dec_embed(params, cfg, token[:, None], pos, cdt)
    # slot positions are layer-invariant: update them once
    cache["kpos"][L.cache_slot(cfg, pos, cache["k"].shape[2])] = pos
    for i in range(cfg.num_layers):
        bp = layer_params(params["dec_blocks"], i)
        hin = L.apply_norm(bp["norm1"], cfg, h)
        h = h + L.attn_decode(bp["attn"], cfg, hin, pos, cache["k"][i],
                              cache["v"][i], cache["kpos"])[0]
        hin = L.apply_norm(bp["norm_x"], cfg, h)
        h = h + L.cross_decode(bp["xattn"], cfg, hin, cache["cross_k"][i],
                               cache["cross_v"][i], cfg.num_frames)
        hin = L.apply_norm(bp["norm2"], cfg, h)
        h = h + L.apply_mlp(bp["ffn"], cfg, hin)
    h = L.apply_norm(params["dec_norm"], cfg, h)
    return (h @ params["lm_head"].to(h.dtype))[:, 0], {**cache,
                                                       "pos": pos + 1}
