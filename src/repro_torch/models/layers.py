"""Building blocks of the embedder trunk, in PyTorch.

The parts of the reference's ``models/layers.py`` that the bge/jina
embedder runs, as plain functions on tensors over the same nested param
dicts.  Attention goes through ``repro_torch.kernels.flash_attention``,
which picks by the tensor's device: the CUDA kernel on the card, the plain
version on the CPU.  A float projection is ``torch.matmul``; an int8 one
(a quantized tree, ``models.quantize``) goes through
``repro_torch.kernels.quant_matmul``, which picks the same way.

Numerics kept from the reference: GELU is the tanh form (``jax.nn.gelu``'s
default), the layernorm variance is biased, norms compute in fp32 and cast
back, sinusoids are ``[sin | cos]``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_w8a8

Params = Dict[str, Any]

# the reference's default activation dtype when a caller names none
COMPUTE_DTYPE = torch.bfloat16


def dense_apply(p: Params, name: str, x: torch.Tensor,
                act_quant: bool = False) -> torch.Tensor:
    """``x @ p[name]``, routed by the params, as the reference routes it:

    - no ``{name}_scale`` sibling -> ``x @ w`` with the weight cast to the
      activation dtype;
    - a scale, ``act_quant`` off -> ``quant_matmul``: int8 weights x float
      activations, fp32 accumulation, the scale applied once after the sum;
    - a scale, ``act_quant`` on -> ``quant_matmul_w8a8``: per-row int8
      activations, int8 x int8 with int32 accumulation.

    ``act_quant`` on a float tree changes nothing, so callers thread the
    flag unconditionally.  A quantized route with a weight that is not int8
    raises ``TypeError``."""
    scale = p.get(name + "_scale")
    if scale is None:
        return x @ p[name].to(x.dtype)
    if act_quant:
        return quant_matmul_w8a8(x, p[name], scale)
    return quant_matmul(x, p[name], scale)


def apply_norm(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return y.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    half = d_model // 2
    freq = 10000.0 ** (-torch.arange(0, half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 kv_x: torch.Tensor, act_quant: bool = False):
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = dense_apply(p, "wq", x, act_quant)
    k = dense_apply(p, "wk", kv_x, act_quant)
    v = dense_apply(p, "wv", kv_x, act_quant)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(*x.shape[:-1], H, hd)
    k = k.reshape(*kv_x.shape[:-1], KV, hd)
    v = v.reshape(*kv_x.shape[:-1], KV, hd)
    return q, k, v


def attn_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool = True,
                 kv_mask: Optional[torch.Tensor] = None,
                 act_quant: bool = False) -> torch.Tensor:
    """Full-sequence self-attention over x (B, S, D) at contiguous [0, S)
    positions.  ``kv_mask`` (B, S), 1 = real key, must be a left-aligned
    prefix per row: it is passed on as ``kv_len = kv_mask.sum(-1)``.
    ``act_quant``: W8A8 projections on a quantized tree."""
    if cfg.rope_theta:
        raise NotImplementedError("rotary positions belong to the LM slice "
                                  "of the port (see ROADMAP.md)")
    q, k, v = _project_qkv(p, cfg, x, x, act_quant)
    kv_len = None
    if kv_mask is not None:
        kv_len = (kv_mask != 0).sum(-1).to(torch.int32)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal,
                          window=cfg.sliding_window if causal else 0,
                          kv_len=kv_len)
    # on the card ``out`` is a (B, H, S, hd) view of a (B, S, H, hd)
    # buffer, so this reshape is a view, not a copy
    return dense_apply(p, "wo", out.transpose(1, 2).reshape(*x.shape[:-1], -1),
                       act_quant)


def apply_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor,
              act_quant: bool = False) -> torch.Tensor:
    if cfg.act == "silu":
        g = F.silu(dense_apply(p, "w_gate", x, act_quant))
        u = dense_apply(p, "w_up", x, act_quant)
        return dense_apply(p, "w_down", g * u, act_quant)
    h = F.gelu(dense_apply(p, "w_in", x, act_quant), approximate="tanh")
    return dense_apply(p, "w_out", h, act_quant)
