"""Building blocks of the embedder trunk, in PyTorch.

The parts of the reference's ``models/layers.py`` that the bge/jina
embedder runs, as plain functions on tensors over the same nested param
dicts.  Attention goes through ``repro_torch.kernels.flash_attention``,
which picks by the tensor's device: the CUDA kernel on the card, the plain
version on the CPU.  The large projections stay ``torch.matmul``.

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

Params = Dict[str, Any]

# the reference's default activation dtype when a caller names none
COMPUTE_DTYPE = torch.bfloat16


def dense_apply(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ p[name]`` with the weight cast to the activation dtype.  An
    int8-quantized tree (a ``{name}_scale`` sibling) belongs to the int8
    slice of the port, which is not here yet."""
    if name + "_scale" in p:
        raise NotImplementedError(
            "int8-quantized projections need the port's quant_matmul "
            "kernels, which come with the int8 slice (see ROADMAP.md)")
    return x @ p[name].to(x.dtype)


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
                 kv_x: torch.Tensor):
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = dense_apply(p, "wq", x)
    k = dense_apply(p, "wk", kv_x)
    v = dense_apply(p, "wv", kv_x)
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
                 kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence self-attention over x (B, S, D) at contiguous [0, S)
    positions.  ``kv_mask`` (B, S), 1 = real key, must be a left-aligned
    prefix per row: it is passed on as ``kv_len = kv_mask.sum(-1)``."""
    if cfg.rope_theta:
        raise NotImplementedError("rotary positions belong to the LM slice "
                                  "of the port (see ROADMAP.md)")
    q, k, v = _project_qkv(p, cfg, x, x)
    kv_len = None
    if kv_mask is not None:
        kv_len = (kv_mask != 0).sum(-1).to(torch.int32)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal,
                          window=cfg.sliding_window if causal else 0,
                          kv_len=kv_len)
    return dense_apply(p, "wo", out.transpose(1, 2).reshape(*x.shape[:-1], -1))


def apply_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        g = F.silu(dense_apply(p, "w_gate", x))
        return dense_apply(p, "w_down", g * dense_apply(p, "w_up", x))
    h = F.gelu(dense_apply(p, "w_in", x), approximate="tanh")
    return dense_apply(p, "w_out", h)
