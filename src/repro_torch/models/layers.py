"""Building blocks of the embedder trunk and the decoder LM, in PyTorch.

The parts of the reference's ``models/layers.py`` that the bge/jina
embedder and the hymba LM run, as plain functions on tensors over the same
nested param dicts (``init_*`` build them, stacked on a leading ``lead``
shape, from a ``torch.Generator``).  Each call that the reference runs as a
TPU kernel goes through the port's kernel router, which picks by the
tensor's device: the CUDA kernel on the card, the plain version on the CPU:

- full-sequence attention -> ``kernels.flash_attention``;
- one-token attention against the KV cache -> ``kernels.flash_decode``;
- RMSNorm -> ``kernels.rmsnorm``;
- the Mamba-1 prefill scan -> ``kernels.ssm_scan``.

A float projection is ``torch.matmul``; an int8 one (a quantized tree,
``models.quantize``) goes through ``repro_torch.kernels.quant_matmul``,
which picks the same way.  Under W8A8 an input that feeds several weights
(q, k and v; gate and up) is quantized once for all of them
(``dense_apply_many``).

Numerics kept from the reference: GELU is the tanh form (``jax.nn.gelu``'s
default), the layernorm variance is biased, norms compute in fp32 and cast
back, sinusoids are ``[sin | cos]``, RoPE rotates halves in fp32, the SSM
state is fp32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.quant_matmul import (quant_matmul,
                                              quant_matmul_w8a8,
                                              quantize_rows, w8a8_matmul)
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssm_scan import ssm_scan

Params = Dict[str, Any]

# the reference's default activation dtype when a caller names none
COMPUTE_DTYPE = torch.bfloat16


# ----------------------------------------------------------------------------
# initialisers: the reference's, with torch's random numbers.  Each leaf is
# drawn on the generator's device with a leading ``lead`` shape (the layer
# stack) and moved to ``device``.
# ----------------------------------------------------------------------------

def dense_init(g: torch.Generator, shape: tuple, lead: tuple, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, scale^2), scale 1/sqrt(fan_in) unless given."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
    w = torch.randn(lead + shape, generator=g, device=g.device,
                    dtype=torch.float32) * scale
    return w.to(device=device, dtype=dtype)


def init_norm(cfg: ModelConfig, lead: tuple, dtype, device) -> Params:
    p = {"scale": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype,
                                device=device)
    return p


def init_attention(g: torch.Generator, cfg: ModelConfig, lead: tuple, dtype,
                   device) -> Params:
    hd = cfg.resolved_head_dim
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    p = {name: dense_init(g, shape, lead, dtype, device)
         for name, shape in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                             ("wv", (D, KV * hd)), ("wo", (H * hd, D)))}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(lead + (n,), dtype=dtype, device=device)
    return p


def init_mlp(g: torch.Generator, cfg: ModelConfig, lead: tuple, dtype,
             device) -> Params:
    D, Fd = cfg.d_model, cfg.d_ff
    shapes = ((("w_gate", (D, Fd)), ("w_up", (D, Fd)), ("w_down", (Fd, D)))
              if cfg.act == "silu" else
              (("w_in", (D, Fd)), ("w_out", (Fd, D))))
    return {name: dense_init(g, shape, lead, dtype, device)
            for name, shape in shapes}


def init_mamba(g: torch.Generator, cfg: ModelConfig, lead: tuple, dtype,
               device) -> Params:
    D, DI, N, R, CK = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                       cfg.ssm_conv)

    def full(shape, value, dt=dtype):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=device)).expand(lead + (DI, N))
    return {
        "in_proj": dense_init(g, (D, 2 * DI), lead, dtype, device),
        "conv_w": dense_init(g, (CK, DI), lead, dtype, device,
                             scale=1.0 / math.sqrt(CK)),
        "conv_b": full((DI,), 0.0),
        "x_proj": dense_init(g, (DI, R + 2 * N), lead, dtype, device),
        "dt_proj": dense_init(g, (R, DI), lead, dtype, device),
        "dt_bias": full((DI,), math.log(math.e - 1)),     # softplus^-1(1)
        "A_log": a_log.contiguous(),
        "D": full((DI,), 1.0, torch.float32),
        "out_proj": dense_init(g, (DI, D), lead, dtype, device),
    }


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


def dense_apply_many(p: Params, names, x: torch.Tensor,
                     act_quant: bool = False) -> list:
    """``[dense_apply(p, name, x, act_quant) for name in names]``, with
    ``x`` quantized once for all of them when every one takes the W8A8
    route: ``quantize_rows`` is a pure function of ``x``, so each product
    is bit for bit ``dense_apply``'s."""
    if not (act_quant and all(n + "_scale" in p for n in names)):
        return [dense_apply(p, n, x, act_quant) for n in names]
    x8, x_scale = quantize_rows(x)
    return [w8a8_matmul(x8, p[n], x_scale, p[n + "_scale"], out_dtype=x.dtype)
            for n in names]


def apply_norm(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in plain ops (the reference has no layernorm kernel), or
    RMSNorm through the ``rmsnorm`` kernel; fp32 inside, x's dtype out."""
    if cfg.norm != "layernorm":
        return rmsnorm(x, p["scale"], cfg.norm_eps)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S) ints.  Rotates
    the two halves of the head dim in fp32, returns x's dtype."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq                   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    half = d_model // 2
    freq = 10000.0 ** (-torch.arange(0, half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _project_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 act_quant: bool = False):
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q, k, v = dense_apply_many(p, ("wq", "wk", "wv"), x, act_quant)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(*x.shape[:-1], H, hd)
    k = k.reshape(*x.shape[:-1], KV, hd)
    v = v.reshape(*x.shape[:-1], KV, hd)
    return q, k, v


def attn_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool = True,
                 kv_mask: Optional[torch.Tensor] = None,
                 act_quant: bool = False, return_kv: bool = False):
    """Full-sequence self-attention over x (B, S, D) at contiguous [0, S)
    positions, with rotary positions when the config has them and, when
    causal, the config's sliding window.  ``kv_mask`` (B, S), 1 = real key,
    must be a left-aligned prefix per row: it is passed on as
    ``kv_len = kv_mask.sum(-1)``.  ``act_quant``: W8A8 projections on a
    quantized tree.  ``return_kv`` also returns the (rotated) k and v,
    (B, S, KV, hd), for the decode cache."""
    q, k, v = _project_qkv(p, cfg, x, act_quant)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    kv_len = None
    if kv_mask is not None:
        kv_len = (kv_mask != 0).sum(-1).to(torch.int32)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal,
                          window=cfg.sliding_window if causal else 0,
                          kv_len=kv_len)
    # on the card ``out`` is a (B, H, S, hd) view of a (B, S, H, hd)
    # buffer, so this reshape is a view, not a copy
    y = dense_apply(p, "wo", out.transpose(1, 2).reshape(*x.shape[:-1], -1),
                    act_quant)
    if return_kv:
        return y, k, v
    return y


def cache_slot(cfg: ModelConfig, pos: int, s_cache: int) -> int:
    """Which cache slot position ``pos`` writes to (ring buffer if windowed)."""
    if cfg.sliding_window:
        return pos % s_cache
    return min(pos, s_cache - 1)


def _positions(pos: int, device) -> torch.Tensor:
    return torch.full((1,), pos, dtype=torch.int32, device=device)


def attn_decode_kv(p: Params, cfg: ModelConfig, x1: torch.Tensor, pos: int):
    """The current token's (rotated) k, v: (B, 1, KV, hd)."""
    hd, KV = cfg.resolved_head_dim, cfg.num_kv_heads
    k = dense_apply(p, "wk", x1)
    v = dense_apply(p, "wv", x1)
    if "bk" in p:
        k = k + p["bk"].to(x1.dtype)
        v = v + p["bv"].to(x1.dtype)
    k = k.reshape(*x1.shape[:-1], KV, hd)
    v = v.reshape(*x1.shape[:-1], KV, hd)
    if cfg.rope_theta:
        k = rope(k, _positions(pos, x1.device), cfg.rope_theta)
    return k, v


def attn_decode(p: Params, cfg: ModelConfig, x1: torch.Tensor, pos: int,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                kpos: torch.Tensor):
    """One-token decode of x1 (B, 1, D) at position ``pos`` (a Python int)
    against one layer's (B, Sc, KV, hd) cache, a ring buffer when the config
    is windowed.  ``kpos`` (Sc,) is the ALREADY-UPDATED position of every
    slot (the caller updates it once for all layers).

    The current token's k and v are written into their slot of
    ``cache_k``/``cache_v`` in place; the read goes through
    ``flash_decode``.  Returns (y (B, 1, D), cache_k, cache_v, kpos)."""
    hd, H = cfg.resolved_head_dim, cfg.num_heads
    B = x1.shape[0]
    q = dense_apply(p, "wq", x1)
    if "bq" in p:
        q = q + p["bq"].to(x1.dtype)
    q = q.reshape(B, 1, H, hd)
    if cfg.rope_theta:
        q = rope(q, _positions(pos, x1.device), cfg.rope_theta)
    k, v = attn_decode_kv(p, cfg, x1, pos)
    slot = cache_slot(cfg, pos, cache_k.shape[1])
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    KV = cache_k.shape[2]
    out = flash_decode(q.reshape(B, KV, H // KV, hd), cache_k, cache_v, kpos,
                       pos, window=cfg.sliding_window)
    y = dense_apply(p, "wo", out.reshape(B, 1, H * hd))
    return y, cache_k, cache_v, kpos


def apply_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor,
              act_quant: bool = False) -> torch.Tensor:
    if cfg.act == "silu":
        g, u = dense_apply_many(p, ("w_gate", "w_up"), x, act_quant)
        return dense_apply(p, "w_down", F.silu(g) * u, act_quant)
    h = F.gelu(dense_apply(p, "w_in", x, act_quant), approximate="tanh")
    return dense_apply(p, "w_out", h, act_quant)


# ----------------------------------------------------------------------------
# Mamba-1 mixer
# ----------------------------------------------------------------------------

def _mamba_core(p: Params, cfg: ModelConfig, xz: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None):
    """Shared pre-scan computation.  xz: (B, S, 2*DI).  Returns (xc, z, dt,
    Bm, Cm, A, new_conv_state); dt, Bm, Cm and A are fp32."""
    N, R, CK = cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    x, z = xz.chunk(2, dim=-1)                                 # (B, S, DI)
    # causal depthwise conv along S (kernel CK)
    if conv_state is None:
        xpad = F.pad(x, (0, 0, CK - 1, 0))
    else:
        xpad = torch.cat([conv_state.to(x.dtype), x], dim=1)
    new_conv_state = xpad[:, -(CK - 1):, :]
    conv_w = p["conv_w"].to(x.dtype)
    S = x.shape[1]
    xc = sum(xpad[:, i:i + S, :] * conv_w[i] for i in range(CK))
    xc = F.silu(xc + p["conv_b"].to(x.dtype))
    # input-dependent SSM params
    dbc = xc @ p["x_proj"].to(xc.dtype)                        # (B, S, R+2N)
    dt, Bm, Cm = torch.split(dbc, [R, N, N], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].to(dt.dtype)
                    + p["dt_bias"].to(dt.dtype)).float()
    A = -torch.exp(p["A_log"].float())                         # (DI, N)
    return xc, z, dt, Bm.float(), Cm.float(), A, new_conv_state


def _mamba_out(p: Params, x: torch.Tensor, y: torch.Tensor, xc: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    y = y + p["D"] * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p["out_proj"].to(x.dtype)


def mamba_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Full-sequence mamba mixer over x (B, S, D), the selective scan
    through the ``ssm_scan`` kernel.  Returns (y (B, S, D), ssm_state
    (B, DI, N) fp32, conv_state (B, CK-1, DI))."""
    xz = x @ p["in_proj"].to(x.dtype)
    xc, z, dt, Bm, Cm, A, conv_state = _mamba_core(p, cfg, xz)
    y, h = ssm_scan(xc, dt, Bm, Cm, A)
    return _mamba_out(p, x, y, xc, z), h, conv_state


def mamba_decode(p: Params, cfg: ModelConfig, x1: torch.Tensor,
                 ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One-token recurrent step, in plain ops as the reference does it.
    x1: (B, 1, D); ssm_state: (B, DI, N) fp32; conv_state: (B, CK-1, DI).
    Returns (y (B, 1, D), new ssm_state, new conv_state)."""
    xz = x1 @ p["in_proj"].to(x1.dtype)
    xc, z, dt, Bm, Cm, A, new_conv = _mamba_core(p, cfg, xz, conv_state)
    dA = torch.exp(dt[:, 0][..., None] * A)
    dBx = (dt[:, 0] * xc[:, 0].float())[..., None] * Bm[:, 0][:, None, :]
    h = ssm_state * dA + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :]
    return _mamba_out(p, x1, y, xc, z), h, new_conv
