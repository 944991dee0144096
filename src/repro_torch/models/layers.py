"""Building blocks of the embedder trunk, the decoder LM and the
encoder-decoder, in PyTorch.

The parts of the reference's ``models/layers.py`` that the bge/jina
embedder, the decoder LMs and whisper's encoder-decoder run, as plain
functions on tensors over the same nested param dicts (``init_*`` build
them, stacked on a leading ``lead`` shape, from a ``torch.Generator``).
Each call that the reference runs as a TPU kernel goes through the port's
kernel router, which picks by the tensor's device: the CUDA kernel on the
card, the plain version on the CPU:

- full-sequence attention (self or cross) -> ``kernels.flash_attention``;
- one-token attention against the KV cache -> ``kernels.flash_decode``,
  and over a sequence-sharded cache -> ``flash_decode_sharded`` (the
  kernel on each shard with its log-sum-exp, then the combine);
- RMSNorm -> ``kernels.rmsnorm``;
- the Mamba-1 prefill scan -> ``kernels.ssm_scan``, and in training
  (``mamba_forward``) too on the card.

Under autograd the attention, RMSNorm and scan routers carry gradients
through their backward kernels; the other kernels raise on the card when
asked for one (``kernels.refuse_grad``).  ``mamba_forward`` on CPU tensors
takes the reference's scans: one step at a time, or by checkpointed chunks
(``mamba_scan_chunked``, the ``mamba_chunk`` flag).

A float projection is ``torch.matmul``; an int8 one (a quantized tree,
``models.quantize``) goes through ``repro_torch.kernels.quant_matmul``,
which picks the same way.  Under W8A8 an input that feeds several weights
(q, k and v; gate and up) is quantized once for all of them
(``dense_apply_many``).  The MoE experts' products are batched matrix
products (``torch.einsum``), and a decode step's cross attention
(``cross_decode``, ``cross_attend``) is two ``einsum``s and a softmax, as
the reference computes them outside any kernel.

A mesh's positions (``models.tp``) run these functions on their blocks:
the mamba mixer in pieces (``mamba_conv``, ``mamba_ssm_inputs``, the scan
or ``ssm_step``, ``mamba_gate``), between which the position's partials
are summed and its channels gathered, and the MoE block on a run of the
experts (``_apply_moe_row``'s ``first_expert``).

Numerics kept from the reference: GELU is the tanh form (``jax.nn.gelu``'s
default), the layernorm variance is biased, norms compute in fp32 and cast
back, sinusoids are ``[sin | cos]``, RoPE rotates halves in fp32, the SSM
state is fp32.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import perf_flags
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_sharded)
from repro_torch.kernels.quant_matmul import (quant_matmul,
                                              quant_matmul_w8a8,
                                              quantize_rows, w8a8_matmul)
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssm_scan import ssm_scan

Params = Dict[str, Any]

# the reference's default activation dtype when a caller names none
COMPUTE_DTYPE = torch.bfloat16


# ----------------------------------------------------------------------------
# initialisers: the reference's, with torch's random numbers.  Each leaf has
# a leading ``lead`` shape (the layer stack) and lives on ``device``.
# ----------------------------------------------------------------------------

def dense_init(g: torch.Generator, shape: tuple, lead: tuple, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, scale^2), scale 1/sqrt(fan_in) unless given.  Drawn in fp32 on
    the generator's device one ``shape`` slice (one layer) at a time into a
    tensor of ``dtype``, so the fp32 draw never holds more than one layer:
    a stacked expert leaf of qwen3-moe-30b-a3b is 38.7 GB in fp32.  On the
    meta device (a tree of shapes) nothing is drawn."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
    w = torch.empty(lead + shape, dtype=dtype, device=device)
    if w.is_meta:
        return w
    for part in w.view((-1,) + shape):
        part.copy_(torch.randn(shape, generator=g, device=g.device,
                               dtype=torch.float32) * scale)
    return w


def init_norm(cfg: ModelConfig, lead: tuple, dtype, device) -> Params:
    p = {"scale": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype,
                                device=device)
    return p


def init_attention(g: torch.Generator, cfg: ModelConfig, lead: tuple, dtype,
                   device, cross: bool = False) -> Params:
    """q/k/v/o projections, and q/k/v biases where the config has them; a
    cross-attention block (``cross``) has none, as in the reference."""
    hd = cfg.resolved_head_dim
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    p = {name: dense_init(g, shape, lead, dtype, device)
         for name, shape in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                             ("wv", (D, KV * hd)), ("wo", (H * hd, D)))}
    if cfg.qkv_bias and not cross:
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
    RMSNorm through the ``rmsnorm`` kernel, which takes an fp32 scale (a
    bf16 tree's comes over exactly); fp32 inside, x's dtype out."""
    if cfg.norm != "layernorm":
        return rmsnorm(x, p["scale"].float(), cfg.norm_eps)
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
                 kv_x: Optional[torch.Tensor] = None, act_quant: bool = False):
    """q from x; k and v from ``kv_x`` (cross attention), or from x when it
    is None, in which case W8A8 quantizes x once for all three."""
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if kv_x is None:
        kv_x = x
        q, k, v = dense_apply_many(p, ("wq", "wk", "wv"), x, act_quant)
    else:
        q = dense_apply(p, "wq", x, act_quant)
        k, v = dense_apply_many(p, ("wk", "wv"), kv_x, act_quant)
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
                 kv_x: Optional[torch.Tensor] = None,
                 kv_positions: Optional[torch.Tensor] = None,
                 kv_mask: Optional[torch.Tensor] = None,
                 act_quant: bool = False, return_kv: bool = False):
    """Full-sequence attention of x (B, S, D) at contiguous [0, S)
    positions over itself or, for cross attention, over ``kv_x`` (B, Skv,
    D) at ``kv_positions`` (default: ``positions``), with rotary positions
    when the config has them and, when causal, the config's sliding
    window.  ``kv_mask`` (B, Skv), 1 = real key, must be a left-aligned
    prefix per row: it is passed on as ``kv_len = kv_mask.sum(-1)``.
    ``act_quant``: W8A8 projections on a quantized tree.  ``return_kv``
    also returns the (rotated) k and v, (B, Skv, KV, hd), for the decode
    cache."""
    q, k, v = _project_qkv(p, cfg, x, kv_x, act_quant)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if kv_positions is None else kv_positions,
                 cfg.rope_theta)
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
    q = project_q(p, cfg, x1, pos)
    k, v = attn_decode_kv(p, cfg, x1, pos)
    slot = cache_slot(cfg, pos, cache_k.shape[1])
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    KV = cache_k.shape[2]
    out = flash_decode(q.reshape(B, KV, H // KV, hd), cache_k, cache_v, kpos,
                       pos, window=cfg.sliding_window)
    y = dense_apply(p, "wo", out.reshape(B, 1, H * hd))
    return y, cache_k, cache_v, kpos


def project_q(p: Params, cfg: ModelConfig, x1: torch.Tensor,
              pos: int) -> torch.Tensor:
    """The current token's (rotated) query: (B, H, hd)."""
    hd, H = cfg.resolved_head_dim, cfg.num_heads
    q = dense_apply(p, "wq", x1)
    if "bq" in p:
        q = q + p["bq"].to(x1.dtype)
    q = q.reshape(x1.shape[0], 1, H, hd)
    if cfg.rope_theta:
        q = rope(q, _positions(pos, x1.device), cfg.rope_theta)
    return q[:, 0]


def shard_slot(cfg: ModelConfig, pos: int, sizes) -> tuple:
    """(shard, slot within it) that position ``pos`` writes to in a cache
    whose slots are split in order into shards of ``sizes``."""
    slot = cache_slot(cfg, pos, sum(sizes))
    for i, n in enumerate(sizes):
        if slot < n:
            return i, slot
        slot -= n
    raise ValueError(f"slot past a cache of {sum(sizes)} slots")


def attn_decode_sharded(p: Params, cfg: ModelConfig, x1: torch.Tensor,
                        pos: int, cache_k, cache_v, kpos):
    """Flash-decode over a sequence-sharded cache: the reference's
    shard_map decode (``attn_decode_sharded``) with the shards as lists.

    ``cache_k``/``cache_v`` hold one layer's (B, Sc_i, KV, hd) slice of
    each shard in slot order and ``kpos`` each shard's ALREADY-UPDATED (Sc_i,)
    positions, every shard on its own device; x1 (B, 1, D) and the result
    live on the home device.  Only the owner shard, the one whose slot range
    holds ``cache_slot(pos)``, takes the new token's k and v (in place).
    Each shard attends its own slots and the shards combine on the home
    device (``flash_decode_sharded``: the kernel with its log-sum-exp on
    the card, the reference's pmax/psum formula in the plain version).
    Returns (y (B, 1, D), cache_k, cache_v)."""
    hd, H, KV = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    B = x1.shape[0]
    q = project_q(p, cfg, x1, pos).reshape(B, KV, H // KV, hd)
    k, v = attn_decode_kv(p, cfg, x1, pos)
    i, slot = shard_slot(cfg, pos, [t.shape[1] for t in cache_k])
    cache_k[i][:, slot] = k[:, 0].to(cache_k[i].device)
    cache_v[i][:, slot] = v[:, 0].to(cache_v[i].device)
    out = flash_decode_sharded(q, cache_k, cache_v, kpos, pos,
                               window=cfg.sliding_window)
    y = dense_apply(p, "wo", out.reshape(B, 1, H * hd))
    return y, cache_k, cache_v


def cross_attend(q: torch.Tensor, cross_k: torch.Tensor,
                 cross_v: torch.Tensor, hd: int) -> torch.Tensor:
    """One token's projected query q (B, 1, H * hd) against the encoder's
    cached k and v (B, F, KV, hd): the attention output (B, 1, H * hd) in
    q's dtype.  The head counts are the tensors' (a mesh position passes
    its heads).  Plain ops, rounding where the reference rounds: fp32
    scores of q and ``cross_k`` cast to q's dtype, an fp32 softmax, the
    weights cast to ``cross_v``'s dtype before an fp32-accumulated PV."""
    B, KV = q.shape[0], cross_k.shape[2]
    qh = q.reshape(B, KV, -1, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qh.float(),
                     cross_k.to(q.dtype).float()) / math.sqrt(hd)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w.to(cross_v.dtype).float(),
                       cross_v.float())
    return out.reshape(B, 1, -1).to(q.dtype)


def cross_decode(p: Params, cfg: ModelConfig, x1: torch.Tensor,
                 cross_k: torch.Tensor, cross_v: torch.Tensor,
                 kv_len: int) -> torch.Tensor:
    """One token's cross attention, x1 (B, 1, D), against the encoder's
    cached k and v (B, F, KV, hd), in plain ops as the reference computes
    it outside any kernel (``cross_attend``), the output cast to x1's
    dtype before ``wo``.  Every frame is valid: ``kv_len`` is unused, as
    in the reference."""
    q = x1 @ p["wq"].to(x1.dtype)
    return (cross_attend(q, cross_k, cross_v, cfg.resolved_head_dim)
            @ p["wo"].to(x1.dtype))


def mlp_hidden(p: Params, cfg: ModelConfig, x: torch.Tensor,
               act_quant: bool = False) -> torch.Tensor:
    """The MLP's hidden activation, what its down projection takes."""
    if cfg.act == "silu":
        g, u = dense_apply_many(p, ("w_gate", "w_up"), x, act_quant)
        return F.silu(g) * u
    return F.gelu(dense_apply(p, "w_in", x, act_quant), approximate="tanh")


def apply_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor,
              act_quant: bool = False) -> torch.Tensor:
    down = "w_down" if cfg.act == "silu" else "w_out"
    return dense_apply(p, down, mlp_hidden(p, cfg, x, act_quant), act_quant)


# ----------------------------------------------------------------------------
# MoE: top-k routing and capacity-based gather dispatch, the reference's
# ``apply_moe`` (one global dispatch) and ``_apply_moe_row`` (per batch row).
# Its ``_mesh_axis_names`` and ``_moe_constrain`` are GSPMD layout hints;
# the port places its tensors explicitly (``parallel.sharding.shard``), so
# they are not ported.
# ----------------------------------------------------------------------------

def init_moe(g: torch.Generator, cfg: ModelConfig, lead: tuple, dtype,
             device) -> Params:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {name: dense_init(g, shape, lead, dtype, device)
            for name, shape in (("router", (D, E)), ("w_gate", (E, D, Fd)),
                                ("w_up", (E, D, Fd)), ("w_down", (E, Fd, D)))}


def moe_route(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Router of x (R, N, D): (fp32 probs (R, N, E), normalised gate
    weights (R, N, K), expert ids (R, N, K)).  The top K come from a stable
    descending sort, so among equal probabilities the lower expert id comes
    first, as in ``lax.top_k``: bf16 router logits tie often (torch.topk
    promises no order for ties)."""
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    gate_w, eidx = gate_w[..., :K], eidx[..., :K]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, eidx


def moe_slots(flat_e: torch.Tensor, E: int, cap: int):
    """(slot, keep) of each assignment of flat_e (R, N*K) expert ids, taken
    token-major and k-minor in each row: its place in its expert's queue
    (a stable sort ranks assignments of one expert in that order), kept if
    the place is below ``cap``; slot = expert * cap + place, or the
    overflow row E * cap when dropped."""
    R, n = flat_e.shape
    order = torch.sort(flat_e, dim=1, stable=True).indices
    sorted_e = torch.gather(flat_e, 1, order)
    # first place of each expert in the sorted order: the exclusive cumsum
    # of its count
    counts = torch.zeros((R, E), dtype=torch.int64, device=flat_e.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts
    place_sorted = (torch.arange(n, device=flat_e.device)[None]
                    - torch.gather(starts, 1, sorted_e))
    place = torch.empty_like(place_sorted).scatter_(1, order, place_sorted)
    keep = place < cap
    slot = torch.where(keep, flat_e * cap + place,
                       torch.full_like(place, E * cap))
    return slot, keep


def _apply_moe_row(p: Params, cfg: ModelConfig, x: torch.Tensor,
                   first_expert: int = 0):
    """MoE over x (B, S, D), each batch row dispatched on its own: an
    expert takes at most cap = ceil(S * K / E * capacity_factor) of a
    row's assignments, the rest are dropped.  Returns (y (B, S, D), the
    Switch load-balance loss, fp32).

    ``p``'s expert weights may hold a run of the experts from
    ``first_expert`` on (a mesh position's block of experts over
    ``model``): the assignments to the other experts then add nothing, and
    y is this block's share of the sum over the experts."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    probs, gate_w, eidx = moe_route(p, cfg, x)
    # Switch-style: E * sum(share of assignments * mean probability)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, eidx.reshape(-1), torch.ones(eidx.numel(), device=x.device))
    aux = E * (probs.mean((0, 1)) * (ce / (B * S * K))).sum()

    cap = int(math.ceil(S * K / E * cfg.capacity_factor))
    slot, keep = moe_slots(eidx.reshape(B, S * K), E, cap)
    rows = torch.arange(B, device=x.device)[:, None]
    # row E * cap takes every dropped assignment.  On the card an
    # index_put_ with repeated indices writes them in no set order; the
    # row is discarded, so which one lands does not matter.
    dispatched = x.new_zeros((B, E * cap + 1, D))
    dispatched[rows, slot] = x.repeat_interleave(K, dim=1)
    held = p["w_gate"].shape[0]
    lo, hi = first_expert * cap, (first_expert + held) * cap
    ein = dispatched[:, lo:hi].reshape(B, held, cap, D)
    g = F.silu(torch.einsum("becd,edf->becf", ein,
                            p["w_gate"].to(ein.dtype)))
    u = torch.einsum("becd,edf->becf", ein, p["w_up"].to(ein.dtype))
    eout = torch.einsum("becf,efd->becd", g * u, p["w_down"].to(ein.dtype))
    parts = [eout.reshape(B, held * cap, D),
             eout.new_zeros((B, E * cap + 1 - hi, D))]
    if lo:
        parts.insert(0, eout.new_zeros((B, lo, D)))
    eflat = torch.cat(parts, dim=1)
    w = (gate_w.reshape(B, S * K) * keep).to(x.dtype)
    y = (eflat[rows, slot] * w[..., None]).reshape(B, S, K, D).sum(2)
    return y, aux


def apply_moe(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """MoE over x (B, S, D): (y (B, S, D), load-balance loss).  One global
    dispatch over all B * S tokens (capacity from all of them), or, under
    the ``moe_row_dispatch`` flag, one a batch row (``_apply_moe_row``).
    The global dispatch is the per-row one on a single row of every token,
    which computes the reference's one-hot cumsum ranking."""
    if perf_flags.FLAGS.moe_row_dispatch:
        return _apply_moe_row(p, cfg, x)
    y, aux = _apply_moe_row(p, cfg, x.reshape(1, -1, x.shape[-1]))
    return y.reshape(x.shape), aux


# ----------------------------------------------------------------------------
# Mamba-1 mixer
# ----------------------------------------------------------------------------

def _mamba_core(p: Params, cfg: ModelConfig, xz: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None):
    """Shared pre-scan computation.  xz: (B, S, 2*DI).  Returns (xc, z, dt,
    Bm, Cm, A, new_conv_state); dt, Bm, Cm and A are fp32."""
    xc, z, new_conv_state = mamba_conv(p, cfg, xz, conv_state)
    dbc = xc @ p["x_proj"].to(xc.dtype)                        # (B, S, R+2N)
    return (xc, z) + mamba_ssm_inputs(p, cfg, dbc) + (new_conv_state,)


def mamba_conv(p: Params, cfg: ModelConfig, xz: torch.Tensor,
               conv_state: Optional[torch.Tensor] = None):
    """The causal depthwise conv (kernel CK) along S of xz's x half, and
    silu: (xc, z, new_conv_state), each over xz's channels (a mesh
    position's block holds its range of both halves)."""
    CK = cfg.ssm_conv
    x, z = xz.chunk(2, dim=-1)                                 # (B, S, DI)
    if conv_state is None:
        xpad = F.pad(x, (0, 0, CK - 1, 0))
    else:
        xpad = torch.cat([conv_state.to(x.dtype), x], dim=1)
    new_conv_state = xpad[:, -(CK - 1):, :]
    conv_w = p["conv_w"].to(x.dtype)
    S = x.shape[1]
    xc = sum(xpad[:, i:i + S, :] * conv_w[i] for i in range(CK))
    xc = F.silu(xc + p["conv_b"].to(x.dtype))
    return xc, z, new_conv_state


def mamba_ssm_inputs(p: Params, cfg: ModelConfig, dbc: torch.Tensor):
    """The input-dependent SSM params from dbc = xc @ x_proj (B, S, R+2N):
    (dt, Bm, Cm, A), fp32, dt and A over p's channels."""
    N, R = cfg.ssm_state, cfg.dt_rank
    dt, Bm, Cm = torch.split(dbc, [R, N, N], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].to(dt.dtype)
                    + p["dt_bias"].to(dt.dtype)).float()
    A = -torch.exp(p["A_log"].float())                         # (DI, N)
    return dt, Bm.float(), Cm.float(), A


def mamba_gate(p: Params, dtype, y: torch.Tensor, xc: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """The scan's output with the skip and the z gate, in ``dtype``: what
    ``out_proj`` multiplies."""
    y = y + p["D"] * xc.float()
    return (y * F.silu(z.float())).to(dtype)


def _mamba_out(p: Params, x: torch.Tensor, y: torch.Tensor, xc: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    return mamba_gate(p, x.dtype, y, xc, z) @ p["out_proj"].to(x.dtype)


def mamba_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Full-sequence mamba mixer over x (B, S, D), the selective scan
    through the ``ssm_scan`` kernel.  Returns (y (B, S, D), ssm_state
    (B, DI, N) fp32, conv_state (B, CK-1, DI))."""
    xz = x @ p["in_proj"].to(x.dtype)
    xc, z, dt, Bm, Cm, A, conv_state = _mamba_core(p, cfg, xz)
    y, h = ssm_scan(xc, dt, Bm, Cm, A)
    return _mamba_out(p, x, y, xc, z), h, conv_state


def _scan_steps(h, dts, xcs, bs, cs, A):
    """The recurrence over the steps of (B, T, ...) inputs from state h:
    (y (B, T, DI), h)."""
    ys = []
    for t in range(dts.shape[1]):
        dA = torch.exp(dts[:, t][..., None] * A)
        h = h * dA + (dts[:, t] * xcs[:, t])[..., None] * bs[:, t][:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cs[:, t]))
    return torch.stack(ys, dim=1), h


def mamba_scan_chunked(xc, dt, Bm, Cm, A, chunk: int = 16):
    """Time-chunked selective scan from a zero state: a loop over S/chunk
    chunks, each run under ``torch.utils.checkpoint``, so the backward
    keeps only the chunk-boundary states and recomputes inside a chunk (the
    reference's ``mamba_scan_chunked``; chunk shrinks to a divisor of S).
    Returns (y (B, S, DI) fp32, h_final (B, DI, N) fp32)."""
    B, S, DI = xc.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    h = torch.zeros((B, DI, N), dtype=torch.float32, device=xc.device)
    xf = xc.float()
    ys = []
    for c0 in range(0, S, chunk):
        part = slice(c0, c0 + chunk)
        y, h = checkpoint(_scan_steps, h, dt[:, part], xf[:, part],
                          Bm[:, part], Cm[:, part], A, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def default_mamba_scan(device=None):
    """The scan ``mamba_forward`` runs on ``device``: on the card the
    ``ssm_scan`` kernel (under autograd its forward, saving the chunk
    states, and its backward kernel); on the CPU the reference's choice by
    the ``mamba_chunk`` flag, the chunked scan, or ``ssm_scan``'s plain
    version, the sequential scan."""
    if torch.device(device or "cpu").type == "cpu" \
            and perf_flags.FLAGS.mamba_chunk > 0:
        return functools.partial(mamba_scan_chunked,
                                 chunk=perf_flags.FLAGS.mamba_chunk)
    return ssm_scan


def mamba_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  scan_fn=None) -> torch.Tensor:
    """Full-sequence mamba mixer over x (B, S, D), the training path:
    (y (B, S, D)).  ``scan_fn`` replaces the scan (default:
    ``default_mamba_scan`` for x's device)."""
    scan_fn = scan_fn or default_mamba_scan(x.device)
    xz = x @ p["in_proj"].to(x.dtype)
    xc, z, dt, Bm, Cm, A, _ = _mamba_core(p, cfg, xz)
    y, _ = scan_fn(xc, dt, Bm, Cm, A)
    return _mamba_out(p, x, y, xc, z)


def mamba_decode(p: Params, cfg: ModelConfig, x1: torch.Tensor,
                 ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One-token recurrent step, in plain ops as the reference does it.
    x1: (B, 1, D); ssm_state: (B, DI, N) fp32; conv_state: (B, CK-1, DI).
    Returns (y (B, 1, D), new ssm_state, new conv_state)."""
    xz = x1 @ p["in_proj"].to(x1.dtype)
    xc, z, dt, Bm, Cm, A, new_conv = _mamba_core(p, cfg, xz, conv_state)
    y, h = ssm_step(ssm_state, xc, dt, Bm, Cm, A)
    return _mamba_out(p, x1, y, xc, z), h, new_conv


def ssm_step(ssm_state: torch.Tensor, xc: torch.Tensor, dt: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, A: torch.Tensor):
    """The recurrence for one token (inputs (B, 1, ...)): (y (B, 1, DI)
    fp32, the new state (B, DI, N))."""
    dA = torch.exp(dt[:, 0][..., None] * A)
    dBx = (dt[:, 0] * xc[:, 0].float())[..., None] * Bm[:, 0][:, None, :]
    h = ssm_state * dA + dBx
    return torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :], h
