"""Plain PyTorch version of the flash-decode kernel: one query token per
row against a slot-positioned (ring-buffer) KV cache.

The same function as ``csrc/flash_decode.cu``, written the simplest way,
with the numerics of the reference's LM decode read (``attn_decode``):
k is rounded to q's dtype before the fp32 dot product, the softmax is fp32
and its weights are rounded to v's dtype before the fp32 weighted sum.  For
fp32 q and cache that is the reference kernel's oracle
(``decode_attention_ref``) exactly.  A slot is valid when
``0 <= kpos <= pos`` and, with a window, ``kpos > pos - window``; a row with
no valid slot comes out as zeros.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def slot_mask(kpos: torch.Tensor, pos, window: int = 0) -> torch.Tensor:
    """(Sc,) bool: which cache slots the query at ``pos`` may attend to."""
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid = valid & (kpos > pos - window)
    return valid


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kpos: torch.Tensor, pos, *, window: int = 0,
                         lse: bool = False):
    """q: (B, KV, G, hd); k, v: (B, Sc, KV, hd); kpos: (Sc,) absolute
    position per slot (-1 = empty); pos: the query's position.
    Returns (B, KV, G, hd) in q's dtype; with ``lse``, also each row's
    fp32 log-sum-exp over the valid slots (B, KV, G): its max score plus
    the log of its denominator, ``NEG_INF`` for a row with no valid slot."""
    hd = q.shape[-1]
    s = torch.einsum("bkgh,bskh->bkgs", q.float(),
                     k.to(q.dtype).float()) / math.sqrt(hd)
    valid = slot_mask(kpos, pos, window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * valid
    den = p.sum(-1, keepdim=True)
    w = p / den.clamp_min(1e-30)
    out = torch.einsum("bkgs,bskh->bkgh", w.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    if not lse:
        return out
    m, den = m[..., 0].double(), den[..., 0].double()
    return out, torch.where(den > 0, m + torch.log(den),
                            torch.full_like(m, NEG_INF)).float()


def combine_shards(outs, lses) -> torch.Tensor:
    """Merge the partial results of attention over disjoint slot shards,
    each ``(out (B, KV, G, hd), lse (B, KV, G))`` as ``decode_attention_ref``
    or the kernel gives them with ``lse``: every shard's output weighted by
    exp(its lse - the largest lse), over the sum of the weights, summed in
    fp64 (a few small tensors).  Returns fp32 on the first output's
    device.  A shard with no valid slot (lse
    ``NEG_INF``) weighs 0 unless every shard has none; the outputs are then
    zeros."""
    dev = outs[0].device
    lses = [t.to(dev).double() for t in lses]
    m = torch.stack(lses).amax(0)
    ws = [torch.exp(t - m) for t in lses]
    num = sum(w[..., None] * o.to(dev).double() for w, o in zip(ws, outs))
    return (num / sum(ws)[..., None]).float()


def sharded_decode_ref(q: torch.Tensor, ks, vs, kposs, pos, *,
                       window: int = 0) -> torch.Tensor:
    """Attention of q (B, KV, G, hd) over a cache split into slot shards
    (lists of (B, Sc_i, KV, hd) k, v and (Sc_i,) kpos), combined by the
    reference's shard_map formula step by step
    (``models/layers.py`` ``attn_decode_sharded``): fp32 scores of q and k
    rounded to q's dtype, times 1 / sqrt(hd); the global max over every
    shard's masked scores; the unnormalised weights exp(s - max), masked,
    rounded to v's dtype for an fp32-accumulated PV; the denominators and
    PV summed over the shards; one division at the end, by the denominator
    clamped at 1e-30.  Returns (B, KV, G, hd) in q's dtype on q's
    device."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    parts = []
    for k, kp in zip(ks, kposs):
        qd = q.to(k.device)
        s = torch.einsum("bkgh,bskh->bkgs", qd.float(),
                         k.to(q.dtype).float()) * scale
        valid = slot_mask(kp, pos, window)
        parts.append((torch.where(valid, s, torch.full_like(s, NEG_INF)),
                      valid))
    m = torch.stack([s.amax(-1).to(q.device) for s, _ in parts]).amax(0)
    den = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for (s, valid), v in zip(parts, vs):
        pr = torch.exp(s - m.to(s.device)[..., None]) * valid
        den = den + pr.sum(-1).to(q.device)
        o = o + torch.einsum("bkgs,bskh->bkgh", pr.to(v.dtype).float(),
                             v.float()).to(q.device)
    return (o / den.clamp_min(1e-30)[..., None]).to(q.dtype)
