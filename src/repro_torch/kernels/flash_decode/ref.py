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
                         kpos: torch.Tensor, pos, *,
                         window: int = 0) -> torch.Tensor:
    """q: (B, KV, G, hd); k, v: (B, Sc, KV, hd); kpos: (Sc,) absolute
    position per slot (-1 = empty); pos: the query's position.
    Returns (B, KV, G, hd) in q's dtype."""
    hd = q.shape[-1]
    s = torch.einsum("bkgh,bskh->bkgs", q.float(),
                     k.to(q.dtype).float()) / math.sqrt(hd)
    valid = slot_mask(kpos, pos, window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid
    w = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bskh->bkgh", w.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
