"""Plain PyTorch version of the flash-attention kernel: full-score attention.

The same function as ``csrc/flash_attention.cu``, written the simplest way:
it materialises the (Sq, Sk) score matrix, masks it with ``-1e30`` and takes
the softmax in fp32.  Like the kernel, a masked key gets weight exactly 0,
so a query row with no valid key (a padding row with ``kv_len = 0``) comes
out as zeros, and in bf16 the unnormalised probabilities are rounded to the
value type before the PV product.  The CPU tests run it; on the card it is
only the yardstick the kernel is compared with.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(B: int, Sq: int, Sk: int, *, causal: bool, window: int,
                   kv_len: Optional[torch.Tensor],
                   device) -> torch.Tensor:
    """(B, Sq, Sk) bool: which keys each query may attend to."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (kp > qp - window)
    valid = valid.expand(B, Sq, Sk)
    if kv_len is not None:
        lens = kv_len.to(device=device, dtype=torch.int64).clamp(0, Sk)
        valid = valid & (kp[None] < lens[:, None, None])
    return valid


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd), H = KV * G.  ``kv_len``
    (optional, (B,)): per-row valid-key prefix.  Returns (B, H, Sq, hd) in
    q's dtype."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, Sq, hd)
    s = torch.einsum("bkgqh,bksh->bkgqs", qf, k.float()) * (1.0 / math.sqrt(hd))
    valid = attention_mask(B, Sq, Sk, causal=causal, window=window,
                           kv_len=kv_len, device=q.device)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bkgqs,bksh->bkgqh", p.to(v.dtype).float(), v.float())
    return (pv / den).reshape(B, H, Sq, hd).to(q.dtype)
