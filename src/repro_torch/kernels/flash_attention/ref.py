"""Plain PyTorch version of the flash-attention kernel: full-score attention.

The same function as ``csrc/flash_attention.cu``, written the simplest way:
it materialises the (Sq, Sk) score matrix, masks it with ``-1e30`` and takes
the softmax in fp32.  Like the kernel, a masked key gets weight exactly 0,
so a query row with no valid key (a padding row with ``kv_len = 0``) comes
out as zeros, and in bf16 the unnormalised probabilities are rounded to the
value type before the PV product.  The CPU tests run it; on the card it is
only the yardstick the kernel is compared with.

``attention_ref(..., return_lse=True)`` also returns each row's
log-sum-exp of its scaled scores (-1e30 for a row with no valid key), the
forward kernel's optional ``lse``.  ``attention_bwd_ref`` is the plain
version of ``csrc/flash_attention_bwd.cu``: the gradients of q, k and v
from the output's gradient, step by step from the saved output and lse.
Both compute in fp32, or in float64 for float64 inputs (the tests' oracle).
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


def _acc(t: torch.Tensor) -> torch.Tensor:
    """t in the accumulation dtype: fp32, or float64 for float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  kv_len: Optional[torch.Tensor] = None,
                  return_lse: bool = False):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd), H = KV * G.  ``kv_len``
    (optional, (B,)): per-row valid-key prefix.  Returns (B, H, Sq, hd) in
    q's dtype, and with ``return_lse`` also the (B, H, Sq) log-sum-exp of
    each row's scaled scores in the accumulation dtype."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qf = _acc(q).reshape(B, KV, G, Sq, hd)
    s = torch.einsum("bkgqh,bksh->bkgqs", qf, _acc(k)) * (1.0 / math.sqrt(hd))
    valid = attention_mask(B, Sq, Sk, causal=causal, window=window,
                           kv_len=kv_len, device=q.device)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * valid
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bkgqs,bksh->bkgqh", _acc(p.to(v.dtype)), _acc(v))
    out = (pv / den).reshape(B, H, Sq, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(valid.any(-1, keepdim=True), m + torch.log(den),
                      torch.full_like(m, NEG_INF))
    return out, lse.reshape(B, H, Sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      kv_len: Optional[torch.Tensor] = None):
    """The gradients (dq, dk, dv) of ``attention_ref`` at q, k, v (shapes
    as there) given its output o, the output's gradient do (B, H, Sq, hd)
    and the forward's lse (B, H, Sq):

        P = exp(scale * q k^T - lse) (0 where masked),  D = rowsum(do * o),
        dS = P * (do v^T - D),
        dv = P^T do,  dk = scale * dS^T q,  dq = scale * dS k,

    dk and dv summed over the G query heads of each KV head.  Each comes
    back in its input's dtype."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf, dof, of = (_acc(t).reshape(B, KV, G, Sq, hd) for t in (q, do, o))
    kf, vf = _acc(k), _acc(v)
    s = torch.einsum("bkgqh,bksh->bkgqs", qf, kf) * scale
    valid = attention_mask(B, Sq, Sk, causal=causal, window=window,
                           kv_len=kv_len, device=q.device)[:, None, None]
    lse = lse.to(s.dtype).reshape(B, KV, G, Sq, 1)
    p = torch.where(valid, torch.exp(s - lse), torch.zeros_like(s))
    dv = torch.einsum("bkgqs,bkgqh->bksh", p, dof)
    dp = torch.einsum("bkgqh,bksh->bkgqs", dof, vf)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds, qf) * scale
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
