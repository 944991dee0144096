"""Router for flash attention: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.

Under autograd (grad mode on and q, k or v requiring grad) the call goes
through ``FlashAttentionFn``: on the card its forward is the kernel with
its log-sum-exp (``lse``) and its backward the backward kernel
(``flash_attention_bwd``, csrc/flash_attention_bwd.cu); on the CPU they are
``attention_ref`` and ``attention_bwd_ref``.  ``flash_attention.launches``
counts forward launches and ``flash_attention_bwd.launches`` backward ones.

There is no fallback: a CUDA tensor the kernel does not take raises, and a
kernel that fails to build or launch raises.  Meta tensors (the dry run)
get empty outputs of the kernel's shapes and dtypes, and the call is
reported to the cost mode with its work (``roofline.kernel_cost``),
counting every key as valid (kv_len's values are not known there); the
launch counters do not move.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from repro_torch.roofline import kernel_cost

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65535          # heads and batch rows ride grid.y and grid.z
_count_lock = threading.Lock()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no route for device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, "
                            f"q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q (B,H,Sq,hd) and k, v "
                         f"(B,KV,Sk,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"flash_attention: B={B} and H={H} must be <= "
                         f"{MAX_GRID_YZ}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             f"contiguous, strides {t.stride()}")


def _kv_len(kv_len: Optional[torch.Tensor], B: int, Sk: int,
            device) -> torch.Tensor:
    if kv_len is None:
        return torch.full((B,), Sk, dtype=torch.int32, device=device)
    if kv_len.shape != (B,):
        raise ValueError(f"flash_attention: kv_len shape "
                         f"{tuple(kv_len.shape)} != ({B},)")
    return kv_len.to(device=device, dtype=torch.int32).contiguous()


def _pairs(q, k, causal, window):
    """(valid pairs, q rows, kv rows) over the batch, every key valid."""
    B, Sq, Sk = q.shape[0], q.shape[2], k.shape[2]
    return tuple(B * n for n in kernel_cost.attention_pairs(Sq, Sk, causal,
                                                            window))


def _meta_forward(q, k, v, causal, window, with_lse: bool):
    """The meta branch: the kernel's empty (out, lse or None), reported."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    cost = kernel_cost.flash_attention(B, H, KV, Sq, Sk, hd, q.element_size(),
                                       *_pairs(q, k, causal, window),
                                       lse=with_lse)
    return kernel_cost.on_meta("flash_attention", cost, (out, lse))


def _forward(q, k, v, causal, window, kv_len, with_lse: bool):
    """The kernel: (out, lse or None); the lse is (B, H, Sq) fp32, each
    row's log-sum-exp, -1e30 for a row with no valid key."""
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    kv_len = _kv_len(kv_len, B, Sk, q.device)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = build.load()
    with torch.cuda.device(q.device):
        err = lib.windve_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), int(window),
            build.stream_handle(q.device))
    build.check(lib, err, "flash_attention")
    with _count_lock:                 # engine workers launch from threads
        flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        kv_len: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``flash_attention`` at q, k, v given its output o,
    the output's gradient do and the forward's lse (B, H, Sq) fp32: the
    backward kernel on CUDA tensors, ``attention_bwd_ref`` on CPU ones.
    On CUDA dq, dk and dv are (B, H, S, hd) views of (B, S, H, hd)
    buffers, the projections' layout."""
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, lse, **kw)
    if q.device.type == "meta":
        return _meta_bwd(q, k, causal, window)
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride(-1) != 1):
            raise ValueError(f"flash_attention_bwd: {name} must be q's "
                             f"shape {tuple(q.shape)}, dtype and device, "
                             f"with a contiguous head dim")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: want a contiguous fp32 lse "
                         f"({B}, {H}, {Sq}) on {q.device}")
    kv_len = _kv_len(kv_len, B, Sk, q.device)

    def grad_like(n, S):
        return torch.empty((B, S, n, hd), dtype=q.dtype,
                           device=q.device).transpose(1, 2)

    dq, dk, dv = grad_like(H, Sq), grad_like(KV, Sk), grad_like(KV, Sk)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(st for t in (q, k, v, o, do, dq, dk, dv)
                                      for st in t.stride()[:3]))
    lib = build.load()
    with torch.cuda.device(q.device):
        err = lib.windve_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), kv_len.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), _DTYPES[q.dtype],
            B, H, KV, Sq, Sk, hd, strides, int(causal), int(window),
            build.stream_handle(q.device))
    build.check(lib, err, "flash_attention_bwd")
    with _count_lock:
        flash_attention_bwd.launches += 1
    return dq, dk, dv


def _meta_bwd(q, k, causal, window):
    """The backward's meta branch: empty dq, dk, dv in the card's layout,
    reported."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]

    def grad_like(n, S):
        return torch.empty((B, S, n, hd), dtype=q.dtype,
                           device=q.device).transpose(1, 2)

    cost = kernel_cost.flash_attention_bwd(B, H, KV, Sq, Sk, hd,
                                           q.element_size(),
                                           _pairs(q, k, causal, window)[0])
    return kernel_cost.on_meta("flash_attention_bwd", cost,
                               (grad_like(H, Sq), grad_like(KV, Sk),
                                grad_like(KV, Sk)))


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: the forward kernel with its lse and the
    backward kernel on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, window):
        if q.device.type == "cpu":
            out, lse = attention_ref(q, k, v, causal=causal, window=window,
                                     kv_len=kv_len, return_lse=True)
        elif q.device.type == "meta":
            out, lse = _meta_forward(q, k, v, causal, window, True)
        else:
            out, lse = _forward(q, k, v, causal, window, kv_len, True)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse,
                                         causal=ctx.causal, window=ctx.window,
                                         kv_len=kv_len)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd).

    ``kv_len`` (optional, (B,) ints): per-row count of valid keys -- keys at
    positions >= kv_len[b] are masked (left-aligned padding).  Inputs may be
    strided views with a contiguous head dim; on CUDA the result is a
    (B, H, Sq, hd) view of a (B, Sq, H, hd) buffer, so ``transpose(1, 2)``
    gives the projection layout back without a copy.  Under autograd the
    call goes through ``FlashAttentionFn``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, kv_len, causal, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             kv_len=kv_len)
    if q.device.type == "meta":
        return _meta_forward(q, k, v, causal, window, False)[0]
    return _forward(q, k, v, causal, window, kv_len, False)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0


__all__ = ["flash_attention", "flash_attention_bwd", "FlashAttentionFn", "attention_ref", "attention_bwd_ref",
           "HEAD_DIMS"]
