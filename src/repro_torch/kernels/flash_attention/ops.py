"""Router for flash attention: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.

There is no fallback: a CUDA tensor the kernel does not take raises, and a
kernel that fails to build or launch raises.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd).

    ``kv_len`` (optional, (B,) ints): per-row count of valid keys -- keys at
    positions >= kv_len[b] are masked (left-aligned padding).  Inputs may be
    strided views with a contiguous head dim; on CUDA the result is a
    (B, H, Sq, hd) view of a (B, Sq, H, hd) buffer, so ``transpose(1, 2)``
    gives the projection layout back without a copy."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             kv_len=kv_len)
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if kv_len is None:
        kv_len = torch.full((B,), Sk, dtype=torch.int32, device=q.device)
    else:
        if kv_len.shape != (B,):
            raise ValueError(f"flash_attention: kv_len shape "
                             f"{tuple(kv_len.shape)} != ({B},)")
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lib = build.load()
    with torch.cuda.device(q.device):
        err = lib.windve_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), int(window),
            build.stream_handle(q.device))
    build.check(lib, err, "flash_attention")
    with _count_lock:                 # engine workers launch from threads
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


__all__ = ["flash_attention", "attention_ref", "HEAD_DIMS"]
