"""Router for flash-decode attention, whole or over a sequence-sharded
cache: the CUDA kernel for CUDA tensors, the plain PyTorch version for CPU
tensors.  No fallback.  Meta tensors (the dry run) get empty outputs of the
kernel's shapes and dtypes, and the call is reported to the cost mode with
its work (``roofline.kernel_cost``), the slots taken as holding the latest
positions up to ``pos`` (kpos's values are not known there); the launch
counter does not move."""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import SERVING_BWD_ITEM, build, refuse_grad
from repro_torch.kernels.flash_decode.ref import (combine_shards,
                                                  decode_attention_ref,
                                                  sharded_decode_ref)
from repro_torch.roofline import kernel_cost

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q, cache) pairs the kernel takes: fp32 compute with an fp32 cache, bf16
# compute with an fp32 (the LM backend's) or a bf16 cache
PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
         (torch.bfloat16, torch.bfloat16))
_count_lock = threading.Lock()


def _check(q, k, v, kpos, pos) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no route for device {q.device}")
    for name, t in (("k", k), ("v", v), ("kpos", kpos)):
        if t.device != q.device:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on "
                             f"{q.device}")
    if v.dtype != k.dtype or (q.dtype, k.dtype) not in PAIRS:
        raise TypeError(f"flash_decode: q {q.dtype} with k {k.dtype} and v "
                        f"{v.dtype} not supported: (q, cache) in {PAIRS}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: want q (B,KV,G,hd) and k, v "
                         f"(B,Sc,KV,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, KV, _, hd = q.shape
    if k.shape[0] != B or k.shape[2] != KV or k.shape[3] != hd:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)}")
    if kpos.shape != (k.shape[1],) or kpos.dtype != torch.int32:
        raise ValueError(f"flash_decode: want kpos ({k.shape[1]},) int32, "
                         f"got {tuple(kpos.shape)} {kpos.dtype}")
    if not isinstance(pos, int):
        raise TypeError(f"flash_decode: pos must be a Python int (a tensor "
                        f"would cost a device sync), got {type(pos)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_decode: {name}'s head dim must be "
                             f"contiguous, strides {t.stride()}")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kpos: torch.Tensor, pos: int, *, window: int = 0,
                 lse: bool = False):
    """q: (B, KV, G, hd); k, v: (B, Sc, KV, hd); kpos: (Sc,) int32 absolute
    position per slot (-1 = empty); pos: the query's position, a Python
    int.  Returns (B, KV, G, hd) in q's dtype, contiguous; with ``lse``,
    also each row's fp32 log-sum-exp over the valid slots (B, KV, G), -1e30
    for a row with none, what a shard of a sequence-sharded cache hands
    the combine.  q, k and v may be strided views with a contiguous head
    dim; (q, cache) dtypes are one of ``PAIRS``.  The kernel splits each
    (row, KV head)'s slots over a cluster of up to 8 blocks, in one launch.
    A shape it cannot launch (hd above 512, a grid past the card's limits)
    raises with the CUDA error."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kpos, pos, window=window,
                                    lse=lse)
    refuse_grad("flash_decode", SERVING_BWD_ITEM, q, k, v)
    if q.device.type == "meta":
        return _meta(q, k, pos, window, lse)
    _check(q, k, v, kpos, pos)
    B, KV, G, hd = q.shape
    Sc = k.shape[1]
    kpos = kpos.contiguous()
    out = torch.empty((B, KV, G, hd), dtype=q.dtype, device=q.device)
    lse_t = (torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
             if lse else None)
    lib = build.load()
    with torch.cuda.device(q.device):
        err = lib.windve_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
            out.data_ptr(), lse_t.data_ptr() if lse else None,
            _DTYPES[q.dtype], _DTYPES[k.dtype], B, KV, G, Sc, hd,
            *q.stride()[:3], k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), pos, int(window),
            build.stream_handle(q.device))
    build.check(lib, err, "flash_decode")
    with _count_lock:                 # engine workers launch from threads
        flash_decode.launches += 1
    return (out, lse_t) if lse else out


flash_decode.launches = 0


def _meta(q, k, pos, window, lse):
    """The meta branch: the kernel's empty output (and lse), reported."""
    B, KV, G, hd = q.shape
    Sc = k.shape[1]
    out = torch.empty((B, KV, G, hd), dtype=q.dtype, device=q.device)
    lse_t = (torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
             if lse else None)
    cost = kernel_cost.flash_decode(
        B, KV, G, hd, Sc, kernel_cost.decode_slots(Sc, pos, window),
        q.element_size(), k.element_size(), lse)
    return kernel_cost.on_meta("flash_decode", cost,
                               (out, lse_t) if lse else out)


def flash_decode_sharded(q: torch.Tensor, ks, vs, kposs, pos: int, *,
                         window: int = 0) -> torch.Tensor:
    """Decode attention of q (B, KV, G, hd), on its home device, over a
    cache whose slots are split into shards (lists of (B, Sc_i, KV, hd) k,
    v and (Sc_i,) int32 kpos, each shard on its own device).  Returns (B,
    KV, G, hd) in q's dtype on q's device.

    On CUDA tensors each shard runs ``flash_decode(..., lse=True)`` on its
    device and the shards' (output, log-sum-exp) pairs combine on q's
    device (``combine_shards``).  On CPU tensors the plain version runs,
    the reference's shard_map formula step by step
    (``sharded_decode_ref``)."""
    if q.device.type == "cpu":
        return sharded_decode_ref(q, ks, vs, kposs, pos, window=window)
    parts = [flash_decode(q.to(k.device), k, v, kp, pos, window=window,
                          lse=True)
             for k, v, kp in zip(ks, vs, kposs)]
    return combine_shards(*zip(*parts)).to(q.dtype)


__all__ = ["flash_decode", "flash_decode_sharded", "decode_attention_ref",
           "PAIRS"]
