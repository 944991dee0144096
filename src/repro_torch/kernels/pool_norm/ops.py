"""Router for the fused masked-pool + L2-normalise epilogue: the CUDA kernel
for CUDA tensors, the plain PyTorch version for CPU tensors.  No fallback.
Meta tensors (the dry run) get the kernel's empty output, and the call is
reported to the cost mode with its work (``roofline.kernel_cost``), every
token taken as unmasked; the launch counter does not move."""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import SERVING_BWD_ITEM, build, refuse_grad
from repro_torch.kernels.pool_norm.ref import pool_norm_ref
from repro_torch.roofline import kernel_cost

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 12288          # CLS keeps the pooled row in 48 KB of shared memory
_count_lock = threading.Lock()


def pool_norm(h: torch.Tensor, mask: torch.Tensor,
              pool: str = "mean") -> torch.Tensor:
    """h: (B, S, D); mask: (B, S) -> (B, D) float32 unit vectors."""
    if pool not in ("mean", "cls"):
        raise ValueError(f"unknown pool mode {pool!r}")
    if h.device.type == "cpu":
        return pool_norm_ref(h, mask, pool)
    refuse_grad("pool_norm", SERVING_BWD_ITEM, h, mask)
    if h.device.type == "meta":
        B, S, D = h.shape
        cost = kernel_cost.pool_norm(B, S, D, h.element_size(), pool,
                                     B * S if pool == "mean" else B)
        return kernel_cost.on_meta(
            "pool_norm", cost,
            torch.empty((B, D), dtype=torch.float32, device=h.device))
    if h.device.type != "cuda":
        raise ValueError(f"pool_norm: no route for device {h.device}")
    if h.dtype not in _DTYPES:
        raise TypeError(f"pool_norm: dtype {h.dtype} not supported "
                        f"(float32 or bfloat16)")
    if h.dim() != 3 or mask.shape != h.shape[:2]:
        raise ValueError(f"pool_norm: want h (B,S,D) and mask (B,S), got "
                         f"{tuple(h.shape)} and {tuple(mask.shape)}")
    if mask.device != h.device:
        raise ValueError(f"pool_norm: mask on {mask.device}, h on {h.device}")
    if not h.is_contiguous():
        raise ValueError("pool_norm: h must be contiguous")
    B, S, D = h.shape
    if S == 0 or D > MAX_D:
        raise ValueError(f"pool_norm: need 0 < S and D <= {MAX_D}, "
                         f"got S={S} D={D}")
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty((B, D), dtype=torch.float32, device=h.device)
    lib = build.load()
    with torch.cuda.device(h.device):
        err = lib.windve_pool_norm(
            h.data_ptr(), mask.data_ptr(), out.data_ptr(), _DTYPES[h.dtype],
            B, S, D, int(pool == "mean"), build.stream_handle(h.device))
    build.check(lib, err, "pool_norm")
    with _count_lock:                 # engine workers launch from threads
        pool_norm.launches += 1
    return out


pool_norm.launches = 0


__all__ = ["pool_norm", "pool_norm_ref"]
