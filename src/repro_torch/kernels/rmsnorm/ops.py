"""Router for fused RMSNorm: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.  No fallback."""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 2 ** 31 - 1            # one block a row, on grid.x
_count_lock = threading.Lock()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16; scale: (D,) float32.  Returns
    RMSNorm(x) * scale in x's shape and dtype, computed in fp32.

    Rows may be strided (a unit column stride is required); the result is
    contiguous."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no route for device {x.device}")
    if scale.device != x.device:
        raise ValueError(f"rmsnorm: scale on {scale.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: dtype {x.dtype} not supported (float32 "
                        f"or bfloat16)")
    if scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm: scale must be float32, got {scale.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"rmsnorm: want scale ({D},), got "
                         f"{tuple(scale.shape)}")
    if not scale.is_contiguous():
        raise ValueError("rmsnorm: scale must be contiguous")
    x2 = x.reshape(-1, D)         # a view when the leading dims merge
    R = x2.shape[0]
    if (D > 1 and x2.stride(1) != 1) or (R > 1 and x2.stride(0) < D):
        x2 = x2.contiguous()
    if R > MAX_ROWS:
        raise ValueError(f"rmsnorm: {R} rows, at most {MAX_ROWS}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.windve_rmsnorm(
            x2.data_ptr(), x2.stride(0) if R > 1 else D, scale.data_ptr(),
            out.data_ptr(), _DTYPES[x.dtype], R, D, float(eps),
            build.stream_handle(x.device))
    build.check(lib, err, "rmsnorm")
    with _count_lock:                 # engine workers launch from threads
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


__all__ = ["rmsnorm", "rmsnorm_ref"]
