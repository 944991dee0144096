"""Router for fused RMSNorm: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.  No fallback.

Under autograd (grad mode on and x or the scale requiring grad) the call
goes through ``RMSNormFn``: the forward kernel and the backward kernel
(``rmsnorm_bwd``) on the card, ``rmsnorm_ref`` and ``rmsnorm_bwd_ref`` on
the CPU.  ``rmsnorm.launches`` counts forward launches and
``rmsnorm_bwd.launches`` backward ones."""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 2 ** 31 - 1            # at most a block a row, on grid.x
_count_lock = threading.Lock()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16; scale: (D,) float32.  Returns
    RMSNorm(x) * scale in x's shape and dtype, computed in fp32.

    Rows may be strided (a unit column stride is required); the result is
    contiguous.  Under autograd the call goes through ``RMSNormFn``."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFn.apply(x, scale, eps)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    return _forward(x, scale, eps)


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
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


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as (R, D) rows with a unit column stride (a view when it can)."""
    D = x.shape[-1]
    x2 = x.reshape(-1, D)         # a view when the leading dims merge
    R = x2.shape[0]
    if (D > 1 and x2.stride(1) != 1) or (R > 1 and x2.stride(0) < D):
        x2 = x2.contiguous()
    if R > MAX_ROWS:
        raise ValueError(f"rmsnorm: {R} rows, at most {MAX_ROWS}")
    return x2


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    _check(x, scale)
    D = x.shape[-1]
    x2 = _rows(x)
    R = x2.shape[0]
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


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5):
    """(dx, dscale) of ``rmsnorm`` at x and scale given the output's
    gradient dy: the backward kernel on CUDA tensors (dscale summed over
    rows in fp32, in a fixed order), ``rmsnorm_bwd_ref`` on CPU ones."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, scale, dy, eps)
    _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"must match x {tuple(x.shape)} {x.dtype}")
    D = x.shape[-1]
    x2, dy2 = _rows(x), _rows(dy)
    R = x2.shape[0]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dscale = torch.zeros((D,), dtype=torch.float32, device=x.device)
    if R == 0:
        return dx, dscale
    lib = build.load()
    part = torch.empty((lib.windve_rmsnorm_bwd_blocks(R), D),
                       dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.windve_rmsnorm_bwd(
            x2.data_ptr(), x2.stride(0) if R > 1 else D, scale.data_ptr(),
            dy2.data_ptr(), dy2.stride(0) if R > 1 else D, dx.data_ptr(),
            dscale.data_ptr(), part.data_ptr(), _DTYPES[x.dtype], R, D,
            float(eps), build.stream_handle(x.device))
    build.check(lib, err, "rmsnorm_bwd")
    with _count_lock:
        rmsnorm_bwd.launches += 1
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with a gradient: the forward and backward kernels on the
    card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cpu":
            return rmsnorm_ref(x, scale, eps)
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0


__all__ = ["rmsnorm", "rmsnorm_bwd", "RMSNormFn", "rmsnorm_ref",
           "rmsnorm_bwd_ref"]
