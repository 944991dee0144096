"""Routers for the int8 projection kernels: the CUDA kernels for CUDA
tensors, the plain PyTorch versions for CPU tensors.

There is no fallback: a CUDA tensor the kernel does not take raises, and a
kernel that fails to build or launch raises.

- ``quant_matmul(x, w8, scale)``: the weight-only projection of the
  ``int8`` policy (one kernel launch).
- ``quant_matmul_w8a8(x, w8, w_scale)``: the W8A8 projection,
  ``quantize_rows`` then ``w8a8_matmul`` (two launches, each counted by its
  own wrapper).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import SERVING_BWD_ITEM, build, refuse_grad
from repro_torch.kernels.quant_matmul.ref import (_check_int8,
                                                  quant_matmul_ref,
                                                  quantize_activations,
                                                  w8a8_matmul_ref)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# an int32 sum of K products of two int8 values in [-127, 127] is exact
# while K * 127^2 < 2^31
MAX_W8A8_K = 133_000
# row tiles ride grid.y (at most 65535 of them): 128 rows a tile in
# quant_matmul, 128 or 64 in w8a8_matmul (so 64 sets its limit)
MAX_M = {"quant_matmul": 65535 * 128, "w8a8_matmul": 65535 * 64}
_count_lock = threading.Lock()


def _count(fn) -> None:
    with _count_lock:                 # engine workers launch from threads
        fn.launches += 1


def _rows(x: torch.Tensor):
    """``x`` (..., K) as (M, K) with a unit column stride, and its row
    stride.  ``reshape`` is a view when the leading dims merge (the
    projection inputs of ``layers.attn_forward`` and ``apply_mlp`` do);
    otherwise it copies.  The kernels take the row stride, so a row-strided
    view is read as it is; a view whose columns are strided, or whose rows
    overlap, is copied by ``contiguous`` first."""
    x2 = x.reshape(-1, x.shape[-1])
    M, K = x2.shape
    if (K > 1 and x2.stride(1) != 1) or (M > 1 and x2.stride(0) < K):
        x2 = x2.contiguous()
    return x2, (x2.stride(0) if M > 1 else K)


def _check_weight(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                  what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no route for device {x.device}")
    _check_int8(w8, "weights")
    for name, t in (("w8", w8), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
    if w8.dim() != 2 or w8.shape[0] != x.shape[-1]:
        raise ValueError(f"{what}: want w8 (K, N) with K = {x.shape[-1]}, "
                         f"got {tuple(w8.shape)}")
    if scale.shape != (w8.shape[1],):
        raise ValueError(f"{what}: want scale ({w8.shape[1]},), got "
                         f"{tuple(scale.shape)}")
    if scale.dtype != torch.float32:
        raise TypeError(f"{what}: scale must be float32, got {scale.dtype}")
    if not (w8.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{what}: w8 and scale must be contiguous (a layer "
                         f"of the stacked tree is), strides {w8.stride()}, "
                         f"{scale.stride()}")


def _check_m(M: int, what: str) -> None:
    if M > MAX_M[what]:
        raise ValueError(f"{what}: {M} rows, at most {MAX_M[what]}")


def quant_matmul(x: torch.Tensor, w8: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x: (..., K) float32 or bfloat16; w8: (K, N) int8; scale: (N,) fp32
    -> (..., N) in x's dtype: ``(x @ w8) * scale`` with fp32 accumulation."""
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w8, scale)
    refuse_grad("quant_matmul", SERVING_BWD_ITEM, x, scale)
    _check_weight(x, w8, scale, "quant_matmul")
    if x.dtype not in _DTYPES:
        raise TypeError(f"quant_matmul: dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    x2, ldx = _rows(x)
    (M, K), N = x2.shape, w8.shape[1]
    _check_m(M, "quant_matmul")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(*x.shape[:-1], N)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.windve_quant_matmul(
            x2.data_ptr(), ldx, w8.data_ptr(), scale.data_ptr(),
            out.data_ptr(), _DTYPES[x.dtype], M, N, K,
            build.stream_handle(x.device))
    build.check(lib, err, "quant_matmul")
    _count(quant_matmul)
    return out.reshape(*x.shape[:-1], N)


def quantize_rows(x: torch.Tensor):
    """x: (..., K) float32 or bfloat16 -> (x8 int8 (..., K), scale fp32
    (...)), per-row symmetric (``ref.quantize_activations``), bit for bit
    the same on the card as the plain version."""
    if x.device.type == "cpu":
        return quantize_activations(x)
    refuse_grad("quantize_rows", SERVING_BWD_ITEM, x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: no route for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize_rows: dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    x2, ldx = _rows(x)
    M, K = x2.shape
    x8 = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    if x8.numel() == 0:
        return x8.reshape(x.shape), scale.reshape(x.shape[:-1])
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.windve_quantize_rows(
            x2.data_ptr(), ldx, x8.data_ptr(), scale.data_ptr(),
            _DTYPES[x.dtype], M, K, build.stream_handle(x.device))
    build.check(lib, err, "quantize_rows")
    _count(quantize_rows)
    return x8.reshape(x.shape), scale.reshape(x.shape[:-1])


def w8a8_matmul(x8: torch.Tensor, w8: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x8: (..., K) int8; w8: (K, N) int8; x_scale: x8.shape[:-1] fp32;
    w_scale: (N,) fp32 -> (..., N) in ``out_dtype``: the exact int32 product
    ``x8 @ w8``, then ``(acc * x_scale) * w_scale`` in fp32."""
    if x8.device.type == "cpu":
        return w8a8_matmul_ref(x8, w8, x_scale, w_scale, out_dtype)
    refuse_grad("w8a8_matmul", SERVING_BWD_ITEM, x_scale, w_scale)
    _check_int8(x8, "activations")
    _check_weight(x8, w8, w_scale, "w8a8_matmul")
    if out_dtype not in _DTYPES:
        raise TypeError(f"w8a8_matmul: out_dtype {out_dtype} not supported "
                        f"(float32 or bfloat16)")
    x2, ldx = _rows(x8)
    (M, K), N = x2.shape, w8.shape[1]
    if K > MAX_W8A8_K:
        raise ValueError(f"w8a8_matmul: K = {K} > {MAX_W8A8_K}: the int32 "
                         f"sum of K int8 products could overflow")
    _check_m(M, "w8a8_matmul")
    if x_scale.shape != x8.shape[:-1] or x_scale.device != x8.device:
        raise ValueError(f"w8a8_matmul: want x_scale {tuple(x8.shape[:-1])} "
                         f"on {x8.device}, got {tuple(x_scale.shape)} on "
                         f"{x_scale.device}")
    if x_scale.dtype != torch.float32:
        raise TypeError(f"w8a8_matmul: x_scale must be float32, got "
                        f"{x_scale.dtype}")
    xs = x_scale.reshape(-1).contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x8.device)
    if out.numel() == 0:
        return out.reshape(*x8.shape[:-1], N)
    lib = build.load()
    with torch.cuda.device(x8.device):
        err = lib.windve_w8a8_matmul(
            x2.data_ptr(), ldx, w8.data_ptr(), xs.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), _DTYPES[out_dtype], M, N, K,
            build.stream_handle(x8.device))
    build.check(lib, err, "w8a8_matmul")
    _count(w8a8_matmul)
    return out.reshape(*x8.shape[:-1], N)


def quant_matmul_w8a8(x: torch.Tensor, w8: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """x: (..., K) float; w8: (K, N) int8; w_scale: (N,) fp32 -> (..., N) in
    x's dtype: per-row int8 activations (``quantize_rows``), then the int8 x
    int8 product with int32 accumulation (``w8a8_matmul``).  The quantize
    step stays its own launch: a row's scale needs the row's amax over all
    of K before its first product, so a fused prologue would re-read every
    row of x once per column tile."""
    x8, x_scale = quantize_rows(x)
    return w8a8_matmul(x8, w8, x_scale, w_scale, out_dtype=x.dtype)


quant_matmul.launches = 0
quantize_rows.launches = 0
w8a8_matmul.launches = 0


__all__ = ["quant_matmul", "quant_matmul_w8a8", "quantize_rows",
           "w8a8_matmul", "quant_matmul_ref", "w8a8_matmul_ref",
           "quantize_activations", "MAX_W8A8_K"]
