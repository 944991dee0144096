"""Plain PyTorch versions of the int8 projection kernels.

Weight-only (``quant_matmul_ref``): float activations times int8 weights
with fp32 accumulation, the per-output-channel scale applied once after the
contraction (symmetric quantization has no zero point, so
``x @ (w8 * s) == (x @ w8) * s`` in real arithmetic).

W8A8: ``quantize_activations`` gives per-row symmetric int8 activations;
``w8a8_matmul_ref`` contracts int8 x int8 exactly and dequantizes once by
``acc * x_scale[..., None] * w_scale``.
"""
from __future__ import annotations

import torch

from repro_torch.models.quantize import FLT_MIN, div127, flush_subnormals


def _check_int8(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.int8:
        raise TypeError(f"quantized {what} must be int8, got {t.dtype}")


def quantize_activations(x: torch.Tensor):
    """Per-row dynamic symmetric int8 quantization of ``x: (..., K)``.

    Returns ``(x8, scale)``: ``x8`` int8 of x's shape and ``scale`` fp32 of
    shape ``x.shape[:-1]`` with ``x8 * scale[..., None] ~= x``.  An all-zero
    row gets scale 1 (its int8 row is zero); a row whose amax / 127 is
    subnormal gets scale FLT_MIN, so ``x / scale`` stays within the clip.
    Subnormal inputs count as zero (``quantize.flush_subnormals``).  True
    division, round half to even: the int8 values and scales equal the
    JAX package's bit for bit."""
    xf = flush_subnormals(x.float())
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(div127(amax), FLT_MIN)
    scale = torch.where(amax > 0, scale, torch.ones_like(scale))
    x8 = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return x8.to(torch.int8), scale


def quant_matmul_ref(x: torch.Tensor, w8: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x: (..., K) float; w8: (K, N) int8; scale: (N,) -> (..., N) in x's
    dtype.  Every int8 value and every bf16 x is exact in fp32, and so is
    their product, so contracting in fp32 is the reference's fp32
    accumulation of ``x @ w8.astype(x.dtype)``."""
    _check_int8(w8, "weights")
    acc = x.float() @ w8.float()
    return (acc * scale.float()).to(x.dtype)


def w8a8_matmul_ref(x8: torch.Tensor, w8: torch.Tensor,
                    x_scale: torch.Tensor, w_scale: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x8: (..., K) int8; w8: (K, N) int8; x_scale: x8.shape[:-1];
    w_scale: (N,) -> (..., N) in ``out_dtype``.

    The integer product is formed in float64, where every partial sum of
    int8 products is an integer below 2^53 and so exact: it is the int32
    accumulation of the kernel, on any device (the card's matmul takes no
    integer types).  Then the reference's epilogue, in its order:
    ``(acc * x_scale) * w_scale`` in fp32."""
    _check_int8(x8, "activations")
    _check_int8(w8, "weights")
    acc = (x8.double() @ w8.double()).float()
    out = acc * x_scale[..., None].float() * w_scale.float()
    return out.to(out_dtype)
