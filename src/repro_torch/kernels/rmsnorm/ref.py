"""Plain PyTorch version of the RMSNorm kernel and of its backward.

The same functions as ``csrc/rmsnorm.cu``: the mean square of each row in
fp32, ``rsqrt(ms + eps)``, times the fp32 scale, cast back to the input's
dtype; and the backward's dx and dscale from x, the scale and dy.  The CPU
path runs them; on the card they are the yardsticks the kernels are held
against.  They compute in fp32, or in float64 for float64 inputs (the
tests' oracle).
"""
from __future__ import annotations

import torch


def _acc(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,).  Returns x's shape and dtype."""
    xf = _acc(x)
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * _acc(scale)).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5):
    """(dx, dscale) of ``rmsnorm_ref`` at x (..., D) and scale (D,) given
    the output's gradient dy (x's shape):

        r = rsqrt(mean(x^2) + eps),  g = dy * scale,
        dx = r * (g - x * r^2 * mean(g * x)),
        dscale = sum over rows of dy * x * r,

    dx in x's dtype, dscale in the scale's."""
    xf, dyf = _acc(x), _acc(dy)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    g = dyf * _acc(scale)
    dx = r * (g - xf * (r * r) * (g * xf).mean(-1, keepdim=True))
    dscale = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
