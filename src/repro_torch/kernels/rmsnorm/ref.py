"""Plain PyTorch version of the RMSNorm kernel.

The same function as ``csrc/rmsnorm.cu``: the mean square of each row in
fp32, ``rsqrt(ms + eps)``, times the fp32 scale, cast back to the input's
dtype.  The CPU path runs it; on the card it is the yardstick the kernel is
held against.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,).  Returns x's shape and dtype."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
