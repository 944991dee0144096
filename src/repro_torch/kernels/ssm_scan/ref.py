"""Plain PyTorch version of the selective-scan kernel: the Mamba-1
recurrence, one time step at a time, in fp32.

The same function as ``csrc/ssm_scan.cu``:

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
    y_t = <h_t, C_t>

from a zero state.  The CPU path runs it; on the card it is the yardstick
the kernel is held against.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, A: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (B, S, DI); Bm, Cm: (B, S, N); A: (DI, N).

    Returns (y (B, S, DI) fp32, h_final (B, DI, N) fp32)."""
    Bsz, S, DI = x.shape
    N = Bm.shape[-1]
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, Bm, Cm, A))
    h = torch.zeros((Bsz, DI, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dt_t = dtf[:, t]
        h = (h * torch.exp(dt_t[..., None] * Af)
             + (dt_t * xf[:, t])[..., None] * Bf[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    if not ys:
        return torch.zeros((Bsz, 0, DI), dtype=torch.float32,
                           device=x.device), h
    return torch.stack(ys, dim=1), h
