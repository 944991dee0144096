"""Plain PyTorch versions of the selective-scan kernels: the Mamba-1
recurrence, one time step at a time, in fp32, and its backward.

The same functions as ``csrc/ssm_scan.cu``:

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
    y_t = <h_t, C_t>

from a zero state, and the gradients of (y, h_final) by a reverse scan.
The CPU path runs them; on the card they are the yardsticks the kernels
are held against.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def ssm_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                     Cm: torch.Tensor, A: torch.Tensor, dy: torch.Tensor,
                     dh_final: Optional[torch.Tensor] = None):
    """Gradients of ``ssm_scan_ref``'s (y, h_final) at x, dt, Bm, Cm and A,
    given dy (B, S, DI) and, optionally, dh_final (B, DI, N).

    A reverse scan in fp32: with e_t = exp(dt_t A) and g_t the gradient of
    h_t, g_t = C_t dy_t + e_{t+1} g_{t+1} (from dh_final), and

        dx_t  = sum_n g_t dt_t B_t
        ddt_t = sum_n g_t (x_t B_t + A e_t h_{t-1})
        dB_t  = sum_d g_t dt_t x_t
        dC_t  = sum_d dy_t h_t
        dA    = sum_{b,t} g_t dt_t e_t h_{t-1}

    Returns (dx in x's dtype, ddt, dBm, dCm, dA), the last four fp32."""
    Bsz, S, DI = x.shape
    N = Bm.shape[-1]
    dev = x.device
    xf, dtf, Bf, Cf, Af, dyf = (t.float() for t in (x, dt, Bm, Cm, A, dy))
    h = torch.zeros((Bsz, DI, N), dtype=torch.float32, device=dev)
    hs = [h]                       # hs[t] = h_{t-1}, the state entering step t
    for t in range(S):
        dt_t = dtf[:, t]
        h = (h * torch.exp(dt_t[..., None] * Af)
             + (dt_t * xf[:, t])[..., None] * Bf[:, t, None, :])
        hs.append(h)
    G = (torch.zeros((Bsz, DI, N), dtype=torch.float32, device=dev)
         if dh_final is None else dh_final.float())   # e_{t+1} g_{t+1}
    dx = torch.zeros((Bsz, S, DI), dtype=torch.float32, device=dev)
    ddt = torch.zeros_like(dx)
    dB = torch.zeros((Bsz, S, N), dtype=torch.float32, device=dev)
    dC = torch.zeros_like(dB)
    dA = torch.zeros((DI, N), dtype=torch.float32, device=dev)
    for t in reversed(range(S)):
        dt_t, x_t = dtf[:, t], xf[:, t]
        e = torch.exp(dt_t[..., None] * Af)
        g = Cf[:, t, None, :] * dyf[:, t, :, None] + G
        s1 = (g * Bf[:, t, None, :]).sum(-1)
        q = g * e * hs[t]
        dx[:, t] = dt_t * s1
        ddt[:, t] = x_t * s1 + (q * Af).sum(-1)
        dB[:, t] = (g * (dt_t * x_t)[..., None]).sum(1)
        dC[:, t] = (dyf[:, t, :, None] * hs[t + 1]).sum(1)
        dA += (dt_t[..., None] * q).sum(0)
        G = e * g
    return dx.to(x.dtype), ddt, dB, dC, dA
