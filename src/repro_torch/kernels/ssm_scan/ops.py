"""Router for the Mamba-1 selective scan: the CUDA kernels for CUDA
tensors, the plain PyTorch versions for CPU tensors.  No fallback.

Under autograd (grad mode on and an input requiring grad) the call goes
through ``SSMScanFn``: on the card the forward kernel, which also saves the
state entering every ``CHUNK``-step chunk, then the backward kernel
(``ssm_scan_bwd``); on the CPU ``ssm_scan_ref`` and ``ssm_scan_bwd_ref``.
``ssm_scan.launches`` counts forward launches and ``ssm_scan_bwd.launches``
backward ones."""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZE = 16                   # N: the state lives in registers
THREADS = 128                     # a block: 128 / lanes channels
CHUNK = 16                        # steps a saved state covers (csrc CHUNK)
_count_lock = threading.Lock()


def scan_lanes(B: int, DI: int, sms: int) -> int:
    """Lanes a channel for the kernel on a card of ``sms`` SMs: 2 where its
    grid of B x DI / 64 blocks gives every SM four, else 8.  2 lanes take
    fewer shared-memory reads and shuffles a channel's step, 8 a shorter
    chain a lane: hymba-1.5b's prefill (B 16, DI 3200) takes 2, the
    1100-token prompt at B 2 takes 8."""
    return 2 if -(-DI // (THREADS // 2)) * B >= 4 * sms else 8


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, A: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, DI) float32 or bfloat16; dt: (B, S, DI), Bm, Cm: (B, S, N)
    and A: (DI, N), all float32, with N = 16 on the card.  Returns
    (y (B, S, DI) fp32, h_final (B, DI, N) fp32), the recurrence run from a
    zero state.  Under autograd the call goes through ``SSMScanFn``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, Bm, Cm, A)):
        return SSMScanFn.apply(x, dt, Bm, Cm, A)
    if x.device.type == "cpu":
        return ssm_scan_ref(x, dt, Bm, Cm, A)
    return _forward(x, dt, Bm, Cm, A, False)[:2]


def _check(x, dt, Bm, Cm, A, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no route for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got "
                            f"{t.dtype}")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"{what}: want x and dt (B, S, DI), got "
                         f"{tuple(x.shape)} and {tuple(dt.shape)}")
    Bsz, S, DI = x.shape
    N = A.shape[-1]
    if (A.shape != (DI, N) or Bm.shape != (Bsz, S, N)
            or Cm.shape != (Bsz, S, N)):
        raise ValueError(f"{what}: want Bm, Cm ({Bsz}, {S}, N) and A "
                         f"({DI}, N), got {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}, {tuple(A.shape)}")
    if N != STATE_SIZE:
        raise ValueError(f"{what}: state size {N}, the kernel takes "
                         f"{STATE_SIZE}")


def _forward(x, dt, Bm, Cm, A, states: bool):
    """The forward kernel: (y, h_final, the states entering each chunk
    (B, ceil(S / CHUNK), DI, N) fp32 when ``states``, else None, the inputs
    as the kernel read them)."""
    _check(x, dt, Bm, Cm, A, "ssm_scan")
    # the model's Bm and Cm are column slices of one projection: copying
    # them is (B, S, 2N) floats, next to the (B, S, DI) streams
    x, dt, Bm, Cm, A = (t.contiguous() for t in (x, dt, Bm, Cm, A))
    Bsz, S, DI = x.shape
    N = STATE_SIZE
    y = torch.empty((Bsz, S, DI), dtype=torch.float32, device=x.device)
    h = torch.empty((Bsz, DI, N), dtype=torch.float32, device=x.device)
    hs = (torch.empty((Bsz, -(-S // CHUNK), DI, N), dtype=torch.float32,
                      device=x.device) if states else None)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.windve_ssm_scan(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), y.data_ptr(), h.data_ptr(),
            hs.data_ptr() if states else None, _DTYPES[x.dtype], Bsz, S, DI,
            scan_lanes(Bsz, DI, sms), build.stream_handle(x.device))
    build.check(lib, err, "ssm_scan")
    with _count_lock:                 # engine workers launch from threads
        ssm_scan.launches += 1
    return y, h, hs, (x, dt, Bm, Cm, A)


def ssm_scan_bwd(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, A: torch.Tensor, dy: torch.Tensor,
                 dh_final: Optional[torch.Tensor] = None,
                 states: Optional[torch.Tensor] = None):
    """(dx, ddt, dBm, dCm, dA) of ``ssm_scan`` at x, dt, Bm, Cm and A given
    dy (B, S, DI) fp32 and, optionally, dh_final (B, DI, N) fp32: the
    backward kernel on CUDA tensors, which needs the forward kernel's chunk
    states ``states`` (dB, dC and dA summed in a fixed order, so two calls
    give the same bits); ``ssm_scan_bwd_ref`` on CPU ones.  dx comes back
    in x's dtype, the rest in fp32."""
    if x.device.type == "cpu":
        return ssm_scan_bwd_ref(x, dt, Bm, Cm, A, dy, dh_final)
    _check(x, dt, Bm, Cm, A, "ssm_scan_bwd")
    Bsz, S, DI = x.shape
    N = STATE_SIZE
    want = {"dy": (dy, (Bsz, S, DI)),
            "states": (states, (Bsz, -(-S // CHUNK), DI, N))}
    if dh_final is not None:
        want["dh_final"] = (dh_final, (Bsz, DI, N))
    for name, (t, shape) in want.items():
        if t is None or t.shape != shape or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(f"ssm_scan_bwd: want {name} float32 {shape} on "
                             f"{x.device}")
    x, dt, Bm, Cm, A, dy, states = (
        t.contiguous() for t in (x, dt, Bm, Cm, A, dy, states))
    if dh_final is not None:
        dh_final = dh_final.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bsz, S, DI), **f32)
    dB = torch.empty((Bsz, S, N), **f32)
    dC = torch.empty((Bsz, S, N), **f32)
    dA = torch.empty((DI, N), **f32)
    lib = build.load()
    blocks = -(-DI // lib.windve_ssm_scan_bwd_channels())
    part = torch.empty((2, blocks, Bsz, S, N), **f32)
    dA_part = torch.empty((Bsz, DI, N), **f32)
    with torch.cuda.device(x.device):
        err = lib.windve_ssm_scan_bwd(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), dy.data_ptr(),
            dh_final.data_ptr() if dh_final is not None else None,
            states.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), dA.data_ptr(), part.data_ptr(),
            dA_part.data_ptr(), _DTYPES[x.dtype], Bsz, S, DI,
            build.stream_handle(x.device))
    build.check(lib, err, "ssm_scan_bwd")
    with _count_lock:
        ssm_scan_bwd.launches += 1
    return dx, ddt, dB, dC, dA


class SSMScanFn(torch.autograd.Function):
    """The selective scan with a gradient: the forward kernel (saving its
    chunk states) and the backward kernel on the card, the plain versions
    on the CPU."""

    @staticmethod
    def forward(ctx, x, dt, Bm, Cm, A):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            y, h = ssm_scan_ref(x, dt, Bm, Cm, A)
            ctx.save_for_backward(x, dt, Bm, Cm, A)
        else:
            y, h, states, inputs = _forward(x, dt, Bm, Cm, A, True)
            ctx.save_for_backward(*inputs, states)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, Bm, Cm, A, *states = ctx.saved_tensors
        if dy is None:                # only h_final was used
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return ssm_scan_bwd(x, dt, Bm, Cm, A, dy, dh,
                            states[0] if states else None)


ssm_scan.launches = 0
ssm_scan_bwd.launches = 0


__all__ = ["ssm_scan", "ssm_scan_bwd", "SSMScanFn", "ssm_scan_ref",
           "ssm_scan_bwd_ref", "scan_lanes", "STATE_SIZE", "CHUNK"]
