"""Router for the Mamba-1 selective scan: the CUDA kernel for CUDA tensors,
the plain PyTorch version for CPU tensors.  No fallback."""
from __future__ import annotations

import threading
from typing import Tuple

import torch

from repro_torch.kernels import SSM_SCAN_BWD_ITEM, build, refuse_grad
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_SIZE = 16                   # N: the state lives in registers
THREADS = 128                     # a block: 128 / lanes channels
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
    zero state."""
    if x.device.type == "cpu":
        return ssm_scan_ref(x, dt, Bm, Cm, A)
    refuse_grad("ssm_scan", SSM_SCAN_BWD_ITEM, x, dt, Bm, Cm, A)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: no route for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssm_scan: x dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A)):
        if t.device != x.device:
            raise ValueError(f"ssm_scan: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_scan: {name} must be float32, got "
                            f"{t.dtype}")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"ssm_scan: want x and dt (B, S, DI), got "
                         f"{tuple(x.shape)} and {tuple(dt.shape)}")
    Bsz, S, DI = x.shape
    N = A.shape[-1]
    if (A.shape != (DI, N) or Bm.shape != (Bsz, S, N)
            or Cm.shape != (Bsz, S, N)):
        raise ValueError(f"ssm_scan: want Bm, Cm ({Bsz}, {S}, N) and A "
                         f"({DI}, N), got {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}, {tuple(A.shape)}")
    if N != STATE_SIZE:
        raise ValueError(f"ssm_scan: state size {N}, the kernel takes "
                         f"{STATE_SIZE}")
    # the model's Bm and Cm are column slices of one projection: copying
    # them is (B, S, 2N) floats, next to the (B, S, DI) streams
    x, dt, Bm, Cm, A = (t.contiguous() for t in (x, dt, Bm, Cm, A))
    y = torch.empty((Bsz, S, DI), dtype=torch.float32, device=x.device)
    h = torch.empty((Bsz, DI, N), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.windve_ssm_scan(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), y.data_ptr(), h.data_ptr(), _DTYPES[x.dtype], Bsz,
            S, DI, scan_lanes(Bsz, DI, sms), build.stream_handle(x.device))
    build.check(lib, err, "ssm_scan")
    with _count_lock:                 # engine workers launch from threads
        ssm_scan.launches += 1
    return y, h


ssm_scan.launches = 0


__all__ = ["ssm_scan", "ssm_scan_ref", "scan_lanes", "STATE_SIZE"]
