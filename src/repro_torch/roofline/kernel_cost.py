"""The work of each hand-written kernel: ``(flops, bytes)`` from its shapes
and from the counts its inputs need.

One function a kernel (a wrapper of ``repro_torch.kernels``).  Each counts
what the function must do on its inputs, as one fused op: every input it
needs read once and every output written once (bytes), and the useful
operations (flops: 2 a multiply-add of a product, the elementwise work of
a norm or a scan).  How a kernel runs them (fp32 attention as six bf16
products of an exact split, exps on the special-function units) is the
caller's to weigh: ``chip_smoke.py``'s bounds do that, and call these
with the valid (query, key) pairs, rows and slots they count on their
inputs; the dry run (``roofline.op_cost``) calls them from the routers'
meta branches with the counts that the shapes, ``causal``, ``window`` and
the decode position imply (``attention_pairs``, ``decode_slots``).

A router's meta branch reports its call here (``report``); the cost mode
of ``roofline.op_cost`` listens while it traces a step.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Tuple

import numpy as np

CHUNK = 16                    # the scan's saved-state stride (csrc CHUNK)

_SINKS: List[Callable[[str, float, float], None]] = []


def report(name: str, flops: float, nbytes: float) -> None:
    """One call of kernel ``name`` doing ``flops`` and moving ``nbytes``,
    seen by every listening cost mode (none: nothing happens)."""
    for sink in _SINKS:
        sink(name, flops, nbytes)


def listen(sink: Callable[[str, float, float], None]) -> None:
    _SINKS.append(sink)


def unlisten(sink: Callable[[str, float, float], None]) -> None:
    _SINKS.remove(sink)


# ---------------------------------------------------------------- counts --
@functools.lru_cache(maxsize=256)
def attention_pairs(Sq: int, Sk: int, causal: bool, window: int
                    ) -> Tuple[int, int, int]:
    """(valid (query, key) pairs, queries with a valid key, keys some query
    sees) of one batch row whose keys are all valid, under the kernels'
    mask: key kp is seen by query qp when kp <= qp (causal) and kp > qp -
    window (a window)."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Sk - 1, q) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(Sq, np.int64)
    n = np.clip(hi - lo + 1, 0, None)
    rows = n > 0
    seen = np.zeros(Sk + 1, np.int64)
    np.add.at(seen, lo[rows], 1)
    np.add.at(seen, hi[rows] + 1, -1)
    return int(n.sum()), int(rows.sum()), int((np.cumsum(seen)[:Sk] > 0).sum())


def decode_slots(Sc: int, pos: int, window: int) -> int:
    """Valid slots of a decode read at position ``pos`` over an ``Sc``-slot
    cache whose slots hold the latest positions up to ``pos``."""
    n = min(pos + 1, Sc)
    return max(0, min(n, window) if window else n)


# --------------------------------------------------------------- kernels --
def flash_attention(B: int, H: int, KV: int, Sq: int, Sk: int, hd: int,
                    esize: int, pairs: int, q_rows: int, kv_rows: int,
                    lse: bool = False) -> Tuple[float, float]:
    """q rows with a valid key, every output row (a row with none is
    written as zeros), k and v rows some query sees, kv_len, and the fp32
    lse when asked; QK^T and PV over the ``pairs`` valid pairs (counts
    over the batch: ``q_rows`` and ``kv_rows`` of (B, S), ``pairs`` of
    (B, Sq, Sk))."""
    nbytes = ((H * q_rows + B * H * Sq + 2 * KV * kv_rows) * hd * esize
              + 4 * B + (4 * B * H * Sq if lse else 0))
    return 4 * hd * H * pairs, nbytes


def flash_attention_bwd(B: int, H: int, KV: int, Sq: int, Sk: int, hd: int,
                        esize: int, pairs: int) -> Tuple[float, float]:
    """Reads q, o, dO, k, v and the lse once, writes dq, dk and dv once;
    five products a valid pair a head (q k^T, dO v^T, dV, dK, dQ)."""
    nbytes = ((4 * B * H * Sq + 4 * B * KV * Sk) * hd * esize
              + 4 * B * H * Sq + 4 * B)
    return 10 * hd * H * pairs, nbytes


def pool_norm(B: int, S: int, D: int, esize: int, pool: str,
              rows: int) -> Tuple[float, float]:
    """Mean: the ``rows`` unmasked tokens' hidden rows, the mask, the
    output.  CLS: token 0 of the ``rows`` rows whose first token is
    unmasked, the mask's first column, the output."""
    if pool == "mean":
        return (2 * rows * D + 3 * B * D,
                rows * D * esize + 4 * B * S + 4 * B * D)
    return 4 * B * D, rows * D * esize + 4 * B + 4 * B * D


def quant_matmul(M: int, K: int, N: int, esize: int) -> Tuple[float, float]:
    """x (M, K) and the output in x's dtype, int8 weights, fp32 scales."""
    return 2 * M * K * N, esize * (M * K + M * N) + K * N + 4 * N


def quantize_rows(M: int, K: int, esize: int) -> Tuple[float, float]:
    """Reads x, writes int8 x and a scale a row; a max, a divide and a
    round a value."""
    return 3 * M * K, (esize + 1) * M * K + 4 * M


def w8a8_matmul(M: int, K: int, N: int, out_esize: int
                ) -> Tuple[float, float]:
    """int8 x and weights, both scales, the output in its dtype."""
    return (2 * M * K * N,
            M * K + K * N + 4 * M + 4 * N + out_esize * M * N)


def rmsnorm(R: int, D: int, esize: int) -> Tuple[float, float]:
    """Reads x and the scale once, writes the output once; a square-add
    and two multiplies an element."""
    return 3 * R * D, 2 * R * D * esize + 4 * D


def rmsnorm_bwd(R: int, D: int, esize: int) -> Tuple[float, float]:
    """Reads x, dy and the scale once, writes dx and dscale once; about 8
    flops an element (two sums, dx, the scale's partial)."""
    return 8 * R * D, 3 * R * D * esize + 8 * D


def flash_decode(B: int, KV: int, G: int, hd: int, Sc: int, slots: int,
                 q_esize: int, c_esize: int, lse: bool = False
                 ) -> Tuple[float, float]:
    """q and the output once, the k and v rows of the ``slots`` valid
    slots once, kpos, and the fp32 lse when asked; QK and PV over the
    valid slots."""
    nbytes = (2 * B * KV * G * hd * q_esize + 2 * B * KV * slots * hd * c_esize
              + 4 * Sc + (4 * B * KV * G if lse else 0))
    return 4 * B * KV * G * hd * slots, nbytes


def ssm_scan(B: int, S: int, DI: int, N: int, esize: int,
             states: bool = False) -> Tuple[float, float]:
    """x, dt and y stream once, B and C once, A, h written once (and the
    state entering each CHUNK-step chunk, when saved for the backward).
    A (b, t, d, n) takes six fp32 flops (dt * A, h's FMA, dx * B, the FMA
    with C) and one exp (``ssm_scan_exps``); a (b, t, d) one more
    (dt * x)."""
    nbytes = (B * S * DI * (esize + 8) + 8 * B * S * N + 4 * DI * N
              + 4 * B * DI * N
              + (4 * B * -(-S // CHUNK) * DI * N if states else 0))
    return B * S * DI * (6 * N + 1), nbytes


def ssm_scan_exps(B: int, S: int, DI: int, N: int) -> float:
    """The scan's exps, forward or backward: one a (b, t, d, n)."""
    return B * S * DI * N


def ssm_scan_bwd(B: int, S: int, DI: int, N: int, esize: int,
                 dh: bool) -> Tuple[float, float]:
    """Reads x, dt and dy, writes dx and ddt ((B, S, DI) streams); reads B,
    C, writes dB, dC; reads A, dh_final (``dh``) and the forward's chunk
    states, writes dA.  A (b, t, d, n) takes 19 fp32 flops (the recompute
    5, the reverse step 10, the sums over n and d 4) and one exp; a (b,
    t, d) 5 more."""
    nbytes = (B * S * DI * (2 * esize + 12) + 16 * B * S * N + 8 * DI * N
              + 4 * B * -(-S // CHUNK) * DI * N
              + (4 * B * DI * N if dh else 0))
    return 19 * B * S * DI * N + 5 * B * S * DI, nbytes


def on_meta(name: str, cost: Tuple[float, float], out):
    """A router's meta branch: report one call of ``name`` with its
    ``cost`` and hand back ``out``, the empty outputs."""
    report(name, *cost)
    return out


__all__ = ["report", "listen", "unlisten", "on_meta", "attention_pairs",
           "decode_slots", "flash_attention", "flash_attention_bwd",
           "pool_norm", "quant_matmul", "quantize_rows", "w8a8_matmul",
           "rmsnorm", "rmsnorm_bwd", "flash_decode", "ssm_scan",
           "ssm_scan_exps", "ssm_scan_bwd"]
