#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of WindVE on one NVIDIA card and check it.

    python3 chip_smoke.py                    # every phase, needs one card
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --rehearse         # CPU rehearsal at smoke size

Phases, each printing one JSON line; any failed phase makes the script exit
non-zero:

  build    compile src/repro_torch/csrc/*.cu with nvcc for sm_90a (one nvcc
           per source, all started together) into one library; ptxas's
           report (registers, spills, shared memory) goes to --ptxas-log.
  kernels  each kernel against its plain PyTorch version on the same inputs
           on the card, with its time, the plain version's, one PyTorch
           library call's (a yardstick the port never calls) and the bound.
           Every row of the summary also carries a `cases` map: attention
           in fp32 and bf16 at bge's and hymba's prefill shapes (S 64 and
           the 1100-token prompt), mean pooling in fp32 and bf16, the three
           bge projections in fp32 and w_in in bf16 (weight-only and W8A8),
           quantize_rows at K 1024 and 4096 (with `x.to(torch.int8)`
           beside it, a yardstick for the same bytes), rmsnorm at hymba's
           prefill and decode rows in fp32 and bf16, the scan at hymba's
           prefill and at the 1100-token prompt with bf16 and fp32 x, and
           decode attention at the served shape in the three (q, cache)
           pairs, on a 1024-slot ring and at starcoder2-7b's G 9 x hd 128.
  golden   tests/golden/golden_embed.npz through params_from_numpy and
           ShardedEmbedderBackend: fp32 within 1e-5 max-abs of the golden
           vectors, bf16 and int8 within 1e-2 cosine distance, int8_w8a8
           within 2e-2.
  serve    build_engine + WindVE.submit at full width: bge-large-zh-v1.5
           (24 x 1024) in fp32, bf16, int8 and int8_w8a8, and jina-v2 in
           fp32 (mean pooling).  Launch counts are zeroed just before this
           phase and read just after it; every embedding kernel must have
           run, and quantize_rows 4 times for every 6 w8a8_matmul launches
           (q, k and v share one quantized input).
  generate launch/serve_llm's engine for hymba-1.5b at full width (32
           layers, d_model 1600, random weights): 32 prompts of 64 tokens
           in two waves of 16, 16 greedy tokens each.  Launch counts are
           zeroed just before the engine is built and read just after the
           last answer: rmsnorm, flash_attention, ssm_scan and flash_decode
           must have run.  Then, off the counted path: teacher-forced
           logits of the kernel path against the plain versions on the
           card (cosine >= 0.99 at every step), and decode-step logits
           against a fresh prefill of the longer prompt (cosine >= 0.99),
           with 64-token prompts and with a 1100-token prompt that wraps
           the 1024-slot ring.
  profile  (only when named) one bge forward at B=16 x S=96 under each
           policy, and one hymba prefill (B=16 x S=64) and decode step:
           host clock, enqueue time, device busy time from a
           torch.profiler trace, kernels per step and the top kernels.

Times are CUDA-event timings: one warm-up call, then the median over
repetitions of a run of back-to-back launches queued behind a device-side
sleep, so the host's launch cost stays out of the device time.  Then the
card's name and power limit, the kernels summary line and, last, the
result line.  With no card, or with the package missing, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("build", "kernels", "golden", "serve", "generate")
EXTRA_PHASES = ("profile",)          # run only when named in --phases
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,      # fp32 outside the tensor cores
              "bfloat16": 989e12,    # dense bf16 tensor cores
              "int8": 1979e12}       # dense int8 tensor cores
SFU_PER_CLOCK = 16                   # MUFU.EX2 results a clock an SM (sm_90)
H100_SMS, H100_MAX_SM_MHZ = 132, 1980  # data sheet, where no card is read
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
PN_SOURCE = "src/repro_torch/csrc/pool_norm.cu"
QM_SOURCE = "src/repro_torch/csrc/quant_matmul.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:111"
PN_REPLACES = "src/repro/kernels/pool_norm/pool_norm.py:45"
QM_REPLACES = "src/repro/kernels/quant_matmul/quant_matmul.py:111"
W8_REPLACES = "src/repro/kernels/quant_matmul/quant_matmul.py:182"
# quantize_rows replaces the jnp prologue w8a8_matmul_pallas is fed by
QR_REPLACES = "src/repro/kernels/quant_matmul/quant_matmul.py:47"
RN_SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
FD_SOURCE = "src/repro_torch/csrc/flash_decode.cu"
SS_SOURCE = "src/repro_torch/csrc/ssm_scan.cu"
RN_REPLACES = "src/repro/kernels/rmsnorm/rmsnorm.py:35"
FD_REPLACES = "src/repro/kernels/flash_decode/flash_decode.py:88"
SS_REPLACES = "src/repro/kernels/ssm_scan/ssm_scan.py:74"
# the main path's attention and epilogue shapes: bge-large-zh-v1.5 at
# batch 16 and the 96-token window
MAIN_B, MAIN_S, MAIN_H, MAIN_HD, MAIN_D = 16, 96, 16, 64, 1024
# its projections (K, N): q/k/v/o, w_in, w_out; the summary line shows w_in
MAIN_KN = ((1024, 1024), (1024, 4096), (4096, 1024))
MAIN_F = 4096
POLICIES = ("fp32", "bf16", "int8", "int8_w8a8")
# what the embedding path launches (bge and jina use layernorm)
EMBED_KERNELS = ("flash_attention", "pool_norm", "quant_matmul",
                 "quantize_rows", "w8a8_matmul")
# the LM path: hymba-1.5b, batches of 16 prompts of 64 tokens, 16 new
# tokens, so the decode cache holds 80 slots; its shapes below
LM_ARCH, LM_B, LM_PROMPT, LM_NEW = "hymba-1.5b", 16, 64, 16
LM_D, LM_KV, LM_G, LM_HD, LM_DI, LM_N = 1600, 5, 5, 64, 3200, 16
LONG_PROMPT = 1100                   # > the 1024-token window: the ring wraps
COSINE_BAR = 0.99


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


# ----------------------------------------------------------------------------
# timing and bounds
# ----------------------------------------------------------------------------

def time_ms(fn, dev, reps: int = 15, inner: int = 10) -> float:
    """Median device milliseconds of one call of ``fn``."""
    import torch

    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        return (time.perf_counter() - t0) * 1e3 / inner
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        # a device-side sleep lets the host queue all `inner` launches, so
        # they run back to back and the events time the device alone
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype_name: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sm_clock_mhz() -> tuple:
    """(the card's maximum SM clock in MHz, where it came from)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0]), "nvidia-smi clocks.max.sm"
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return float(H100_MAX_SM_MHZ), "H100 SXM data sheet"


def sfu_rate(dev) -> dict:
    """Special-function results (exp2) a second: SMs x 16 a clock x the
    maximum SM clock, read from the card."""
    import torch

    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    mhz, source = sm_clock_mhz()
    return {"sms": sms, "sm_clock_mhz": mhz, "sm_clock_source": source,
            "per_s": sms * SFU_PER_CLOCK * mhz * 1e6}


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------

def phase_build(args) -> dict:
    from repro_torch.kernels import build

    t0 = time.monotonic()
    build.load(verbose=True)
    info = dict(build.last_build)
    log = info.pop("log", "")
    path = os.path.join(ROOT, args.ptxas_log)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(log)
    lines = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    return {"build_seconds": time.monotonic() - t0, **info,
            "ptxas": lines[:24]}


def _attn_inputs(dev, B, H, KV, S, hd, dt, kv_len, seed=0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KV, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KV, hd), np.float32))
    # (B, S, heads, hd) projections seen as (B, heads, S, hd), as
    # models.layers.attn_forward passes them
    q, k, v = (t.to(dev, dt).transpose(1, 2) for t in (q, k, v))
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return q, k, v, kvl


def attention_case(dev, B, H, KV, S, hd, dt, kv_len, *, causal=False,
                   window=0) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_mask

    q, k, v, kvl = _attn_inputs(dev, B, H, KV, S, hd, dt, kv_len)
    kw = dict(causal=causal, window=window, kv_len=kvl)
    got = flash_attention(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    zero_rows = [b for b, n in enumerate(kv_len) if n == 0]
    finite = bool(torch.isfinite(got).all().item())
    zeros_ok = all(bool((got[b] == 0).all().item()) for b in zero_rows)
    out = {"B": B, "H": H, "KV": KV, "S": S, "hd": hd, "dtype": dtype_name(dt),
           "causal": causal, "window": window, "kv_len": list(kv_len),
           "max_abs_err": err, "tol": tol, "finite": finite,
           "kv_len0_rows_zero": zeros_ok,
           "ok": err <= tol and finite and zeros_ok}
    # what these inputs need: q rows with at least one valid key, k and v
    # rows that some query may see, every output row (a row with no valid
    # key is still written, as zeros) and kv_len
    esize = q.element_size()
    mask = attention_mask(B, S, S, causal=causal, window=window, kv_len=kvl,
                          device=dev)                       # (B, Sq, Sk)
    q_rows = int(mask.any(-1).sum().item())
    kv_rows = int(mask.any(-2).sum().item())
    nbytes = ((H * q_rows + B * H * S + 2 * KV * kv_rows) * hd * esize
              + 4 * B)
    flops = 4 * hd * H * int(mask.sum().item())   # QK^T and PV, valid pairs
    if dt == torch.float32:
        # fp32 runs on the bf16 tensor cores as six products of its exact
        # three-term split; the CUDA cores' fp32 rate is given beside it
        out["bound_ms"], out["bound_by"] = bound(nbytes, 6 * flops,
                                                 "bfloat16")
        out["bound_cuda_core_ms"] = bound(nbytes, flops, "float32")[0]
    else:
        out["bound_ms"], out["bound_by"] = bound(nbytes, flops, "bfloat16")
    out["kernel_ms"] = time_ms(lambda: flash_attention(q, k, v, **kw), dev)
    out["plain_ms"] = time_ms(lambda: attention_ref(q, k, v, **kw), dev)
    lib_mask = mask[:, None]
    lib_kw = {"enable_gqa": True} if H != KV else {}
    try:
        out["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask,
                                                   **lib_kw), dev)
    except (TypeError, RuntimeError) as e:
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def pool_case(dev, B, S, D, dt, pool, lens) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.pool_norm import pool_norm, pool_norm_ref

    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((B, S, D), np.float32)).to(dev, dt)
    mask = (torch.arange(S)[None, :] < torch.tensor(lens)[:, None]).float().to(dev)
    got = pool_norm(h, mask, pool)
    want = pool_norm_ref(h, mask, pool)
    err = (got - want).abs().max().item()
    tol = 1e-5
    zero_rows = [b for b, n in enumerate(lens) if n == 0]
    zeros_ok = all(bool((got[b] == 0).all().item()) for b in zero_rows)
    out = {"B": B, "S": S, "D": D, "dtype": dtype_name(dt), "pool": pool,
           "max_abs_err": err, "tol": tol, "masked_rows_zero": zeros_ok,
           "ok": err <= tol and zeros_ok and got.dtype == torch.float32}
    # what these inputs need: the hidden rows of unmasked tokens (mean) or
    # token 0 of rows whose first token is unmasked (CLS), the mask, the
    # output
    esize = h.element_size()
    if pool == "mean":
        tokens = sum(min(n, S) for n in lens)
        nbytes = tokens * D * esize + 4 * B * S + 4 * B * D
        flops = 2 * tokens * D + 3 * B * D

        def library():
            pooled = torch.einsum("bsd,bs->bd", h.float(), mask) \
                / mask.sum(1, keepdim=True).clamp_min(1.0)
            return F.normalize(pooled, dim=-1, eps=1e-9)
    else:      # CLS needs token 0 of each row and mask[:, 0] only
        cls_rows = sum(1 for n in lens if n > 0)
        nbytes = cls_rows * D * esize + 4 * B + 4 * B * D
        flops = 4 * B * D

        def library():
            return F.normalize(h[:, 0].float() * mask[:, :1].clamp_max(1.0),
                               dim=-1, eps=1e-9)
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, "float32")
    out["kernel_ms"] = time_ms(lambda: pool_norm(h, mask, pool), dev)
    out["plain_ms"] = time_ms(lambda: pool_norm_ref(h, mask, pool), dev)
    out["library_ms"] = time_ms(library, dev)
    return out


def _qm_inputs(dev, M, K, N, seed=2):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(dev)
    w8 = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    s = np.abs(rng.standard_normal(N, np.float32)) * 0.01 + 1e-4
    return x, w8.to(dev), torch.from_numpy(s.astype(np.float32)).to(dev)


def quant_matmul_case(dev, M, K, N, dt=None) -> dict:
    """Weight-only int8 GEMM: fp32 x (the int8 policy's dtype), or bf16."""
    import torch

    from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_ref

    dt = dt or torch.float32
    x, w8, s = _qm_inputs(dev, M, K, N)
    x = x.to(dt)
    got = quant_matmul(x, w8, s)
    want = quant_matmul_ref(x, w8, s)
    # fp32: exact products summed in another order than the plain
    # version's GEMM, held to 1e-5 of the output's largest magnitude; bf16:
    # both round one fp32 sum to bf16
    err, mag = _rel_err(got, want)
    tol = (1e-5 if dt == torch.float32 else 2e-2) * mag
    out = {"M": M, "K": K, "N": N, "dtype": dtype_name(dt),
           "max_abs_err": err, "tol": tol,
           "ok": err <= tol and got.dtype == want.dtype}
    # reported, not held: the kernel's and the plain version's distance
    # from the float64 product, relative to its largest magnitude
    exact = (x.double() @ w8.double()) * s.double()
    big = exact.abs().max().item()
    out["rel_err_vs_fp64"] = (got.double() - exact).abs().max().item() / big
    out["plain_rel_err_vs_fp64"] = ((want.double() - exact).abs().max().item()
                                    / big)
    del exact
    # The products run on the bf16 tensor cores: three passes for an fp32
    # x (h, m and l of its exact three-way bf16 split), one for a bf16 x.
    # Three are the least for fp32-accurate products: a bf16 term holds 8
    # of an fp32's 24 significant bits, and int8 weights are exact in one.
    # (2MKN fp32 FMAs at 67 TFLOP/s bound a CUDA-core kernel only.)
    passes = 3 if dt == torch.float32 else 1
    nbytes = x.element_size() * (M * K + M * N) + K * N + 4 * N
    out["bound_ms"], out["bound_by"] = bound(nbytes, passes * 2 * M * K * N,
                                             "bfloat16")
    out["kernel_ms"] = time_ms(lambda: quant_matmul(x, w8, s), dev)
    out["plain_ms"] = time_ms(lambda: quant_matmul_ref(x, w8, s), dev)
    out["library_ms"] = time_ms(lambda: x @ (w8.to(dt) * s.to(dt)), dev)
    return out


def quantize_rows_case(dev, M, K) -> dict:
    """Per-row int8 activations from fp32: bit for bit the plain version."""
    import torch

    from repro_torch.kernels.quant_matmul import (quantize_activations,
                                                  quantize_rows)

    x, _, _ = _qm_inputs(dev, M, K, 1, seed=3)
    x[1] = 0.0                            # a zero row: scale 1
    x[2] *= 1e-40                         # a subnormal row: scale 1
    x[3, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5])   # ties, round to even
    x[3, 4:] = 0.0
    x8, xs = quantize_rows(x)
    w8, ws = quantize_activations(x)
    bitwise = bool(torch.equal(x8, w8)
                   and torch.equal(xs.view(torch.int32), ws.view(torch.int32)))
    out = {"M": M, "K": K, "dtype": "float32",
           "max_abs_err": (x8.int() - w8.int()).abs().max().item(),
           "tol": 0, "bitwise": bitwise, "ok": bitwise}
    # reads x, writes x8 and a scale a row; a max, a divide and a round a
    # value
    out["bound_ms"], out["bound_by"] = bound(5 * M * K + 4 * M, 3 * M * K,
                                             "float32")
    out["kernel_ms"] = time_ms(lambda: quantize_rows(x), dev)
    out["plain_ms"] = time_ms(lambda: quantize_activations(x), dev)
    out["library_ms"] = None              # no one PyTorch call does this
    # a yardstick for the bytes alone, not the function: one PyTorch call
    # that reads x once and writes a byte a value
    out["yardstick_to_int8_ms"] = time_ms(lambda: x.to(torch.int8), dev)
    return out


def w8a8_case(dev, M, K, N, out_dtype=None) -> dict:
    """int8 x int8 GEMM on the int8 rows of an fp32 x, fp32 (the W8A8
    policy's) or bf16 out: bit for bit the plain version."""
    import torch

    from repro_torch.kernels.quant_matmul import (quantize_activations,
                                                  w8a8_matmul, w8a8_matmul_ref)

    dt = out_dtype or torch.float32
    x, w8, s = _qm_inputs(dev, M, K, N, seed=4)
    x8, xs = quantize_activations(x)
    got = w8a8_matmul(x8, w8, xs, s, out_dtype=dt)
    want = w8a8_matmul_ref(x8, w8, xs, s, out_dtype=dt)
    # the int32 sum is exact on both sides, both round it to fp32 to nearest
    # even, and the epilogue is the same fp32 multiplies in the same order
    bitwise = bool(torch.equal(got, want))
    out = {"M": M, "K": K, "N": N, "dtype": f"int8->{dtype_name(dt)}",
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "tol": 0, "bitwise": bitwise, "ok": bitwise}
    nbytes = M * K + K * N + 4 * M + 4 * N + got.element_size() * M * N
    out["bound_ms"], out["bound_by"] = bound(nbytes, 2 * M * K * N, "int8")
    out["kernel_ms"] = time_ms(
        lambda: w8a8_matmul(x8, w8, xs, s, out_dtype=dt), dev)
    out["plain_ms"] = time_ms(
        lambda: w8a8_matmul_ref(x8, w8, xs, s, out_dtype=dt), dev)
    try:      # torch._int_mm: cuBLAS's int8 GEMM, then the same epilogue
        out["library_ms"] = time_ms(
            lambda: (torch._int_mm(x8, w8).float() * xs[:, None] * s).to(dt),
            dev)
        out["library_int_mm_only_ms"] = time_ms(lambda: torch._int_mm(x8, w8),
                                                dev)
    except (RuntimeError, AttributeError) as e:
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def _rel_err(got, want) -> tuple:
    """(max abs error, largest magnitude of ``want``)."""
    return ((got.float() - want.float()).abs().max().item(),
            want.float().abs().max().item())


def rmsnorm_case(dev, R, D, dt) -> dict:
    """RMSNorm of R rows of D, scale fp32, against its plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((R, D), np.float32) * 3).to(dev, dt)
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(D)
                             .astype(np.float32)).to(dev)
    got = rmsnorm(x, scale, 1e-5)
    err, mag = _rel_err(got, rmsnorm_ref(x, scale, 1e-5))
    tol = (1e-4 if dt == torch.float32 else 2e-2) * mag
    out = {"R": R, "D": D, "dtype": dtype_name(dt), "max_abs_err": err,
           "tol": tol, "ok": err <= tol and got.dtype == dt}
    # reads x and the scale once, writes the output once; a square-add and
    # two multiplies an element
    esize = x.element_size()
    out["bound_ms"], out["bound_by"] = bound(2 * R * D * esize + 4 * D,
                                             3 * R * D, "float32")
    out["kernel_ms"] = time_ms(lambda: rmsnorm(x, scale, 1e-5), dev)
    out["plain_ms"] = time_ms(lambda: rmsnorm_ref(x, scale, 1e-5), dev)
    w = scale.to(dt)
    try:
        out["library_ms"] = time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5), dev)
    except (AttributeError, RuntimeError) as e:
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def ssm_case(dev, B, S, DI, N, dt, sfu) -> dict:
    """The selective scan from a zero state; y and h are fp32 on both
    sides, so the limit is fp32's for either x dtype.  ``sfu``: the card's
    exp2 rate (``sfu_rate``)."""
    import numpy as np
    import torch

    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref

    rng = np.random.default_rng(6)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    x = t(rng.standard_normal((B, S, DI)), dt)
    dtv = t(np.log1p(np.exp(rng.standard_normal((B, S, DI)))))  # softplus
    Bm, Cm = (t(rng.standard_normal((B, S, N))) for _ in range(2))
    A = t(-np.broadcast_to(np.arange(1, N + 1), (DI, N)))
    y, h = ssm_scan(x, dtv, Bm, Cm, A)
    y_ref, h_ref = ssm_scan_ref(x, dtv, Bm, Cm, A)
    ey, my = _rel_err(y, y_ref)
    eh, mh = _rel_err(h, h_ref)
    out = {"B": B, "S": S, "DI": DI, "N": N, "x_dtype": dtype_name(dt),
           "max_abs_err": max(ey, eh), "y_err": ey, "y_tol": 1e-4 * my,
           "h_err": eh, "h_tol": 1e-4 * mh,
           "ok": ey <= 1e-4 * my and eh <= 1e-4 * mh}
    # x, dt and y stream once; B and C once; A; h written once.  A (b, t,
    # d, n) takes one exp on the SFU and six fp32 flops (dt * A, h's FMA,
    # dx * B, the FMA with C); a (b, t, d) one more (dt * x).  The bound is
    # the largest of the three times.
    nbytes = (B * S * DI * (x.element_size() + 8) + 8 * B * S * N
              + 4 * DI * N + 4 * B * DI * N)
    terms = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "fma_ms": B * S * DI * (6 * N + 1) / PEAK_FLOPS["float32"] * 1e3,
             "sfu_ms": B * S * DI * N / sfu["per_s"] * 1e3}
    out["bound_ms"] = max(terms.values())
    out["bound_by"] = ("bytes" if terms["bytes_ms"] == out["bound_ms"]
                       else "operations")
    out["bound_terms"] = {**terms, "sms": sfu["sms"],
                          "sm_clock_mhz": sfu["sm_clock_mhz"],
                          "sm_clock_source": sfu["sm_clock_source"]}
    out["kernel_ms"] = time_ms(lambda: ssm_scan(x, dtv, Bm, Cm, A), dev)
    # the plain version runs S steps of small ops: fewer repetitions at a
    # long S
    few = {"reps": 3, "inner": 2} if S > 256 else {}
    out["plain_ms"] = time_ms(lambda: ssm_scan_ref(x, dtv, Bm, Cm, A), dev,
                              **few)
    out["library_ms"] = None       # no one PyTorch call runs the scan
    return out


def ring_kpos(dev, Sc, pos):
    """Slot positions after positions 0..pos were written into a ring of
    Sc slots (slot = position % Sc); unwritten slots are -1."""
    import torch

    kpos = torch.full((Sc,), -1, dtype=torch.int32)
    p = torch.arange(max(0, pos - Sc + 1), pos + 1, dtype=torch.int32)
    kpos[p.long() % Sc] = p
    return kpos.to(dev)


def flash_decode_case(dev, B, KV, G, hd, Sc, pos, window, qdt, cdt) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (decode_attention_ref,
                                                  flash_decode)
    from repro_torch.kernels.flash_decode.ref import slot_mask

    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((B, KV, G, hd), np.float32)
                         ).to(dev, qdt)
    k, v = (torch.from_numpy(rng.standard_normal((B, Sc, KV, hd), np.float32)
                             ).to(dev, cdt) for _ in range(2))
    kpos = ring_kpos(dev, Sc, pos)
    kw = dict(window=window)
    got = flash_decode(q, k, v, kpos, pos, **kw)
    want = decode_attention_ref(q, k, v, kpos, pos, **kw)
    err, mag = _rel_err(got, want)
    tol = (1e-4 if qdt == torch.float32 else 2e-2) * mag
    valid = slot_mask(kpos, pos, window)
    n_valid = int(valid.sum().item())
    zeros_ok = n_valid > 0 or bool((got == 0).all().item())
    out = {"B": B, "KV": KV, "G": G, "hd": hd, "Sc": Sc, "pos": pos,
           "window": window, "valid_slots": n_valid,
           "dtype": f"q {dtype_name(qdt)}, cache {dtype_name(cdt)}",
           "max_abs_err": err, "tol": tol, "no_valid_slot_zeros": zeros_ok,
           "ok": err <= tol and zeros_ok and got.dtype == qdt}
    # q and the output once, the k and v rows of valid slots once, kpos;
    # QK and PV over the valid slots
    qbytes = 2 * B * KV * G * hd * q.element_size()
    nbytes = qbytes + 2 * B * KV * n_valid * hd * k.element_size() + 4 * Sc
    out["bound_ms"], out["bound_by"] = bound(
        nbytes, 4 * B * KV * G * hd * n_valid, "float32")
    out["kernel_ms"] = time_ms(lambda: flash_decode(q, k, v, kpos, pos, **kw),
                               dev)
    out["plain_ms"] = time_ms(
        lambda: decode_attention_ref(q, k, v, kpos, pos, **kw), dev)
    # yardstick: SDPA over the slots with the KV heads expanded to G query
    # heads each and a boolean slot mask (layouts made outside the timing)
    q4 = q.reshape(B, KV * G, 1, hd)
    ke, ve = (t.transpose(1, 2).repeat_interleave(G, 1).to(qdt).contiguous()
              for t in (k, v))
    mask = valid[None, None, None]
    out["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q4, ke, ve, attn_mask=mask),
        dev)
    return out


def phase_kernels(args, dev) -> dict:
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    t = dev.type == "cuda"
    B, H, S, hd, D = ((MAIN_B, MAIN_H, MAIN_S, MAIN_HD, MAIN_D) if t
                      else (4, 2, 24, 16, 64))
    ragged = [S, 75 if S > 75 else S - 1, 0, S // 2] * (B // 4)
    attn, attn_cases = [], {}
    for s in ((16, S) if t else (S,)):
        lens = [min(n, s) if n else 0 for n in ragged]
        for dt in (f32, bf16):
            attn.append(attention_case(dev, B, H, H, s, hd, dt, lens))
    attn_cases["bge_fp32"], attn_cases["bge_bf16"] = attn[-2:]
    # ragged tiles: an S that is not a multiple of the 64-key tile, a
    # window that ends mid-tile, hd 32 and 128, GQA G = 2 and 4
    for dt in (f32, bf16):
        attn.append(attention_case(dev, 4, 4, 2, 40, 32, dt, [40, 17, 0, 1]))
        attn.append(attention_case(dev, 2, 4, 2, 130, 64, dt, [130, 77],
                                   causal=True, window=48))
        attn.append(attention_case(dev, 2, 4, 4, 70, 128, dt, [70, 0],
                                   causal=True))
        attn.append(attention_case(dev, 2, 8, 2, 200, 32, dt, [200, 150]))
    # hymba-1.5b's prefill: causal, window 1024, 25 heads on 5 KV heads;
    # batches of 64-token prompts, and a prompt longer than the window
    lm_attn = (((LM_B, LM_PROMPT), (2, LONG_PROMPT), 25, LM_KV, LM_HD, 1024)
               if t else ((2, 24), (1, 40), 4, 2, 16, 16))
    *shapes, H_lm, KV_lm, hd_lm, win = lm_attn
    for (b, s), tag in zip(shapes, ("hymba_S64", "hymba_S1100")):
        for dt in (f32, bf16):
            attn.append(attention_case(dev, b, H_lm, KV_lm, s, hd_lm, dt,
                                       [s] * b, causal=True, window=win))
        attn_cases[f"{tag}_fp32"], attn_cases[f"{tag}_bf16"] = attn[-2:]
    pools = [pool_case(dev, B, S, D, dt, pool, ragged)
             for pool in ("cls", "mean") for dt in (f32, bf16)]
    pool_cases = {f"mean_{c['dtype']}": c for c in pools
                  if c["pool"] == "mean"}
    # mean mode at a D that is not a multiple of 128 (1000) or of the
    # 16-byte vector (77), at S = 1, with fully masked rows
    for dt in (f32, bf16):
        pools.append(pool_case(dev, 4, 7, 1000, dt, "mean", [7, 0, 1, 5]))
        pools.append(pool_case(dev, 3, 20, 77, dt, "mean", [20, 0, 9]))
        pools.append(pool_case(dev, 3, 1, 1024, dt, "mean", [1, 0, 1]))
    # the projections of 16 x 96 tokens (on the CPU: 2 x 24 at width 64)
    M = B * S
    kn = MAIN_KN if t else ((D, D), (D, 4 * D), (4 * D, D))
    qm = [quant_matmul_case(dev, M, k, n) for k, n in kn]
    qm.append(quant_matmul_case(dev, M, *kn[1], bf16))
    qr = [quantize_rows_case(dev, M, k) for k in sorted({k for k, _ in kn})]
    w8 = [w8a8_case(dev, M, k, n) for k, n in kn]
    w8.append(w8a8_case(dev, M, *kn[1], bf16))
    # the LM path (on the CPU: smoke widths)
    D, DI, KV, G, hd = ((LM_D, LM_DI, LM_KV, LM_G, LM_HD) if t
                        else (128, 256, 2, 2, 32))
    Bl, Sl, Sc = (LM_B, LM_PROMPT, LM_PROMPT + LM_NEW) if t else (2, 24, 28)
    rms = [rmsnorm_case(dev, r, d, dt) for r, d in
           ((Bl * Sl, D), (Bl, D), (7, 77)) for dt in (f32, bf16)]
    # the prefill's scan, a small off-tile one, and the 1100-token prompt
    sfu = sfu_rate(dev)
    ssm = [ssm_case(dev, b, s, di, LM_N, dt, sfu) for b, s, di in
           ((Bl, Sl, DI), (2, 50, 200), (2, LONG_PROMPT if t else 40, DI))
           for dt in (bf16, f32)]
    ring = 1024 if t else 16
    fd = [flash_decode_case(dev, Bl, KV, G, hd, Sc, Sc - 1, ring, bf16, f32),
          flash_decode_case(dev, Bl, KV, G, hd, Sc, Sc - 1, ring, f32, f32),
          flash_decode_case(dev, Bl, KV, G, hd, Sc, Sc - 1, ring, bf16, bf16),
          # a full ring that has wrapped: every slot valid, then a
          # narrower window
          flash_decode_case(dev, 2, KV, G, hd, ring, LONG_PROMPT, ring,
                            bf16, f32),
          flash_decode_case(dev, 2, KV, G, hd, ring, LONG_PROMPT, ring * 3 // 4,
                            f32, f32),
          # empty slots, and no valid slot at all
          flash_decode_case(dev, 3, KV, G, hd, Sc, 40, 0, f32, f32),
          flash_decode_case(dev, 2, KV, G, hd, 16, -1, 0, bf16, f32),
          # starcoder2-7b's decode (36 heads on 4 KV heads of 128, window
          # 4096) on a full ring at B 1: 4 pairs, so the slots split over
          # clusters of 8 blocks (on the CPU: G 9 at a smoke width)
          flash_decode_case(dev, 1, 4, 9, 128 if t else 32, 4096 if t else 64,
                            5000 if t else 70, 4096 if t else 64, bf16, f32)]
    cases = ([("flash_attention", c) for c in attn]
             + [("pool_norm", c) for c in pools]
             + [("quant_matmul", c) for c in qm]
             + [("quantize_rows", c) for c in qr]
             + [("w8a8_matmul", c) for c in w8]
             + [("rmsnorm", c) for c in rms]
             + [("ssm_scan", c) for c in ssm]
             + [("flash_decode", c) for c in fd])
    for name, c in cases:
        emit({"phase": "kernels", "kernel": name, **c})
    bad = [c for _, c in cases if not c["ok"]]
    require(not bad, f"{len(bad)} kernel case(s) disagree with the plain "
                     f"version")
    # the main path's shapes: fp32 serving, bge's CLS epilogue
    main_attn = next(c for c in attn if c["S"] == S and c["H"] == H
                     and c["dtype"] == "float32")
    main_pool = next(c for c in pools if c["pool"] == "cls"
                     and c["dtype"] == "float32")
    # w_in, the largest projection, and the 1024-wide rows five of the six
    # projections quantize
    # the LM path computes in bf16 with an fp32 cache: the prefill's norm,
    # its scan and the last decode step's read
    return {"flash_attention": main_attn, "pool_norm": main_pool,
            "quant_matmul": qm[1], "quantize_rows": qr[0],
            "w8a8_matmul": w8[1], "rmsnorm": rms[1], "ssm_scan": ssm[0],
            "flash_decode": fd[0],
            # the redesigned paths, each at the main paths' shapes
            "cases": {"flash_attention": attn_cases, "pool_norm": pool_cases,
                      "quant_matmul": {
                          "w_qkvo_float32": qm[0], "w_in_float32": qm[1],
                          "w_out_float32": qm[2], "w_in_bfloat16": qm[3]},
                      "quantize_rows": {
                          "K1024_float32": qr[0], "K4096_float32": qr[1]},
                      "w8a8_matmul": {
                          "w_qkvo_float32": w8[0], "w_in_float32": w8[1],
                          "w_out_float32": w8[2], "w_in_bfloat16_out": w8[3]},
                      "rmsnorm": {
                          "prefill_float32": rms[0], "prefill_bfloat16": rms[1],
                          "decode_float32": rms[2], "decode_bfloat16": rms[3]},
                      "ssm_scan": {
                          "prefill_bfloat16": ssm[0], "prefill_float32": ssm[1],
                          "B2_S50_DI200_bfloat16": ssm[2],
                          "B2_S50_DI200_float32": ssm[3],
                          "long_prompt_bfloat16": ssm[4],
                          "long_prompt_float32": ssm[5]},
                      "flash_decode": {
                          "served_q_bf16_cache_f32": fd[0],
                          "served_q_f32_cache_f32": fd[1],
                          "served_q_bf16_cache_bf16": fd[2],
                          "ring1024_B2_q_bf16_cache_f32": fd[3],
                          "starcoder2_G9_hd128_ring4096": fd[-1]}}}


def golden_tree():
    import numpy as np

    from repro_torch.models.embedder import unflatten

    data = np.load(os.path.join(ROOT, "tests", "golden", "golden_embed.npz"))
    flat = {k: data[k] for k in data.files}
    queries = [flat[f"query:{i}"] for i in range(8)]
    return unflatten(flat, "param:"), queries, flat["golden"]


def golden_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("bge-large-zh-v1.5").smoke(),
                               name="bge-golden", num_layers=1, d_model=32,
                               num_heads=2, num_kv_heads=1, head_dim=16,
                               d_ff=64, vocab_size=128, embed_dim=16)


def cosine_distance(a, b) -> float:
    import numpy as np

    return float((1.0 - (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                           * np.linalg.norm(b, axis=-1))).max())


def phase_golden(args, dev) -> dict:
    import numpy as np

    from repro_torch.core.routing import Query
    from repro_torch.core.sharded_backend import ShardedEmbedderBackend
    from repro_torch.models.embedder import params_from_numpy

    tree, payloads, want = golden_tree()
    out = {}
    for dtype in POLICIES:
        be = ShardedEmbedderBackend(golden_config(),
                                    params_from_numpy(tree, dev),
                                    max_tokens=32, min_seq_bucket=8,
                                    dtype=dtype, device=dev)
        got = np.stack(be.embed_batch([Query(qid=i, payload=p, length=len(p))
                                       for i, p in enumerate(payloads)]))
        out[dtype] = {"max_abs_err": float(np.abs(got - want).max()),
                      "cosine_distance": cosine_distance(got, want),
                      "dtype_out": str(got.dtype)}
    require(out["fp32"]["max_abs_err"] <= 1e-5,
            f"fp32 golden drift {out['fp32']['max_abs_err']} > 1e-5")
    for dtype, bar in (("bf16", 1e-2), ("int8", 1e-2), ("int8_w8a8", 2e-2)):
        require(out[dtype]["cosine_distance"] <= bar,
                f"{dtype} golden cosine distance "
                f"{out[dtype]['cosine_distance']} > {bar}")
    return out


def serve_once(dev, model: str, dtype: str, smoke: bool, n: int = 32) -> dict:
    import numpy as np
    import torch

    from repro_torch import perf_flags
    from repro_torch.core.routing import CPU, NPU
    from repro_torch.data.workload import make_queries
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import build_engine

    perf_flags.set_flags(embed_dtype=dtype)
    before = launch_counts()
    t0 = time.monotonic()
    engine, cfg = build_engine(model=model, smoke=smoke, device=dev,
                               prewarm=True)
    build_s = time.monotonic() - t0
    try:
        be = engine.backends[CPU]
        traces = be.traces
        # the modeled NPU tier answers with zero vectors by design: route
        # this run's queries to the real tier so every vector is checkable
        engine.qm.set_depth(NPU, 0)
        queries = make_queries(n, cfg.vocab_size, 75, seed=7)
        vecs = []
        t1 = time.monotonic()
        for wave in (queries[:n // 2], queries[n // 2:]):   # batches <= 16
            futs = [engine.submit(payload=q, length=75) for q in wave]
            require(all(f is not None for f in futs), "a query was refused")
            vecs += [f.result(timeout=300) for f in futs]
        serve_s = time.monotonic() - t1
        vecs = np.stack(vecs)
        norms = np.linalg.norm(vecs, axis=-1)
        s = engine.stats
        after = launch_counts()
        out = {"model": model, "dtype": dtype, "layers": cfg.num_layers,
               "d_model": cfg.d_model, "params_bytes": be.params_nbytes,
               "build_engine_s": build_s, "serve_s": serve_s,
               "served": len(vecs), "per_device": dict(s.per_device),
               "shape": list(vecs.shape), "finite": bool(np.isfinite(vecs).all()),
               "max_norm_err": float(np.abs(norms - 1.0).max()),
               "traces_after_prewarm": traces, "traces_after_serve": be.traces,
               "batch_p50_ms": s.batch_p(50, CPU) * 1e3,
               "batch_p95_ms": s.batch_p(95, CPU) * 1e3,
               "batches": len(s.tier_batch_latencies.get(CPU, [])),
               "launches": {k: after[k] - before[k] for k in after}}
    finally:
        engine.shutdown()
    require(out["finite"] and out["shape"] == [n, cfg.d_model],
            f"{model}/{dtype}: bad output shape or values")
    require(out["max_norm_err"] <= 1e-3, f"{model}/{dtype}: not unit vectors")
    require(out["traces_after_serve"] == traces,
            f"{model}/{dtype}: new shapes after prewarm")
    out["vectors"] = vecs
    del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_serve(args, dev) -> dict:
    from repro_torch.kernels import launch_counts, reset_launch_counts

    smoke = dev.type != "cuda"
    reset_launch_counts()                 # the main path starts here
    runs = [serve_once(dev, "bge-large-zh-v1.5", dtype, smoke)
            for dtype in POLICIES]
    runs.append(serve_once(dev, "jina-v2", "fp32", smoke, n=16))
    counts = launch_counts()              # ... and ends here
    vecs = {r["dtype"]: r.pop("vectors") for r in runs[:len(POLICIES)]}
    runs[-1].pop("vectors")
    for r in runs:
        emit({"phase": "serve", **r})
    # the same seeded weights under each policy: the reference's bars
    # against the fp32 oracle
    out = {}
    for dtype, bar in (("bf16", 0.99), ("int8", 0.99), ("int8_w8a8", 0.98)):
        cos = 1.0 - cosine_distance(vecs["fp32"], vecs[dtype])
        out[f"{dtype}_vs_fp32_min_cosine"] = cos
        require(cos >= bar, f"{dtype} vs fp32 cosine {cos} < {bar}")
    out["params_bytes"] = {r["dtype"]: r["params_bytes"]
                           for r in runs[:len(POLICIES)]}
    if dev.type == "cuda":
        require(all(counts[name] > 0 for name in EMBED_KERNELS),
                f"a kernel was not launched on the main path: {counts}")
        # W8A8 bge quantizes 4 inputs a layer for its 6 int8 GEMMs (q, k
        # and v share one)
        require(6 * counts["quantize_rows"] == 4 * counts["w8a8_matmul"],
                f"quantize_rows launches {counts['quantize_rows']}, want 4/6 "
                f"of w8a8_matmul's {counts['w8a8_matmul']}")
    return {**out, "launches": counts}


# the LM's kernel routers and their plain versions, by the name
# models.layers calls them under
PLAIN_VERSIONS = {
    "rmsnorm": ("repro_torch.kernels.rmsnorm", "rmsnorm_ref"),
    "flash_decode": ("repro_torch.kernels.flash_decode",
                     "decode_attention_ref"),
    "ssm_scan": ("repro_torch.kernels.ssm_scan", "ssm_scan_ref"),
    "flash_attention": ("repro_torch.kernels.flash_attention",
                        "attention_ref"),
}


@contextlib.contextmanager
def plain_kernels():
    """Inside: models.layers calls every kernel's plain version, also on the
    card (the plain versions take the kernels' arguments)."""
    import importlib

    from repro_torch.models import layers as L

    saved = {name: getattr(L, name) for name in PLAIN_VERSIONS}
    try:
        for name, (mod, ref) in PLAIN_VERSIONS.items():
            setattr(L, name, getattr(importlib.import_module(mod), ref))
        yield
    finally:
        for name, fn in saved.items():
            setattr(L, name, fn)


def min_cosine(a, b) -> float:
    """Smallest cosine between matching rows (last dim) of a and b."""
    import torch.nn.functional as F

    return F.cosine_similarity(a.float(), b.float(), dim=-1).min().item()


def decode_vs_prefill(be, toks, forced) -> list:
    """Cosine of each decode step's logits (teacher-forced on ``forced``,
    (steps, B)) against a fresh prefill of the prompt plus the tokens fed
    so far."""
    import torch

    from repro_torch.models import lm

    _, steps = be.generate(toks, forced=forced)
    toks = torch.as_tensor(toks).to(be.device)
    fed = torch.as_tensor(forced).to(be.device)
    out = []
    with torch.inference_mode():
        for t in range(fed.shape[0]):
            longer = torch.cat([toks, fed[:t + 1].T], dim=1)
            want, _ = lm.prefill(be.params, be.cfg, longer,
                                 cache_dtype=torch.float32,
                                 compute_dtype=be.compute_dtype)
            out.append(min_cosine(steps[t + 1], want))
    return out


def phase_generate(args, dev) -> dict:
    """hymba-1.5b token generation through launch/serve_llm's engine."""
    import numpy as np
    import torch

    from repro_torch.core.llm_backend import LMGenerateBackend
    from repro_torch.core.routing import CPU, NPU, Query
    from repro_torch.data.workload import make_queries
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve_llm import build_engine
    from repro_torch.models import lm

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n, prompt, new = 32, LM_PROMPT, LM_NEW
    reset_launch_counts()                 # the LM's main path starts here
    t0 = time.monotonic()
    engine, cfg, _ = build_engine(LM_ARCH, smoke=not cuda, device=dev,
                                  new_tokens=new)
    build_s = time.monotonic() - t0
    try:
        be = engine.backends[CPU]
        # the modeled tier answers with zero vectors by design: route this
        # run's prompts to the real tier so every answer is checkable
        engine.qm.set_depth(NPU, 0)
        queries = make_queries(n, cfg.vocab_size, prompt, seed=11)
        outs = []
        t1 = time.monotonic()
        for wave in (queries[:n // 2], queries[n // 2:]):
            futs = [engine.submit(payload=q, length=prompt) for q in wave]
            require(all(f is not None for f in futs), "a prompt was refused")
            outs += [f.result(timeout=600) for f in futs]
        serve_s = time.monotonic() - t1
        counts = launch_counts()          # ... and ends here
        s = engine.stats
        out = {"model": cfg.name, "layers": cfg.num_layers,
               "d_model": cfg.d_model, "params_bytes": be.params_nbytes,
               "build_engine_s": build_s, "serve_s": serve_s,
               "served": len(outs), "per_device": dict(s.per_device),
               "batch_p50_ms": s.batch_p(50, CPU) * 1e3,
               "batch_p95_ms": s.batch_p(95, CPU) * 1e3,
               "batches": len(s.tier_batch_latencies.get(CPU, [])),
               "launches": counts}
    finally:
        engine.shutdown()
    gen = np.stack(outs)
    out["shape"] = list(gen.shape)
    require(gen.shape == (n, new) and gen.dtype.kind in "iu"
            and ((gen >= 0) & (gen < cfg.vocab_size)).all(),
            f"continuations of shape {gen.shape}, not ({n}, {new}) ids in "
            f"[0, {cfg.vocab_size})")
    if cuda:
        for name in ("rmsnorm", "flash_attention", "ssm_scan", "flash_decode"):
            require(counts[name] > 0, f"{name} was not launched on the LM "
                                      f"path: {counts}")

    # off the counted path: one batch of the same prompts, teacher-forced
    # on the served tokens, through the kernels and the plain versions
    toks = be.prompt_tokens([Query(qid=i, payload=q, length=prompt)
                             for i, q in enumerate(queries[:LM_B])])
    forced = gen[:LM_B, :-1].T
    with torch.inference_mode():
        _, kern = be.generate(toks, forced=forced)
        with plain_kernels():
            _, plain = be.generate(toks, forced=forced)
    out["kernel_vs_plain_min_cosine"] = [min_cosine(a, b)
                                         for a, b in zip(kern, plain)]
    # decode against a fresh prefill, with 64-token prompts and with B = 2
    # and a prompt longer than the window (the ring wraps in prefill).
    # Held in fp32 compute (TF32 off), where the two agree to rounding; in
    # bf16 the two orders of rounding drift apart through 32 layers of
    # random weights, so the bf16 figure is reported, not held.
    long_toks = np.stack(make_queries(2, cfg.vocab_size, LONG_PROMPT,
                                      seed=12))
    long_forced = np.stack(make_queries(2, cfg.vocab_size, new - 1,
                                        seed=13)).T
    torch.backends.cuda.matmul.allow_tf32 = False
    fp32 = LMGenerateBackend(cfg, be.params, max_prompt=prompt,
                             max_new_tokens=new, device=dev,
                             compute_dtype=torch.float32)
    out["long_prompt"] = LONG_PROMPT
    for tag, backend in (("", fp32), ("bf16_", be)):
        out[f"{tag}decode_vs_prefill_min_cosine"] = decode_vs_prefill(
            backend, toks, forced)
        out[f"{tag}long_decode_vs_prefill_min_cosine"] = decode_vs_prefill(
            backend, long_toks, long_forced)

    # host clock of one prefill and of a decode step at the batch shape
    with torch.inference_mode():
        x = torch.as_tensor(toks).to(dev)
        times = []
        for _ in range(3):
            sync()
            t2 = time.perf_counter()
            _, cache = lm.prefill(be.params, cfg, x, max_len=prompt + new,
                                  cache_dtype=torch.float32)
            sync()
            times.append(time.perf_counter() - t2)
        out["prefill_ms"] = statistics.median(times) * 1e3
        tok = x[:, -1]
        t2 = time.perf_counter()
        for _ in range(new - 1):
            logits, cache = lm.decode_step(be.params, cfg, tok, cache)
            tok = logits.argmax(-1)
        sync()
        out["decode_ms_per_step"] = (time.perf_counter() - t2) * 1e3 / (new - 1)
    emit({"phase": "generate", **out})
    held = ("kernel_vs_plain_min_cosine", "decode_vs_prefill_min_cosine",
            "long_decode_vs_prefill_min_cosine")
    for key in held:
        require(min(out[key]) >= COSINE_BAR,
                f"{key}: {min(out[key])} < {COSINE_BAR}")
    summary = {key: min(out[key]) for key in held}
    summary["bf16_decode_vs_prefill_min_cosine"] = min(
        out["bf16_decode_vs_prefill_min_cosine"]
        + out["bf16_long_decode_vs_prefill_min_cosine"])
    del be, fp32, engine
    if cuda:
        torch.cuda.empty_cache()
    return {**summary, "launches": counts}


def profile_steps(fn, sync, acts, trace_path, reps: int = 5) -> dict:
    """Where the time of one call of ``fn`` goes: host clock (synchronised),
    host enqueue time, device busy time summed from the kernels of a
    torch.profiler trace, launches of the port's kernels and the kernels
    by device time."""
    import torch

    from repro_torch.kernels import launch_counts

    for _ in range(3):
        fn()
    sync()
    enqueue, wall = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        sync()
        wall.append(time.perf_counter() - t0)
        enqueue.append(t1 - t0)
    before = launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        sync()
    after = launch_counts()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name: dict = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    total_us = sum(by_name.values())
    wall_ms = statistics.median(wall) * 1e3
    busy_ms = total_us / 1e3 / reps if kernels else None
    return {
        "wall_ms": wall_ms, "enqueue_ms": statistics.median(enqueue) * 1e3,
        "device_busy_ms": busy_ms,
        "idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
        "kernels_per_step": len(kernels) / reps,
        "launches_per_step": {k: (after[k] - before[k]) / reps for k in after
                              if after[k] != before[k]},
        "top_kernels": [
            {"name": n[:90], "ms_per_step": d / 1e3 / reps,
             "share_of_busy": d / total_us}
            for n, d in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]]}


def phase_profile(args, dev) -> dict:
    """Where one step's time goes at the main paths' largest batches:
    one bge-large-zh-v1.5 forward (B=16 x S=96, 75 real tokens a row)
    under each policy, and one hymba-1.5b prefill (B=16 x S=64) and
    decode step (B=16 against the 64-token prompt's cache)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import embedder, lm
    from repro_torch.models.quantize import serve_params, wants_act_quant

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trace_dir = os.path.join(ROOT, "build", "profile")
    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])

    def trace(name):
        return os.path.join(trace_dir, f"profile_{name}.json")

    cfg = get_config("bge-large-zh-v1.5")
    if not cuda:
        cfg = cfg.smoke()
    base = embedder.init_embedder(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    B, S, real = MAIN_B, MAIN_S, 75
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S))
                            .astype(np.int32)).to(dev)
    mask = (torch.arange(S, device=dev)[None] < real).float().expand(B, S)
    hd, H, KV = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    D, F = cfg.d_model, cfg.d_ff
    matmul_flops = 2 * B * S * cfg.num_layers * (
        2 * D * H * hd + 2 * D * KV * hd + 2 * D * F)
    out = {"B": B, "S": S, "real_tokens_per_row": real,
           "matmul_gflop_per_forward": matmul_flops / 1e9}
    for dtype in POLICIES:
        params, cdt = serve_params(base, dtype)
        act_quant = wants_act_quant(dtype)

        def fwd():
            with torch.inference_mode():
                return embedder.embed(params, cfg, toks, mask,
                                      compute_dtype=cdt, act_quant=act_quant)

        out[dtype] = profile_steps(fwd, sync, acts, trace(dtype))
        out[dtype]["matmul_tflops_at_wall"] = (matmul_flops
                                               / out[dtype]["wall_ms"] / 1e9)
        del params
    del base

    cfg = get_config(LM_ARCH)
    if not cuda:
        cfg = cfg.smoke()
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_B, LM_PROMPT))
                         .astype(np.int32)).to(dev)

    def prefill():
        with torch.inference_mode():
            return lm.prefill(params, cfg, x, max_len=LM_PROMPT + LM_NEW,
                              cache_dtype=torch.float32)

    _, cache = prefill()
    tok = x[:, -1]

    def decode():
        # the same position every call: the step's work stays the same
        with torch.inference_mode():
            return lm.decode_step(params, cfg, tok, cache)

    out[LM_ARCH] = {"B": LM_B, "S": LM_PROMPT, "cache_slots": LM_PROMPT + LM_NEW,
                    "prefill": profile_steps(prefill, sync, acts,
                                             trace("hymba_prefill")),
                    "decode_step": profile_steps(decode, sync, acts,
                                                 trace("hymba_decode"))}
    return out


# ----------------------------------------------------------------------------

def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


KERNELS = (("flash_attention", FA_SOURCE, FA_REPLACES),
           ("pool_norm", PN_SOURCE, PN_REPLACES),
           ("quant_matmul", QM_SOURCE, QM_REPLACES),
           ("quantize_rows", QM_SOURCE, QR_REPLACES),
           ("w8a8_matmul", QM_SOURCE, W8_REPLACES),
           ("rmsnorm", RN_SOURCE, RN_REPLACES),
           ("ssm_scan", SS_SOURCE, SS_REPLACES),
           ("flash_decode", FD_SOURCE, FD_REPLACES))


def kernel_summary(main: dict, by_path: dict) -> dict:
    """One row a kernel: its case at the main path's shape, and its
    launches on the main paths (``by_path``: path -> launch counts)."""
    rows = []
    keys = ("kernel_ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
            "max_abs_err")
    # fp32 attention's CUDA-core figure; quantize_rows' traffic yardstick
    extra = ("bound_cuda_core_ms", "yardstick_to_int8_ms")
    for name, source, replaces in KERNELS:
        c = main[name]
        per_path = {path: counts.get(name, 0)
                    for path, counts in by_path.items()}
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": sum(per_path.values()),
               "launches_by_path": per_path,
               "max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
               "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
               "bound_by": c["bound_by"], "library_ms": c.get("library_ms")}
        cases = main.get("cases", {}).get(name)
        if cases:
            row["cases"] = {tag: {**{k: case.get(k) for k in keys},
                                  **{k: case[k] for k in extra if k in case}}
                            for tag, case in cases.items()}
        rows.append(row)
    return {"kernels": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--ptxas-log", default=os.path.join("build", "ptxas.log"),
                    help="where the build phase writes ptxas's report "
                         "(relative to the repo root)")
    ap.add_argument("--rehearse", action="store_true",
                    help="run the phases on the CPU at smoke size (plain "
                         "versions, no build); never prints a result")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if args.rehearse:
        dev = torch.device("cpu")
        phases = [p for p in phases if p != "build"]
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; nothing was run",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
    print(f"[chip_smoke] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} on {dev}",
          flush=True)

    import repro_torch.kernels  # noqa: F401  (fails outside the repo)

    results, failed = {}, []
    for name in phases:
        t0 = time.monotonic()
        try:
            if name == "build":
                res = phase_build(args)
            else:
                res = globals()[f"phase_{name}"](args, dev)
            results[name] = res
            # the kernels phase printed its cases; its summary comes last
            emit({"phase": name, "ok": True, "seconds": time.monotonic() - t0,
                  **(res if name != "kernels" else {})})
        except Exception as e:      # report every phase, then fail the run
            failed.append(name)
            emit({"phase": name, "ok": False, "seconds": time.monotonic() - t0,
                  "error": f"{type(e).__name__}: {e}"[:2000]})
            if name == "build":
                break
    if args.rehearse:
        print(f"[chip_smoke] rehearsal on the CPU: failed phases {failed}; "
              f"no result", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    if "kernels" in results:
        by_path = {path: results[path]["launches"]
                   for path in ("serve", "generate") if path in results}
        emit(kernel_summary(results["kernels"], by_path))
    if failed or not set(PHASES) <= set(phases):
        print(f"[chip_smoke] failed phases {failed}; phases run {phases}",
              file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
