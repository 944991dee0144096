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
           in fp32 and bf16 at bge's and the decoders' prefill shapes
           (hymba S 64 and its 1100-token prompt, stablelm S 64, starcoder2
           S 64 and a 4160-token prompt under its 4096 window, granite-moe
           G 3 x hd 64, qwen3-moe G 8 x hd 64, internlm2 G 6 x hd 128 and
           internvl2 G 2 x hd 128 at S 64, and internvl2 at S 320), mean
           pooling in fp32 and bf16, the three bge projections in fp32 and
           w_in in bf16 (weight-only and W8A8), quantize_rows at K 1024 and
           4096 (with `x.to(torch.int8)` beside it, a yardstick for the
           same bytes), rmsnorm at hymba's, stablelm's (d 2048),
           falcon-mamba's (d 4096), granite-moe's (d 1536) and internlm2's
           (d 6144) prefill and decode rows, the scan at
           hymba's prefill, its 1100-token prompt and falcon-mamba's prefill
           (DI 8192), and decode attention at hymba's served shape in the
           three (q, cache) pairs, on a 1024-slot ring, at the served
           shapes of stablelm, starcoder2, granite-moe, qwen3-moe,
           internlm2 and internvl2 (80 slots; 336 for internvl2, whose
           cache keeps room for 256 patches) and at starcoder2's G 9 x hd
           128 on a 4096-slot ring; and whisper-tiny's: attention over its
           1500 encoder frames, its prefill's cross attention (64 queries
           over the 1500 frames), its decoder's causal S 64 and its decode
           step (G 1 x hd 64, 80 slots); qwen2-72b's decode step (B 8,
           G 8 x hd 128, 80 slots) and its sequence-sharded read: 4
           shards of 1024 slots, each read with its log-sum-exp (`lse`),
           then the combine, against the reference's shard_map formula
           (in bf16 q over an fp32 cache and in fp32).  The two backward
           kernels, bf16 and fp32, against their plain backward versions
           (fp32: max-abs within 1e-4 of each gradient's largest magnitude;
           bf16: cosine >= 0.999) and bit for bit equal across two calls,
           with autograd's backward of
           scaled_dot_product_attention and of F.rms_norm as yardsticks:
           attention at stablelm-1.6b's training shape (B 8, 32 heads of
           64, S 512, causal), GQA (64 heads on 8 of 128, S 1024), a
           1024-token sequence under a 256 window, a ragged kv_len with a
           row of none, and whisper's 64 queries over 1500 frames, each
           with the forward kernel's lse against the plain version's;
           RMSNorm over 4096 rows of d 2048 and 6144.  The scan's backward
           kernel against its plain backward (each gradient within 1e-4 of
           its largest magnitude; a bf16 x's dx within one bf16 step) and
           bit for bit equal across two calls, with autograd's backward of
           the plain scan timed beside it: hymba-1.5b's training shape (B
           8, S 512, d_inner 3200), falcon-mamba-7b's d_inner 8192 (B 4),
           the 1100-token prompt (B 2) and S and DI off its tiles ((3, 33,
           130), (1, 1, 7)), each with and without a final-state gradient,
           in both x dtypes.
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
  offload  the paper's Table-1 A/B, examples/torch_serve_offload.py's two
           engines: a burst of 56 queries of 24 tokens through a modeled
           NPU alone, then with the card's ShardedEmbedderBackend (bge at
           full width, fp32) beside it at depth 2.  The card's tier must
           serve, the offload run accept more, and every non-zero vector be
           a unit vector within 1e-5 of a direct forward of its query; the
           uplift and saving come from the port's cost_model.
  chaos    the card's embedder behind a FaultyBackend, one real tier with a
           RetryPolicy, 4 waves of 8 queries: execution 1 fails and
           execution 3 is corrupted.  The injected counts and the retries
           must equal the plan, no query may fail, and the corrupted batch's
           vectors, and only those, differ from a fault-free run (the rest
           within 1e-5).  The offload and chaos paths each zero the launch
           counts before they run and read them after.
  generate launch/serve_llm's engine for hymba-1.5b, stablelm-1.6b,
           starcoder2-7b, falcon-mamba-7b, internlm2-20b (bf16 weights),
           granite-moe-3b-a800m, qwen3-moe-30b-a3b (bf16 weights),
           internvl2-2b and qwen2-72b (bf16 weights, 24 of its 80 layers:
           47.1 GB), each at its published width (random weights) and
           alone on the card: 32 prompts of 64 tokens in two waves of 16
           (qwen2-72b: 16 in waves of 8), 16 greedy tokens each.  Launch counts are
           zeroed just before each engine is built and read just after its
           last answer; each family's kernels must have run.  Then, off the
           counted path: teacher-forced logits of the kernel path against
           the plain versions on the card in fp32 compute and in bf16
           (cosine >= 0.99 at every step; bf16 reported only for
           falcon-mamba, whose 64 random layers amplify bf16 rounding in
           the JAX package too), and decode-step logits against a fresh
           prefill of the longer prompt in fp32 compute (cosine >= 0.99),
           with 64-token prompts and, for hymba (1100 tokens, B 2) and
           starcoder2 (4160, B 1), a prompt longer than the window, so the
           ring wraps in prefill.  The MoE models' decode-vs-prefill
           is held at capacity factor E / K (nothing drops) and reported
           at the published 1.25 with the share of assignments dropped
           at prefill and at decode; their bf16 kernel-vs-plain is held
           where it meets the bar, else reported with the routes that
           flipped; granite also runs its fp32 kernel-vs-plain batch under
           moe_row_dispatch.  internvl2 prefills 256 stub patch
           embeddings before the 64-token prompts (S 320), kernels
           against plain versions in bf16 and fp32.
  encdec   whisper-tiny (4 + 4 layers, d_model 384, 1500 stub frames) at
           its published width through steps/serve.py's builders: random
           fp32 weights and frames from one seeded generator, a prefill of
           16 prompts of 64 tokens and 15 greedy decode steps (80 fp32
           cache slots), bf16 compute.  Launch counts are zeroed just
           before the prefill and read just after the last step; the
           encoder's and the decoder's flash_attention (self and cross)
           and flash_decode must have run as often as the layers ask.
           Then, off the counted path: teacher-forced logits through the
           kernels against the plain versions (cosine >= 0.99 in fp32
           compute; in bf16 held where met, else reported), decode steps
           against a fresh prefill of the longer prompt on the same frames
           in fp32 compute (cosine >= 0.99), the encoder's states through
           the kernels against the plain versions (max-abs, reported), and
           host clock, device busy time and idle share of encode, prefill
           and one decode step.
  mesh     4 logical devices placed round-robin on the visible cards
           (printed on a line of its own).  (a) bge-large-zh-v1.5's embed
           tier through ShardedEmbedderBackend fanned out over them, fp32
           and bf16, 24 queries of 8-96 tokens, against the one-device
           backend on the same queries: fp32 within 1e-5 max-abs, bf16 at
           cosine 0.999.  (b) qwen2-72b at its published width, 24 of 80
           layers on bf16 weights, fp32 compute and cache, through
           steps/serve.py's builders on a (1, 4) mesh with
           decode_shard_map: a 256-slot cache split into 4 shards of 64,
           B 4, after a 200-token prompt (shards 0-2 full, shard 3 the
           owner) and a 40-token one (shards 1-3 empty), 16 greedy decode
           steps, against the same steps on the whole cache: tokens equal,
           k and v within 1e-6 of their largest magnitude.  Launch counts
           are zeroed just before the fanned-out and the sharded runs and
           read just after; one flash_decode launch a shard a layer a
           step.  No speed across cards is claimed.
  train    stablelm-1.6b (24 layers, d 2048, 32 heads, d_ff 5632, vocab
           100352: 1.644 B params, fp32 weights, gradients and AdamW
           moments, 26.3 GB), then hymba-1.5b (32 layers, d 1600, attention
           over 25 heads on 5 KV heads beside a mamba mixer of d_inner
           3200, d_ff 5504, vocab 32001: 1.662 B params, 26.6 GB), each at
           its published width and depth and alone on the card, through
           steps/train.py's build_train_step at B 8 x S 512, every layer
           rematerialised: (a) one step's loss and gradients through the
           kernels against the plain versions in fp32 compute (loss within
           1e-5 relative, every gradient leaf at cosine >= 0.9999); (b) 20
           steps in bf16 compute at lr 3e-4 on the zipf TokenStream, launch
           counts zeroed just before and read just after (per step,
           stablelm: 2 x 24 flash_attention, 24 flash_attention_bwd, 97
           rmsnorm, 49 rmsnorm_bwd; hymba: 2 x 32 flash_attention and
           ssm_scan, 32 flash_attention_bwd and ssm_scan_bwd, 129 rmsnorm,
           65 rmsnorm_bwd; every other kernel none); the mean loss of the
           last 5 below the first 5's;
           ms a step by CUDA events, the host's enqueue time a step,
           tokens/s, the model flops (6 N tokens, N the active params:
           roofline.model_flops) over the step time at the bf16 peak, peak
           memory; then one traced step's five largest device operations,
           its wall, device busy time and idle share and its largest
           kernels; (c) launch/train.py at the smoke
           config: 3 steps, a checkpoint and 3 resumed steps against 6
           straight ones (losses within 1e-5, params within 1e-6).
  dryrun   the dry run (src/repro_torch/launch/dryrun.py's tracing on the
           meta device) against the card, for three steps: stablelm-1.6b's
           train step at B 8 x S 512, hymba-1.5b's first decode step at the
           generate phase's batch (16 prompts of 64 tokens, 80 fp32 cache
           slots) and bge-large-zh-v1.5's bf16 forward at B 16 x S 96.
           Each is traced on meta tensors (roofline.op_cost: flops, bytes,
           kernel calls, peak temp bytes; roofline.analysis: model flops
           and the H100 roofline bound), then run on the card from seeded
           random weights: launch counts zeroed just before one step and
           read just after must equal the kernel calls counted on meta,
           and the step's device time must be at or above the bound, both
           its span by CUDA events (median of 3) and its busy time (the
           kernels' durations in a torch.profiler trace).  It reports the
           share of the bf16 peak and the dry run's argument + temp bytes
           over torch.cuda.max_memory_allocated (no limit yet).
  profile  (only when named) one bge forward at B=16 x S=96 under each
           policy, and one prefill (B=16 x S=64) and decode step of each
           of the eight decoders:
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
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("build", "kernels", "golden", "serve", "offload", "chaos",
          "generate", "encdec", "mesh", "train", "dryrun")
EXTRA_PHASES = ("profile",)          # run only when named in --phases
# the card's rates (H100 SXM data sheet) and each kernel's work are the
# dry run's: one definition, in src/repro_torch/roofline (outside the
# repo this import fails, and the script prints no result)
from repro_torch.roofline import analysis as roofline  # noqa: E402
from repro_torch.roofline import kernel_cost  # noqa: E402

HBM_BYTES_PER_S = roofline.HBM_BW
PEAK_FLOPS = {"float32": roofline.PEAK_FLOPS_FP32,  # outside tensor cores
              "bfloat16": roofline.PEAK_FLOPS_BF16,  # dense tensor cores
              "int8": roofline.PEAK_OPS_INT8}        # dense tensor cores
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
# the backward kernels replace no TPU kernel (the reference trains through
# its jnp attention and norm and its lax.scan); each row names the forward
# it differentiates
FAB_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
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
# the other decoder families, each at its published width, one at a time;
# starcoder2-7b also takes one prompt longer than its 4096-token window
DECODERS = ("stablelm-1.6b", "starcoder2-7b", "falcon-mamba-7b",
            "internlm2-20b", "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
            "internvl2-2b", "qwen2-72b")
LM_ARCHS = (LM_ARCH,) + DECODERS
MOE = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")
# served on bf16-resident weights: 39.7 GB, 60.2 GB and (24 layers) 47.1 GB
# (fp32 would take 79.4 GB, 120 GB and 94.2 GB of the card's 80)
BF16_WEIGHTS = ("internlm2-20b", "qwen3-moe-30b-a3b", "qwen2-72b")
# qwen2-72b keeps its published width with its depth cut to what one card
# holds: 24 of 80 layers (1.76 GB of bf16 weights a layer, 4.98 GB for the
# embedding and the head); served in waves of 8
DEPTH_CUTS = {"qwen2-72b": 24}
GEN_B = {"qwen2-72b": 8}
VLM_PATCH_B = 16                     # the patch-prefix prefill's batch
# the encoder-decoder, at LM_B x LM_PROMPT + LM_NEW over its 1500 frames
ENC_ARCH = "whisper-tiny"
# (batch, prompt tokens, new tokens)
LONG_PROMPTS = {LM_ARCH: (2, LONG_PROMPT, LM_NEW),
                "starcoder2-7b": (1, 4160, 5)}
# 64 mamba layers of random weights amplify bf16 rounding: the JAX
# package's own bf16 and fp32 prefill logits differ (cosine about 0.5,
# tests/test_torch_lm.py), so a bf16 kernel-vs-plain cosine says nothing
# of the kernels there; it is reported and the fp32 one held
BF16_DRIFTS = ("falcon-mamba-7b",)
# each family's path on the card (starcoder2's layernorm is plain ops)
LM_KERNELS = {LM_ARCH: ("rmsnorm", "flash_attention", "ssm_scan",
                        "flash_decode"),
              "stablelm-1.6b": ("rmsnorm", "flash_attention", "flash_decode"),
              "starcoder2-7b": ("flash_attention", "flash_decode"),
              "falcon-mamba-7b": ("rmsnorm", "ssm_scan"),
              **{a: ("rmsnorm", "flash_attention", "flash_decode")
                 for a in DECODERS[3:]}}
# the offload (Table 1) and chaos runs: bge at its published width, fp32, a
# burst of 24-token queries; chaos serves waves through one real tier whose
# execution 1 fails and execution 3 is corrupted
OFFLOAD_SLO, OFFLOAD_QUERIES = 0.5, 56
CHAOS_WAVES, CHAOS_WAVE, CHAOS_FAIL, CHAOS_CORRUPT = 4, 8, {1}, {3}
# the mesh phase: 4 logical devices placed round-robin on the visible
# cards; bge's embed tier fanned out over them, and qwen2-72b's decode on
# a 256-slot cache split into 4 shards of 64, B 4, after prompts of 200
# (shards 0-2 full, shard 3 the owner) and 40 tokens (shards 1-3 empty),
# 16 greedy tokens
MESH_POSITIONS = 4
MESH_ARCH, MESH_B, MESH_CACHE, MESH_PROMPTS, MESH_NEW = (
    "qwen2-72b", 4, 256, (200, 40), 16)
# the train phase: stablelm-1.6b, the reference's default training model,
# and hymba-1.5b (attention and mamba heads in parallel), each at its
# published width and depth (1.644 B and 1.662 B params), B 8 x S 512, bf16
# compute, AdamW at lr 3e-4 for TRAIN_STEPS steps on the zipf TokenStream;
# the checkpoint resume runs on stablelm's smoke config
TRAIN_ARCHS = ("stablelm-1.6b", "hymba-1.5b")
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = (
    TRAIN_ARCHS[0], 8, 512, 20, 3e-4)
TRAIN_LOSS_REL, TRAIN_GRAD_COSINE = 1e-5, 0.9999
# the dryrun phase's steps (arch, batch, tokens): stablelm-1.6b's train
# step, hymba-1.5b's first decode step at the generate phase's batch after
# its 64-token prompts, bge-large-zh-v1.5's bf16-policy forward
DRYRUN_STEPS = {"stablelm_train": (TRAIN_ARCH, TRAIN_B, TRAIN_S),
                "hymba_decode": (LM_ARCH, LM_B, LM_PROMPT),
                "bge_bf16_forward": ("bge-large-zh-v1.5", MAIN_B, MAIN_S)}


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


def kernel_split(fn, names, calls: int = 3) -> dict:
    """Device ms a call of ``fn`` spent in each kernel whose name contains
    one of ``names``: a torch.profiler trace of ``calls`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    attr = ("self_device_time_total"
            if rows and hasattr(rows[0], "self_device_time_total")
            else "self_cuda_time_total")
    return {n: sum(getattr(r, attr) for r in rows if n in r.key)
            / 1e3 / calls for n in names}


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


def _attn_inputs(dev, B, H, KV, S, Sk, hd, dt, kv_len, seed=0):
    """q (B, H, S, hd) and k, v (B, KV, Sk, hd)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Sk, KV, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Sk, KV, hd), np.float32))
    # (B, S, heads, hd) projections seen as (B, heads, S, hd), as
    # models.layers.attn_forward passes them
    q, k, v = (t.to(dev, dt).transpose(1, 2) for t in (q, k, v))
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return q, k, v, kvl


def attention_case(dev, B, H, KV, S, hd, dt, kv_len, *, causal=False,
                   window=0, Sk=None) -> dict:
    """S queries over Sk keys (S unless given), ``kv_len`` a row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref, flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_mask

    Sk = S if Sk is None else Sk
    q, k, v, kvl = _attn_inputs(dev, B, H, KV, S, Sk, hd, dt, kv_len)
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
    out = {"B": B, "H": H, "KV": KV, "S": S, "Sk": Sk, "hd": hd,
           "dtype": dtype_name(dt),
           "causal": causal, "window": window, "kv_len": list(kv_len),
           "max_abs_err": err, "tol": tol, "finite": finite,
           "kv_len0_rows_zero": zeros_ok,
           "ok": err <= tol and finite and zeros_ok}
    # what these inputs need (kernel_cost.flash_attention): q rows with at
    # least one valid key, k and v rows that some query may see, every
    # output row and kv_len; QK^T and PV over the valid pairs
    mask = attention_mask(B, S, Sk, causal=causal, window=window, kv_len=kvl,
                          device=dev)                       # (B, Sq, Sk)
    flops, nbytes = kernel_cost.flash_attention(
        B, H, KV, S, Sk, hd, q.element_size(), int(mask.sum().item()),
        int(mask.any(-1).sum().item()), int(mask.any(-2).sum().item()))
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
    # what these inputs need (kernel_cost.pool_norm): the hidden rows of
    # unmasked tokens (mean) or token 0 of rows whose first token is
    # unmasked (CLS), the mask, the output
    rows = (sum(min(n, S) for n in lens) if pool == "mean"
            else sum(1 for n in lens if n > 0))
    flops, nbytes = kernel_cost.pool_norm(B, S, D, h.element_size(), pool,
                                          rows)

    def library():
        if pool == "mean":
            pooled = torch.einsum("bsd,bs->bd", h.float(), mask) \
                / mask.sum(1, keepdim=True).clamp_min(1.0)
            return F.normalize(pooled, dim=-1, eps=1e-9)
        # CLS needs token 0 of each row and mask[:, 0] only
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
    flops, nbytes = kernel_cost.quant_matmul(M, K, N, x.element_size())
    out["bound_ms"], out["bound_by"] = bound(nbytes, passes * flops,
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
    flops, nbytes = kernel_cost.quantize_rows(M, K, x.element_size())
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, "float32")
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
    flops, nbytes = kernel_cost.w8a8_matmul(M, K, N, got.element_size())
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, "int8")
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
    flops, nbytes = kernel_cost.rmsnorm(R, D, x.element_size())
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, "float32")
    out["kernel_ms"] = time_ms(lambda: rmsnorm(x, scale, 1e-5), dev)
    out["plain_ms"] = time_ms(lambda: rmsnorm_ref(x, scale, 1e-5), dev)
    w = scale.to(dt)
    try:
        out["library_ms"] = time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5), dev)
    except (AttributeError, RuntimeError) as e:
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def _grad_held(got, want, dt) -> tuple:
    """(ok, measure) of one gradient against its plain version: fp32
    max-abs within 1e-4 of its largest magnitude (measure: max-abs over
    that magnitude), bf16 cosine at least 0.999 (measure: the cosine)."""
    import torch

    g, w = got.float().flatten(), want.float().flatten()
    if not bool(torch.isfinite(g).all().item()):
        return False, float("nan")
    if dt == torch.float32:
        err, mag = _rel_err(g, w)
        return err <= 1e-4 * max(mag, 1e-30), err / max(mag, 1e-30)
    if w.abs().max().item() == 0:
        return g.abs().max().item() == 0, 1.0
    cos = torch.nn.functional.cosine_similarity(g, w, dim=0).item()
    return cos >= 0.999, cos


def attention_bwd_case(dev, B, H, KV, Sq, Sk, hd, dt, kv_len, *,
                       causal=False, window=0) -> dict:
    """The backward kernel against ``attention_bwd_ref`` on the same q, k,
    v, output, output gradient and lse, and the forward kernel's lse
    against the plain version's."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ops import _forward
    from repro_torch.kernels.flash_attention.ref import attention_mask

    q, k, v, kvl = _attn_inputs(dev, B, H, KV, Sq, Sk, hd, dt, kv_len)
    rng = np.random.default_rng(9)
    do = torch.from_numpy(rng.standard_normal((B, Sq, H, hd), np.float32)
                          ).to(dev, dt).transpose(1, 2)
    kw = dict(causal=causal, window=window, kv_len=kvl)
    out, lse = attention_ref(q, k, v, return_lse=True, **kw)
    lse = lse.float().contiguous()
    got = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    want = attention_bwd_ref(q, k, v, out, do, lse, **kw)
    held = [_grad_held(g, w, dt) for g, w in zip(got, want)]
    # no float atomics: a second call gives the same bits
    repeat = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    if dev.type == "cuda":
        _, klse = _forward(q, k, v, causal, window, kvl, True)
    else:                      # the rehearsal: the plain version's lse
        klse = attention_ref(q, k, v, return_lse=True, **kw)[1].float()
    none = lse == -1e30
    lse_err = ((klse[~none] - lse[~none]).abs().max().item()
               if bool((~none).any().item()) else 0.0)
    lse_ok = bool((klse[none] == -1e30).all().item()) and lse_err <= 1e-4
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out_d = {"B": B, "H": H, "KV": KV, "S": Sq, "Sk": Sk, "hd": hd,
             "dtype": dtype_name(dt), "causal": causal, "window": window,
             "kv_len": list(kv_len),
             "held": ("max_abs_over_max" if dt == torch.float32
                      else "cosine"),
             "dq": held[0][1], "dk": held[1][1], "dv": held[2][1],
             "max_abs_err": max(_rel_err(g, w)[0] for g, w in zip(got, want)),
             "lse_max_abs_err": lse_err, "lse_ok": lse_ok,
             "bitwise_repeat": repeat,
             "ok": all(ok for ok, _ in held) and lse_ok and repeat}
    # reads q, o, dO, k, v and lse once, writes dq, dk and dv once; the
    # products the gradients need: q k^T, dO v^T, dV, dK and dQ, 2 hd
    # flops each a valid (query, key) pair a head
    mask = attention_mask(B, Sq, Sk, causal=causal, window=window,
                          kv_len=kvl, device=dev)
    flops, nbytes = kernel_cost.flash_attention_bwd(
        B, H, KV, Sq, Sk, hd, q.element_size(), int(mask.sum().item()))
    # on the same basis as the forward's: fp32 on the bf16 tensor cores as
    # six products of its exact three-term split, as the kernel runs it;
    # the CUDA cores' fp32 rate's bound is given beside
    out_d["bound_ms"], out_d["bound_by"] = bound(
        nbytes, 6 * flops if dt == torch.float32 else flops, "bfloat16")
    out_d["bound_cuda_core_ms"] = bound(nbytes, flops, "float32")[0]
    reps = dict(reps=5, inner=3)
    out_d["kernel_ms"] = time_ms(
        lambda: flash_attention_bwd(q, k, v, out, do, lse, **kw), dev, **reps)
    if dev.type == "cuda":
        out_d["split_ms"] = kernel_split(
            lambda: flash_attention_bwd(q, k, v, out, do, lse, **kw),
            ("attn_bwd_delta", "attn_bwd<"))
    out_d["plain_ms"] = time_ms(
        lambda: attention_bwd_ref(q, k, v, out, do, lse, **kw), dev, **reps)
    # yardstick: autograd's backward of scaled_dot_product_attention
    try:
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lib_kw = {"enable_gqa": True} if H != KV else {}
        lo = F.scaled_dot_product_attention(ql, kl, vl,
                                            attn_mask=mask[:, None],
                                            **lib_kw)
        out_d["library_ms"] = time_ms(
            lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                        retain_graph=True), dev, **reps)
    except (TypeError, RuntimeError) as e:
        out_d["library_ms"], out_d["library_error"] = None, repr(e)[:200]
    return out_d


def rmsnorm_bwd_case(dev, R, D, dt) -> dict:
    """The RMSNorm backward kernel against ``rmsnorm_bwd_ref``: dx and the
    scale's gradient (summed over the R rows)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_ref

    rng = np.random.default_rng(6)
    x, dy = (torch.from_numpy(rng.standard_normal((R, D), np.float32) * 2)
             .to(dev, dt) for _ in range(2))
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(D)
                             .astype(np.float32)).to(dev)
    got = rmsnorm_bwd(x, scale, dy, 1e-5)
    again = rmsnorm_bwd(x, scale, dy, 1e-5)
    want = rmsnorm_bwd_ref(x, scale, dy, 1e-5)
    held = [_grad_held(g, w, dt) for g, w in zip(got, want)]
    # no atomics: a second call gives the same bits
    repeat = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    out = {"R": R, "D": D, "dtype": dtype_name(dt),
           "held": "max_abs_over_max" if dt == torch.float32 else "cosine",
           "dx": held[0][1], "dscale": held[1][1],
           "max_abs_err": max(_rel_err(g, w)[0] for g, w in zip(got, want)),
           "bitwise_repeat": repeat,
           "ok": all(ok for ok, _ in held) and repeat}
    # reads x, dy and the scale once, writes dx and dscale once; about 8
    # flops an element (two sums, dx, the scale's partial)
    flops, nbytes = kernel_cost.rmsnorm_bwd(R, D, x.element_size())
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, "float32")
    out["kernel_ms"] = time_ms(lambda: rmsnorm_bwd(x, scale, dy, 1e-5), dev)
    if dev.type == "cuda":
        out["split_ms"] = kernel_split(
            lambda: rmsnorm_bwd(x, scale, dy, 1e-5),
            ("rmsnorm_bwd_rows", "rmsnorm_bwd_wide", "rmsnorm_bwd_dscale"))
    out["plain_ms"] = time_ms(lambda: rmsnorm_bwd_ref(x, scale, dy, 1e-5),
                              dev)
    try:
        xl = x.detach().requires_grad_()
        wl = scale.to(dt).detach().requires_grad_()
        yl = F.rms_norm(xl, (D,), wl, 1e-5)
        out["library_ms"] = time_ms(
            lambda: torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True),
            dev)
    except (AttributeError, RuntimeError) as e:
        out["library_ms"], out["library_error"] = None, repr(e)[:200]
    return out


def ssm_case(dev, B, S, DI, N, dt, sfu) -> dict:
    """The selective scan from a zero state; y and h are fp32 on both
    sides, so the limit is fp32's for either x dtype.  ``sfu``: the card's
    exp2 rate (``sfu_rate``)."""
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref

    x, dtv, Bm, Cm, A = _scan_inputs(dev, B, S, DI, N, dt)
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
    flops, nbytes = kernel_cost.ssm_scan(B, S, DI, N, x.element_size())
    terms = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "fma_ms": flops / PEAK_FLOPS["float32"] * 1e3,
             "sfu_ms": kernel_cost.ssm_scan_exps(B, S, DI, N)
             / sfu["per_s"] * 1e3}
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


def _scan_inputs(dev, B, S, DI, N, dt, seed=6):
    """x (in ``dt``), softplus dt, B and C, A = -(1 .. N) in every channel
    (Mamba-1's S4D-real start), from one seeded generator."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    x = t(rng.standard_normal((B, S, DI)), dt)
    dtv = t(np.log1p(np.exp(rng.standard_normal((B, S, DI)))))  # softplus
    Bm, Cm = (t(rng.standard_normal((B, S, N))) for _ in range(2))
    A = t(-np.broadcast_to(np.arange(1, N + 1), (DI, N)))
    return x, dtv, Bm, Cm, A


# the scan backward's gradients, in the order ssm_scan_bwd returns them
SCAN_GRADS = ("dx", "ddt", "dBm", "dCm", "dA")


def ssm_bwd_case(dev, B, S, DI, N, dt, dh, sfu) -> dict:
    """The scan's backward kernel against ``ssm_scan_bwd_ref`` on the same
    inputs, output gradient dy and, when ``dh``, a nonzero final-state
    gradient; the chunk states from the forward kernel.  Each gradient is
    held within 1e-4 of its largest magnitude (fp32 on both sides), but dx
    of a bf16 x within one bf16 step at its largest magnitude (2^-7 of
    it): both round it once from fp32.  The plain version timed is
    autograd's backward of ``ssm_scan_ref``."""
    import numpy as np
    import torch

    from repro_torch.kernels.ssm_scan import (ssm_scan_bwd, ssm_scan_bwd_ref,
                                              ssm_scan_ref)
    from repro_torch.kernels.ssm_scan.ops import _forward

    x, dtv, Bm, Cm, A = _scan_inputs(dev, B, S, DI, N, dt)
    rng = np.random.default_rng(7)
    dy = torch.from_numpy(rng.standard_normal((B, S, DI), np.float32)).to(dev)
    dhf = (torch.from_numpy(rng.standard_normal((B, DI, N), np.float32))
           .to(dev) if dh else None)
    states = (_forward(x, dtv, Bm, Cm, A, True)[2] if dev.type == "cuda"
              else None)
    args = (x, dtv, Bm, Cm, A, dy, dhf, states)
    got = ssm_scan_bwd(*args)
    again = ssm_scan_bwd(*args)
    want = ssm_scan_bwd_ref(*args[:7])
    # no float atomics: a second call gives the same bits
    repeat = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    out = {"B": B, "S": S, "DI": DI, "N": N, "x_dtype": dtype_name(dt),
           "dh_final": dh, "held": "max_abs_over_max",
           "max_abs_err": max(_rel_err(g, w)[0] for g, w in zip(got, want)),
           "bitwise_repeat": repeat}
    ok = repeat and got[0].dtype == dt
    for name, g, w in zip(SCAN_GRADS, got, want):
        err, mag = _rel_err(g, w)
        rel = err / max(mag, 1e-30)
        lim = 2.0 ** -7 if name == "dx" and dt == torch.bfloat16 else 1e-4
        out[name] = rel
        ok = ok and bool(torch.isfinite(g).all().item()) and rel <= lim
    out["ok"] = ok
    # reads x, dt and dy, writes dx and ddt: (B, S, DI) streams; reads B, C
    # and writes dB, dC; reads A, dh_final and the forward's chunk states,
    # writes dA.  A (b, t, d, n) needs one exp on the SFU (the kernel forms
    # it twice, in the recompute and the reverse step) and 19 fp32 flops
    # (the recompute 5, the reverse step 10, the sums over n and d 4); a
    # (b, t, d) 5 more.
    flops, nbytes = kernel_cost.ssm_scan_bwd(B, S, DI, N, x.element_size(),
                                             dh)
    terms = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "fma_ms": flops / PEAK_FLOPS["float32"] * 1e3,
             "sfu_ms": kernel_cost.ssm_scan_exps(B, S, DI, N)
             / sfu["per_s"] * 1e3}
    out["bound_ms"] = max(terms.values())
    out["bound_by"] = ("bytes" if terms["bytes_ms"] == out["bound_ms"]
                       else "operations")
    out["bound_terms"] = terms
    out["kernel_ms"] = time_ms(lambda: ssm_scan_bwd(*args), dev)
    if dev.type == "cuda":
        out["split_ms"] = kernel_split(lambda: ssm_scan_bwd(*args),
                                       ("ssm_scan_bwd_kernel",
                                        "ssm_scan_bwd_sums"))
    # the plain version: autograd's backward of the plain scan, its graph
    # built once; S small ops a step, so few repetitions at a long S
    leaves = [a.detach().clone().requires_grad_() for a in (x, dtv, Bm, Cm,
                                                             A)]
    y, h = ssm_scan_ref(*leaves)
    grads = (dy, dhf if dh else torch.zeros_like(h))
    few = {"reps": 3, "inner": 2} if S > 256 else {}
    out["plain_ms"] = time_ms(
        lambda: torch.autograd.grad((y, h), leaves, grads,
                                    retain_graph=True), dev, **few)
    del y, h, leaves
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
    flops, nbytes = kernel_cost.flash_decode(
        B, KV, G, hd, Sc, n_valid, q.element_size(), k.element_size())
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, "float32")
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


def flash_decode_lse_case(dev, B, KV, G, hd, shards, slots, qdt,
                          cdt) -> dict:
    """The sequence-sharded decode read (``flash_decode_sharded``): a cache
    of ``shards * slots`` valid slots split into shards, each read by the
    kernel with its log-sum-exp, then the combine on the home device;
    against the plain version (the reference's shard_map formula) and, for
    the log-sum-exps, each shard's plain ``lse``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (decode_attention_ref,
                                                  flash_decode,
                                                  flash_decode_sharded,
                                                  sharded_decode_ref)

    rng = np.random.default_rng(8)
    Sc = shards * slots
    pos = Sc - 1
    q = torch.from_numpy(rng.standard_normal((B, KV, G, hd), np.float32)
                         ).to(dev, qdt)
    k, v = (torch.from_numpy(rng.standard_normal((B, Sc, KV, hd), np.float32)
                             ).to(dev, cdt) for _ in range(2))
    kpos = ring_kpos(dev, Sc, pos)
    ks, vs, kps = (list(t.split(slots, dim)) for t, dim in
                   ((k, 1), (v, 1), (kpos, 0)))
    got = flash_decode_sharded(q, ks, vs, kps, pos)
    want = sharded_decode_ref(q, ks, vs, kps, pos)
    err, mag = _rel_err(got, want)
    tol = (1e-4 if qdt == torch.float32 else 2e-2) * mag
    lse_err = lse_mag = 0.0
    for kk, vv, kp in zip(ks, vs, kps):
        lse = flash_decode(q, kk, vv, kp, pos, lse=True)[1]
        ref = decode_attention_ref(q, kk, vv, kp, pos, lse=True)[1]
        e, m = _rel_err(lse, ref)
        lse_err, lse_mag = max(lse_err, e), max(lse_mag, m)
    lse_ok = lse_err <= 1e-4 * max(lse_mag, 1.0)
    out = {"B": B, "KV": KV, "G": G, "hd": hd, "shards": shards,
           "slots_per_shard": slots, "pos": pos,
           "dtype": f"q {dtype_name(qdt)}, cache {dtype_name(cdt)}",
           "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
           "ok": err <= tol and lse_ok and got.dtype == qdt}
    # q and the output once, every slot's k and v rows once (all valid),
    # kpos; QK and PV over the slots
    flops, nbytes = kernel_cost.flash_decode(
        B, KV, G, hd, Sc, Sc, q.element_size(), k.element_size())
    out["bound_ms"], out["bound_by"] = bound(nbytes, flops, "float32")
    out["kernel_ms"] = time_ms(
        lambda: flash_decode_sharded(q, ks, vs, kps, pos), dev)
    # the shards' launches alone, without the combine's plain ops
    out["lse_launches_ms"] = time_ms(
        lambda: [flash_decode(q, kk, vv, kp, pos, lse=True)
                 for kk, vv, kp in zip(ks, vs, kps)], dev)
    out["plain_ms"] = time_ms(
        lambda: sharded_decode_ref(q, ks, vs, kps, pos), dev)
    q4 = q.reshape(B, KV * G, 1, hd)
    ke, ve = (t.transpose(1, 2).repeat_interleave(G, 1).to(qdt).contiguous()
              for t in (k, v))
    out["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q4, ke, ve), dev)
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
    # stablelm-1.6b's prefill (32 heads of 64, G 1) and starcoder2-7b's
    # (36 on 4 KV heads of 128, window 4096), then one starcoder2 prompt
    # longer than the window; granite-moe-3b-a800m's (G 3 x hd 64),
    # qwen3-moe-30b-a3b's (G 8 x hd 64), internlm2-20b's (G 6 x hd 128)
    # and internvl2-2b's (G 2 x hd 128), with and without its 256 patches
    # before the prompt (on the CPU: smoke widths)
    dec_attn = ((("stablelm_S64", LM_B, LM_PROMPT, 32, 32, 64, 0),
                 ("starcoder2_S64", LM_B, LM_PROMPT, 36, 4, 128, 4096),
                 ("starcoder2_S4160", 1, 4160, 36, 4, 128, 4096),
                 ("granite_S64", LM_B, LM_PROMPT, 24, 8, 64, 0),
                 ("qwen3_S64", LM_B, LM_PROMPT, 32, 4, 64, 0),
                 ("internlm2_S64", LM_B, LM_PROMPT, 48, 8, 128, 0),
                 ("internvl2_S64", LM_B, LM_PROMPT, 16, 8, 128, 0),
                 ("internvl2_S320", VLM_PATCH_B, 256 + LM_PROMPT, 16, 8, 128,
                  0)) if t else
                (("stablelm_S64", 2, 24, 4, 4, 32, 0),
                 ("starcoder2_S64", 2, 24, 9, 1, 32, 16),
                 ("starcoder2_S4160", 1, 70, 9, 1, 32, 64),
                 ("granite_S64", 2, 24, 6, 2, 32, 0),
                 ("qwen3_S64", 2, 24, 8, 1, 32, 0),
                 ("internlm2_S64", 2, 24, 6, 1, 32, 0),
                 ("internvl2_S64", 2, 24, 4, 2, 32, 0),
                 ("internvl2_S320", 2, 40, 4, 2, 32, 0)))
    for tag, b, s, h, kv, d, win in dec_attn:
        for dt in (f32, bf16):
            attn.append(attention_case(dev, b, h, kv, s, d, dt, [s] * b,
                                       causal=True, window=win))
        attn_cases[f"{tag}_fp32"], attn_cases[f"{tag}_bf16"] = attn[-2:]
    # whisper-tiny (6 heads of 64, G 1): its encoder over the 1500 frames
    # and its prefill's cross attention (64 decoder queries over them),
    # both bidirectional, and its decoder's causal self-attention (on the
    # CPU: the smoke config's 32 frames, 4 heads of 32)
    wb, wh, whd, wf = (LM_B, 6, 64, 1500) if t else (2, 4, 32, 32)
    wp = LM_PROMPT if t else 24
    for tag, sq, sk, causal in (("whisper_enc_S1500", wf, wf, False),
                                ("whisper_cross_Sq64_Sk1500", wp, wf, False),
                                ("whisper_dec_S64", wp, wp, True)):
        for dt in (f32, bf16):
            attn.append(attention_case(dev, wb, wh, wh, sq, whd, dt,
                                       [sk] * wb, causal=causal, Sk=sk))
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
    # stablelm-1.6b's d 2048, falcon-mamba-7b's 4096, granite-moe's 1536
    # and internlm2-20b's 6144: prefill, decode
    dec_rms = {f"{m}_{step}_{dtype_name(dt)}": rmsnorm_case(dev, r, d, dt)
               for m, d in (("stablelm", 2048 if t else 128),
                            ("falcon_mamba", 4096 if t else 128),
                            ("granite", 1536 if t else 128),
                            ("internlm2", 6144 if t else 128))
               for step, r in (("prefill", Bl * Sl), ("decode", Bl))
               for dt in (bf16, f32)}
    rms += list(dec_rms.values())
    # the prefill's scan, a small off-tile one, and the 1100-token prompt
    sfu = sfu_rate(dev)
    ssm = [ssm_case(dev, b, s, di, LM_N, dt, sfu) for b, s, di in
           ((Bl, Sl, DI), (2, 50, 200), (2, LONG_PROMPT if t else 40, DI),
            (Bl, Sl, 8192 if t else 512))       # falcon-mamba-7b's prefill
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
                            5000 if t else 70, 4096 if t else 64, bf16, f32),
          # the served decode steps of stablelm-1.6b (32 KV heads, G 1, no
          # window) and starcoder2-7b (G 9 x hd 128, window 4096)
          flash_decode_case(dev, Bl, 32 if t else 4, 1, 64 if t else 32, Sc,
                            Sc - 1, 0, bf16, f32),
          flash_decode_case(dev, Bl, 4 if t else 1, 9, 128 if t else 32, Sc,
                            Sc - 1, 4096 if t else 16, bf16, f32),
          # the served decode steps of granite-moe-3b-a800m (G 3 x hd 64),
          # qwen3-moe-30b-a3b (G 8 x hd 64), internlm2-20b (G 6 x hd 128)
          # and internvl2-2b (G 2 x hd 128), whose cache keeps 256 more
          # slots for patches, empty on the served path
          *(flash_decode_case(dev, Bl, kv, g, d if t else 32, sc, Sc - 1, 0,
                              bf16, f32)
            for kv, g, d, sc in (((8, 3, 64, Sc), (4, 8, 64, Sc),
                                  (8, 6, 128, Sc), (8, 2, 128, Sc + 256))
                                 if t else
                                 ((2, 3, 64, Sc), (1, 8, 64, Sc),
                                  (1, 6, 128, Sc), (2, 2, 128, Sc + 16)))),
          # whisper-tiny's decoder self-attention (6 KV heads, G 1, hd 64)
          flash_decode_case(dev, Bl, 6 if t else 2, 1, 64 if t else 32, Sc,
                            Sc - 1, 0, bf16, f32),
          # qwen2-72b's served decode step (B 8, 8 KV heads, G 8 x hd 128)
          flash_decode_case(dev, GEN_B[MESH_ARCH], 8 if t else 1, 8,
                            128 if t else 32, Sc, Sc - 1, 0, bf16, f32)]
    # qwen2-72b's sequence-sharded read: 4 shards of 1024 slots (on the
    # CPU: of 16), in the served (q, cache) pair and in fp32
    fd_lse = [flash_decode_lse_case(dev, GEN_B[MESH_ARCH], 8 if t else 1, 8,
                                    128 if t else 32, MESH_POSITIONS,
                                    1024 if t else 16, qdt, f32)
              for qdt in (bf16, f32)]
    # the backward kernels: stablelm-1.6b's training attention (B 8 x S
    # 512, 32 heads of 64, causal), GQA (64 on 8 KV heads of 128, S 1024),
    # a window, a ragged kv_len with a row of none, whisper's cross
    # attention (64 queries over 1500 frames); RMSNorm at stablelm's
    # training rows (d 2048) and internlm2's d 6144 (on the CPU: smoke
    # sizes)
    bwd_shapes = ((("stablelm_train", TRAIN_B, 32, 32, TRAIN_S, TRAIN_S, 64,
                    True, 0, None),
                   ("gqa_H64_KV8_hd128_S1024", 2, 64, 8, 1024, 1024, 128,
                    True, 0, None),
                   ("window_256", 4, 16, 4, 1024, 1024, 64, True, 256, None),
                   ("ragged_kv_len0", 4, 16, 16, 256, 256, 64, False, 0,
                    [256, 131, 0, 7]),
                   ("whisper_cross_Sq64_Sk1500", LM_B, 6, 6, LM_PROMPT, 1500,
                    64, False, 0, None)) if t else
                  (("stablelm_train", 2, 4, 4, 32, 32, 32, True, 0, None),
                   ("gqa_H64_KV8_hd128_S1024", 1, 8, 2, 40, 40, 32, True, 0,
                    None),
                   ("window_256", 2, 4, 2, 40, 40, 16, True, 12, None),
                   ("ragged_kv_len0", 4, 4, 4, 24, 24, 16, False, 0,
                    [24, 13, 0, 7]),
                   ("whisper_cross_Sq64_Sk1500", 2, 4, 4, 8, 40, 16, False, 0,
                    None)))
    attn_bwd, attn_bwd_cases = [], {}
    for tag, b, h, kv, sq, sk, d, causal, win, lens in bwd_shapes:
        for dt in (bf16, f32):
            attn_bwd.append(attention_bwd_case(
                dev, b, h, kv, sq, sk, d, dt, lens or [sk] * b,
                causal=causal, window=win))
            attn_bwd_cases[f"{tag}_{dtype_name(dt)}"] = attn_bwd[-1]
    # the scan's backward: hymba-1.5b's training shape (B 8 x S 512, d_inner
    # 3200), falcon-mamba-7b's d_inner 8192, the 1100-token prompt, S and
    # DI off the 16-step chunks and the 32-channel blocks; each with and
    # without a final-state gradient, in both x dtypes (on the CPU: smoke
    # sizes)
    scan_bwd_shapes = ((("hymba_train", TRAIN_B, TRAIN_S, LM_DI),
                        ("falcon_mamba_DI8192", 4, TRAIN_S, 8192),
                        ("long_prompt", 2, LONG_PROMPT, LM_DI),
                        ("B3_S33_DI130", 3, 33, 130), ("B1_S1_DI7", 1, 1, 7))
                       if t else
                       (("hymba_train", 2, 32, DI), ("falcon_mamba_DI8192", 2,
                                                      32, 512),
                        ("long_prompt", 2, 40, DI),
                        ("B3_S33_DI130", 3, 33, 130), ("B1_S1_DI7", 1, 1, 7)))
    ssm_bwd, ssm_bwd_cases = [], {}
    for tag, b, s, di in scan_bwd_shapes:
        for dt in (bf16, f32):
            for dh in (False, True):
                ssm_bwd.append(ssm_bwd_case(dev, b, s, di, LM_N, dt, dh, sfu))
                key = f"{tag}_{dtype_name(dt)}{'_dh' if dh else ''}"
                ssm_bwd_cases[key] = ssm_bwd[-1]
    rms_bwd_rows = TRAIN_B * TRAIN_S if t else 64
    rms_bwd, rms_bwd_cases = [], {}
    for d in ((2048, 6144) if t else (128, 200)):
        for dt in (bf16, f32):
            rms_bwd.append(rmsnorm_bwd_case(dev, rms_bwd_rows, d, dt))
            rms_bwd_cases[f"d{d}_{dtype_name(dt)}"] = rms_bwd[-1]
    cases = ([("flash_attention", c) for c in attn]
             + [("pool_norm", c) for c in pools]
             + [("quant_matmul", c) for c in qm]
             + [("quantize_rows", c) for c in qr]
             + [("w8a8_matmul", c) for c in w8]
             + [("rmsnorm", c) for c in rms]
             + [("ssm_scan", c) for c in ssm]
             + [("flash_decode", c) for c in fd + fd_lse]
             + [("flash_attention_bwd", c) for c in attn_bwd]
             + [("rmsnorm_bwd", c) for c in rms_bwd]
             + [("ssm_scan_bwd", c) for c in ssm_bwd])
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
            # the train path: bf16 compute at stablelm-1.6b's training
            # shape; the scan at hymba-1.5b's, whose h_final has no gradient
            "flash_attention_bwd": attn_bwd[0], "rmsnorm_bwd": rms_bwd[0],
            "ssm_scan_bwd": ssm_bwd[0],
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
                          "decode_float32": rms[2], "decode_bfloat16": rms[3],
                          **dec_rms},
                      "ssm_scan": {
                          "prefill_bfloat16": ssm[0], "prefill_float32": ssm[1],
                          "B2_S50_DI200_bfloat16": ssm[2],
                          "B2_S50_DI200_float32": ssm[3],
                          "long_prompt_bfloat16": ssm[4],
                          "long_prompt_float32": ssm[5],
                          "falcon_mamba_prefill_bfloat16": ssm[6],
                          "falcon_mamba_prefill_float32": ssm[7]},
                      "flash_decode": {
                          "served_q_bf16_cache_f32": fd[0],
                          "served_q_f32_cache_f32": fd[1],
                          "served_q_bf16_cache_bf16": fd[2],
                          "ring1024_B2_q_bf16_cache_f32": fd[3],
                          "starcoder2_G9_hd128_ring4096": fd[7],
                          "stablelm_served_G1_hd64": fd[8],
                          "starcoder2_served_G9_hd128": fd[9],
                          "granite_served_G3_hd64": fd[10],
                          "qwen3_served_G8_hd64": fd[11],
                          "internlm2_served_G6_hd128": fd[12],
                          "internvl2_served_G2_hd128_336_slots": fd[13],
                          "whisper_served_G1_hd64": fd[14],
                          "qwen2_served_G8_hd128": fd[15],
                          "qwen2_lse_4x1024_q_bf16_cache_f32": fd_lse[0],
                          "qwen2_lse_4x1024_q_f32_cache_f32": fd_lse[1]},
                      "flash_attention_bwd": attn_bwd_cases,
                      "rmsnorm_bwd": rms_bwd_cases,
                      "ssm_scan_bwd": ssm_bwd_cases}}


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


def load_example(name: str):
    """A module of the repo's ``examples/`` directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bge_fp32(dev):
    """(bge-large-zh-v1.5 at its published width on the card, or its smoke
    config on the CPU; seeded random weights)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import embedder

    cfg = get_config("bge-large-zh-v1.5")
    if dev.type != "cuda":
        cfg = cfg.smoke()
    return cfg, embedder.init_embedder(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def direct_forward(be, cfg, tokens) -> "np.ndarray":
    """One query's vector from a forward of its tokens alone (B 1, no
    padding), with the backend's weights and compute dtype."""
    import torch

    from repro_torch.models import embedder

    toks = torch.as_tensor(tokens[None], dtype=torch.int32).to(be.device)
    mask = torch.ones(toks.shape, dtype=torch.float32, device=be.device)
    with torch.inference_mode():
        return embedder.embed(be.params, cfg, toks, mask,
                              compute_dtype=be.compute_dtype,
                              act_quant=be.act_quant)[0].cpu().numpy()


def phase_offload(args, dev) -> dict:
    """The paper's Table-1 A/B (``examples/torch_serve_offload.py``'s two
    engines): a burst through a modeled NPU alone, then through the modeled
    NPU with the card's embedder beside it as the offload tier."""
    import numpy as np
    import torch

    from repro_torch.core.cost_model import peak_saving, throughput_uplift
    from repro_torch.core.routing import CPU, NPU
    from repro_torch.core.sharded_backend import ShardedEmbedderBackend
    from repro_torch.kernels import launch_counts, reset_launch_counts

    ex = load_example("torch_serve_offload")
    cfg, params = bge_fp32(dev)
    reset_launch_counts()                 # the offload path starts here
    real = ShardedEmbedderBackend(cfg, params, max_tokens=32, dtype="fp32",
                                  device=dev)
    base, wall_b, c_base, _, _ = ex.run_engine(
        False, OFFLOAD_QUERIES, cfg, real, OFFLOAD_SLO)
    wind, wall_w, c_wind, queries, outs = ex.run_engine(
        True, OFFLOAD_QUERIES, cfg, real, OFFLOAD_SLO)
    counts = launch_counts()              # ... and ends here
    served = {i: v for i, v in enumerate(outs) if v is not None}
    real_rows = [i for i, v in served.items() if np.abs(v).max() > 0]
    errs = [float(np.abs(served[i] - direct_forward(real, cfg, queries[i]))
                  .max()) for i in real_rows]
    norms = [float(np.linalg.norm(served[i])) for i in real_rows]
    extra = c_wind - c_base
    out = {"model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "dtype": "fp32", "queries": len(queries),
           "slo_s": OFFLOAD_SLO, "real_tier": real.name,
           "baseline": {"C": c_base, "accepted": base.accepted,
                        "rejected": base.rejected, "wall_s": wall_b,
                        "per_device": dict(base.per_device)},
           "offload": {"C": c_wind, "accepted": wind.accepted,
                       "rejected": wind.rejected, "wall_s": wall_w,
                       "per_device": dict(wind.per_device)},
           "uplift": throughput_uplift(c_base, extra),
           "peak_saving": peak_saving(c_base, extra),
           "real_vectors": len(real_rows),
           "max_abs_err_vs_direct_forward": max(errs, default=None),
           "max_norm_err": max((abs(n - 1.0) for n in norms), default=None),
           "traces": real.traces, "launches": counts}
    print(f"[offload] baseline C={c_base} accepted={base.accepted} "
          f"rejected={base.rejected}; offload C={c_wind} accepted="
          f"{wind.accepted} rejected={wind.rejected} per-device="
          f"{dict(wind.per_device)}; concurrency +{out['uplift'] * 100:.1f}%"
          f", peak-provisioned cost saving {out['peak_saving'] * 100:.1f}%",
          flush=True)
    n_real = wind.per_device.get(CPU, 0)
    require(n_real >= 1, "the card's tier served no query")
    require(wind.accepted > base.accepted,
            f"offload accepted {wind.accepted}, baseline {base.accepted}")
    require(len(real_rows) == n_real and
            len(served) - len(real_rows) == wind.per_device.get(NPU, 0),
            "the non-zero vectors are not the card tier's")
    require(max(errs) <= 1e-5, f"offload vectors vs a direct forward: "
                               f"{max(errs)} > 1e-5")
    require(out["max_norm_err"] <= 1e-3, "offload vectors are not unit")
    if dev.type == "cuda":
        require(all(counts[k] > 0 for k in ("flash_attention", "pool_norm")),
                f"a kernel was not launched on the offload path: {counts}")
    del real, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def chaos_serve(engine, payloads, hook=None):
    """CHAOS_WAVES waves of CHAOS_WAVE queries through ``engine``, each
    wave submitted under a pinned GIL switch interval (so it reaches the
    queue before the worker runs) and waited for.  Returns the vectors."""
    import numpy as np

    if hook is not None:
        engine.add_batch_hook(hook)
    vecs = []
    for w in range(CHAOS_WAVES):
        wave = payloads[w * CHAOS_WAVE:(w + 1) * CHAOS_WAVE]
        old = sys.getswitchinterval()
        sys.setswitchinterval(5.0)
        try:
            futs = [engine.submit(payload=p, length=len(p)) for p in wave]
        finally:
            sys.setswitchinterval(old)
        require(all(f is not None for f in futs), "a query was refused")
        vecs += [f.result(timeout=300) for f in futs]
    return np.stack(vecs)


def phase_chaos(args, dev) -> dict:
    """The card's embedder behind a FaultyBackend, in an engine with one
    real tier and a retry policy: the plan fails one batch and corrupts
    another (by their ordinal in the tier's execution order); the answers
    are held against a fault-free run of the same queries."""
    import numpy as np
    import torch

    from repro_torch.core.faults import FaultPlan, FaultyBackend
    from repro_torch.core.routing import RetryPolicy, TierSpec
    from repro_torch.core.sharded_backend import ShardedEmbedderBackend
    from repro_torch.core.windve import WindVE
    from repro_torch.data.workload import make_queries
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg, params = bge_fp32(dev)
    n = CHAOS_WAVES * CHAOS_WAVE
    payloads = make_queries(n, cfg.vocab_size, 24, seed=17)
    index = {id(p): i for i, p in enumerate(payloads)}
    plan = FaultPlan(fail=CHAOS_FAIL, corrupt=CHAOS_CORRUPT)
    batches = []                   # the tier's completed batches, in order

    def engine(backend):
        return WindVE(tiers=[TierSpec("REAL", 2 * CHAOS_WAVE, backend=backend,
                                      max_batch=CHAOS_WAVE)],
                      retry=RetryPolicy(max_retries=2, backoff_s=0.0))

    reset_launch_counts()                 # the chaos path starts here
    real = ShardedEmbedderBackend(cfg, params, max_tokens=32, dtype="fp32",
                                  device=dev)
    fb = FaultyBackend(real, plan=plan)
    ve = engine(fb)
    try:
        got = chaos_serve(ve, payloads, lambda tier, batch, _: batches.append(
            [index[id(q.payload)] for q in batch]))
        stats = ve.stats
    finally:
        ve.shutdown()
    counts = launch_counts()              # ... and ends here
    ve = engine(real)                     # the same queries, no faults
    try:
        clean = chaos_serve(ve, payloads)
    finally:
        ve.shutdown()
    # completed batches are the executions that did not fail, in order
    ordinals = [o for o in range(fb.executions) if o not in plan.fail]
    corrupted = sorted(i for b, o in zip(batches, ordinals)
                       if o in plan.corrupt for i in b)
    diff = np.abs(got - clean).max(-1)
    flipped = np.abs(got - (1.0 - clean)).max(-1)
    others = [i for i in range(n) if i not in corrupted]
    out = {"model": cfg.name, "layers": cfg.num_layers, "dtype": "fp32",
           "queries": n, "waves": CHAOS_WAVES,
           "plan": {"fail": sorted(plan.fail),
                    "corrupt": sorted(plan.corrupt)},
           "executions": fb.executions,
           "injected_failures": fb.injected_failures,
           "injected_corruptions": fb.injected_corruptions,
           "retries": dict(stats.retries),
           "backend_errors": dict(stats.backend_errors),
           "failed": stats.failed, "batches": [len(b) for b in batches],
           "corrupted_queries": corrupted,
           "max_abs_err_others": float(diff[others].max()),
           "max_abs_err_corrupted_vs_1_minus_clean":
               float(flipped[corrupted].max()) if corrupted else None,
           "min_diff_corrupted": (float(diff[corrupted].min()) if corrupted
                                  else None),
           "inner_traces": fb.inner.traces, "inner_name": fb.inner.name,
           "async_dispatch": fb.async_dispatch, "launches": counts}
    require(fb.injected_failures == len(plan.fail)
            and fb.injected_corruptions == len(plan.corrupt),
            f"injected {fb.injected_failures} failures and "
            f"{fb.injected_corruptions} corruptions, planned {plan}")
    # each wave is one batch (the failed one's retry too), so the retries
    # are the failed wave's queries, once each
    require([len(b) for b in batches] == [CHAOS_WAVE] * CHAOS_WAVES,
            f"batches of {[len(b) for b in batches]}, not one a wave")
    require(stats.retries == {"REAL": CHAOS_WAVE * len(plan.fail)},
            f"retries {dict(stats.retries)}, want {CHAOS_WAVE} a failed "
            f"batch")
    require(stats.failed == 0 and stats.per_device == {"REAL": n},
            f"terminal failures {stats.failed}, served {stats.per_device}")
    require(corrupted and out["min_diff_corrupted"] > 0.1
            and out["max_abs_err_corrupted_vs_1_minus_clean"] <= 1e-5,
            "the corrupted batch's vectors are not the plan's corruption")
    require(out["max_abs_err_others"] <= 1e-5,
            f"an uncorrupted vector differs from the fault-free run by "
            f"{out['max_abs_err_others']}")
    if dev.type == "cuda":
        require(all(counts[k] > 0 for k in ("flash_attention", "pool_norm")),
                f"a kernel was not launched on the chaos path: {counts}")
    del real, fb, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


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


@contextlib.contextmanager
def moe_spy(routes=None, keeps=None):
    """Inside: every MoE block appends its routes (the sorted expert ids
    of each token) to ``routes`` and its keep mask to ``keeps``."""
    from repro_torch.models import layers as L

    route, slots = L.moe_route, L.moe_slots

    def route_spy(*a):
        r = route(*a)
        if routes is not None:
            routes.append(r[2].sort(-1).values)
        return r

    def slots_spy(*a):
        r = slots(*a)
        if keeps is not None:
            keeps.append(r[1])
        return r

    L.moe_route, L.moe_slots = route_spy, slots_spy
    try:
        yield
    finally:
        L.moe_route, L.moe_slots = route, slots


def kernel_vs_plain(backend, toks, forced, tag: str) -> dict:
    """Cosine of each teacher-forced step's logits through the kernels
    against the plain versions; for an MoE model also [routes that differ
    between the two runs, routes] (a route: one token's top-K experts in
    one layer)."""
    import torch

    kr, pr = [], []
    with torch.inference_mode():
        with moe_spy(routes=kr):
            _, kern = backend.generate(toks, forced=forced)
        with plain_kernels(), moe_spy(routes=pr):
            _, plain = backend.generate(toks, forced=forced)
    out = {f"{tag}kernel_vs_plain_min_cosine": [
        min_cosine(a, b) for a, b in zip(kern, plain)]}
    if backend.cfg.is_moe:
        out[f"{tag}kernel_vs_plain_flipped_routes"] = [
            sum(int((a != b).any(-1).sum().item()) for a, b in zip(kr, pr)),
            sum(a[..., 0].numel() for a in kr)]
    return out


def dropped_share(keeps: list) -> float:
    return (sum(int((~k).sum().item()) for k in keeps)
            / sum(k.numel() for k in keeps))


def moe_checks(out: dict, held: list, fp32, toks, forced) -> list:
    """An MoE model's checks; returns the keys to hold.

    A 1040-token prefill and a 16-token decode step drop different
    assignments past capacity, so decode-vs-prefill at the published
    capacity factor says nothing of the cache: it is held at capacity
    factor E / K, where an expert's queue holds every token and nothing
    drops, on the same weights, and reported at the published factor with
    the share of assignments dropped at prefill and at decode.  Under
    ``moe_row_dispatch`` the fp32 kernel-vs-plain logits are held too.
    The bf16 kernel-vs-plain bar is held where it is met; where it is not,
    the figure is reported with the routes that flipped: an upstream
    rounding difference moves a router logit by a bf16 step, which flips
    a top-K choice whose margin is under that step."""
    import torch

    from repro_torch import perf_flags
    from repro_torch.core.llm_backend import LMGenerateBackend

    cfg = fp32.cfg
    E, K = cfg.num_experts, cfg.experts_per_token
    out["decode_vs_prefill_capacity_factor"] = E / K
    out[f"decode_vs_prefill_at_{cfg.capacity_factor}_min_cosine"] = \
        out["decode_vs_prefill_min_cosine"]
    nodrop = LMGenerateBackend(cfg.replace(capacity_factor=E / K),
                               fp32.params, max_prompt=fp32.max_prompt,
                               max_new_tokens=fp32.max_new,
                               device=fp32.device,
                               compute_dtype=torch.float32)
    out["decode_vs_prefill_min_cosine"] = decode_vs_prefill(nodrop, toks,
                                                            forced)
    keeps = []
    with torch.inference_mode(), moe_spy(keeps=keeps):
        fp32.generate(toks, forced=forced)
    L = cfg.num_layers
    B, S = toks.shape
    out["capacity"] = {step: math.ceil(n * K / E * cfg.capacity_factor)
                       for step, n in (("prefill", B * S), ("decode", B))}
    out["dropped_share_prefill"] = dropped_share(keeps[:L])
    out["dropped_share_decode"] = dropped_share(keeps[L:])
    if cfg.name.startswith("granite-moe-3b-a800m"):
        perf_flags.set_flags(moe_row_dispatch=True)
        try:
            row = kernel_vs_plain(fp32, toks, forced, "row_dispatch_fp32_")
        finally:
            perf_flags.reset_flags()
        out.update(row)
        held = held + ["row_dispatch_fp32_kernel_vs_plain_min_cosine"]
    if "kernel_vs_plain_min_cosine" in held and \
            min(out["kernel_vs_plain_min_cosine"]) < COSINE_BAR:
        held = [k for k in held if k != "kernel_vs_plain_min_cosine"]
        out["bf16_kernel_vs_plain_reported_because"] = (
            f"{out['kernel_vs_plain_flipped_routes'][0]} of "
            f"{out['kernel_vs_plain_flipped_routes'][1]} routes flipped: a "
            f"router logit moved by a bf16 rounding upstream crosses a "
            f"top-{K} margin under one bf16 step")
    return held


def patch_prefill(be, toks) -> dict:
    """internvl2-2b's prefill with 256 stub patch embeddings, N(0, 0.02^2)
    as the token embeddings are, before the 64-token prompts: kernels
    against plain versions, in bf16 and fp32 compute."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.models import lm

    cfg = be.cfg
    x = torch.as_tensor(toks).to(be.device)
    rng = np.random.default_rng(14)
    patches = torch.from_numpy(0.02 * rng.standard_normal(
        (x.shape[0], cfg.num_patches, cfg.d_model)).astype(np.float32)
        ).to(be.device)
    out = {"patch_prefill": [x.shape[0], cfg.num_patches, x.shape[1]]}
    for tag, cdt in (("", torch.bfloat16), ("fp32_", torch.float32)):
        with torch.inference_mode():
            before = launch_counts()["flash_attention"]
            kern, cache = lm.prefill(be.params, cfg, x, patches,
                                     cache_dtype=torch.float32,
                                     compute_dtype=cdt)
            launched = launch_counts()["flash_attention"] - before
            with plain_kernels():
                plain, _ = lm.prefill(be.params, cfg, x, patches,
                                      cache_dtype=torch.float32,
                                      compute_dtype=cdt)
        require(cache["pos"] == x.shape[1] + cfg.num_patches
                and bool(torch.isfinite(kern).all().item()),
                "patch prefill: wrong position or non-finite logits")
        out[f"{tag}patch_prefill_kernel_vs_plain_min_cosine"] = [
            min_cosine(kern, plain)]
        out[f"{tag}patch_prefill_attention_launches"] = launched
    return out


def generate_one(dev, arch: str) -> tuple:
    """One decoder's token generation through launch/serve_llm's engine at
    its published width (its smoke config on the CPU), then its checks off
    the counted path.  Returns (summary, launches on its served path)."""
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
    bsz = GEN_B.get(arch, LM_B)
    n, prompt, new = 2 * bsz, LM_PROMPT, LM_NEW
    reset_launch_counts()                 # this model's path starts here
    t0 = time.monotonic()
    wdt = torch.bfloat16 if arch in BF16_WEIGHTS else torch.float32
    engine, cfg, _ = build_engine(arch, smoke=not cuda, device=dev,
                                  new_tokens=new, weights_dtype=wdt,
                                  layers=DEPTH_CUTS.get(arch) if cuda
                                  else None)
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
               "batch": bsz, "d_model": cfg.d_model,
               "params_bytes": be.params_nbytes,
               "weights_dtype": dtype_name(wdt), "build_engine_s": build_s,
               "serve_s": serve_s,
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
            f"{arch}: continuations of shape {gen.shape}, not ({n}, {new}) "
            f"ids in [0, {cfg.vocab_size})")
    if cuda:
        for name in LM_KERNELS[arch]:
            require(counts[name] > 0, f"{name} was not launched on "
                                      f"{arch}'s path: {counts}")

    # off the counted path: one batch of the same prompts, teacher-forced
    # on the served tokens, through the kernels and the plain versions, in
    # bf16 (the served compute) and in fp32 compute (TF32 off); an MoE
    # model's routes of the two runs are compared as well
    toks = be.prompt_tokens([Query(qid=i, payload=q, length=prompt)
                             for i, q in enumerate(queries[:bsz])])
    forced = gen[:bsz, :-1].T
    torch.backends.cuda.matmul.allow_tf32 = False
    fp32 = LMGenerateBackend(cfg, be.params, max_prompt=prompt,
                             max_new_tokens=new, device=dev,
                             compute_dtype=torch.float32)
    for tag, backend in (("", be), ("fp32_", fp32)):
        out.update(kernel_vs_plain(backend, toks, forced, tag))
    # decode against a fresh prefill of the longer prompt, with 64-token
    # prompts and (hymba, starcoder2) a prompt longer than the window (the
    # ring wraps in prefill).  Held in fp32 compute, where the two agree to
    # rounding; in bf16 the two orders of rounding drift apart through
    # many layers of random weights, so the bf16 figure is reported, not
    # held.  The same drift rules out falcon-mamba's bf16 kernel-vs-plain
    # bar (BF16_DRIFTS): its fp32 figure is held instead.
    held = ["fp32_kernel_vs_plain_min_cosine", "decode_vs_prefill_min_cosine"]
    if arch not in BF16_DRIFTS:
        held.append("kernel_vs_plain_min_cosine")
    for tag, backend in (("", fp32), ("bf16_", be)):
        out[f"{tag}decode_vs_prefill_min_cosine"] = decode_vs_prefill(
            backend, toks, forced)
    if cfg.is_moe:
        held = moe_checks(out, held, fp32, toks, forced)
    if cfg.frontend == "vision":
        out.update(patch_prefill(be, toks))
        held += ["patch_prefill_kernel_vs_plain_min_cosine",
                 "fp32_patch_prefill_kernel_vs_plain_min_cosine"]
    if arch in LONG_PROMPTS:
        b, length, long_new = LONG_PROMPTS[arch]
        length = length if cuda else 40
        long_toks = np.stack(make_queries(b, cfg.vocab_size, length,
                                          seed=12))
        long_forced = np.stack(make_queries(b, cfg.vocab_size, long_new - 1,
                                            seed=13)).T
        out["long_prompt"] = [b, length]
        for tag, cdt in (("", torch.float32), ("bf16_", None)):
            lb = LMGenerateBackend(cfg, be.params, max_prompt=prompt,
                                   max_new_tokens=long_new, device=dev,
                                   compute_dtype=cdt)
            out[f"{tag}long_decode_vs_prefill_min_cosine"] = \
                decode_vs_prefill(lb, long_toks, long_forced)
        held.append("long_decode_vs_prefill_min_cosine")

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
    for key in held:
        require(min(out[key]) >= COSINE_BAR,
                f"{arch} {key}: {min(out[key])} < {COSINE_BAR}")
    summary = {key: min(out[key]) for key in out
               if key.endswith("_min_cosine")}
    summary["held"] = held
    summary["bf16_decode_vs_prefill_min_cosine"] = min(
        out["bf16_decode_vs_prefill_min_cosine"]
        + out.get("bf16_long_decode_vs_prefill_min_cosine", []))
    summary.update({k: out[k] for k in (
        "layers", "batch", "d_model", "params_bytes", "weights_dtype", "serve_s",
        "prefill_ms", "decode_ms_per_step", "kernel_vs_plain_flipped_routes",
        "fp32_kernel_vs_plain_flipped_routes", "dropped_share_prefill",
        "dropped_share_decode", "capacity",
        "bf16_kernel_vs_plain_reported_because") if k in out})
    return summary, counts


def phase_generate(args, dev) -> dict:
    """Token generation for hymba-1.5b, then stablelm-1.6b, starcoder2-7b,
    falcon-mamba-7b, internlm2-20b, granite-moe-3b-a800m,
    qwen3-moe-30b-a3b and internvl2-2b, each at its published width and
    alone on the card (its weights freed before the next is built).  The
    launch counts of the path are the sum of each model's served run."""
    import gc

    import torch

    models, by_model = {}, {}
    for arch in LM_ARCHS:
        models[arch], by_model[arch] = generate_one(dev, arch)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    counts = {k: sum(c[k] for c in by_model.values())
              for k in by_model[LM_ARCH]}
    return {"models": models, "launches": counts,
            "launches_by_model": by_model}


def param_bytes(tree) -> int:
    return sum(param_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def encdec_forced(params, cfg, toks, frames, forced, cdt):
    """Teacher-forced logits of whisper's path, (steps + 1, B, V): the
    prefill's, then each decode step's on ``forced`` (steps, B)."""
    import torch

    from repro_torch.models import encdec

    with torch.inference_mode():
        logits, cache = encdec.prefill(
            params, cfg, toks, frames, cache_dtype=torch.float32,
            max_len=toks.shape[1] + forced.shape[0] + 1, compute_dtype=cdt)
        out = [logits]
        for t in range(forced.shape[0]):
            logits, cache = encdec.decode_step(params, cfg, forced[t], cache,
                                               compute_dtype=cdt)
            out.append(logits)
    return torch.stack(out)


def phase_encdec(args, dev) -> dict:
    """whisper-tiny's serving path at its published width (its smoke config
    on the CPU) through steps/serve.py's builders: random fp32 weights and
    stub frames (16, 1500, 384) from one seeded generator, a prefill of 16
    prompts of 64 tokens, then 15 greedy decode steps (80 fp32 cache
    slots), bf16 compute.  Launch counts are zeroed just before the
    prefill and read just after the last step.  Then, off the counted
    path: teacher-forced logits through the kernels against the plain
    versions (fp32 compute held, bf16 held where met, else reported),
    each decode step against a fresh prefill of the longer prompt on the
    same frames (fp32 compute), the encoder's output through the kernels
    against the plain versions (max-abs, reported), and the host clock
    and a profiler trace of encode, prefill and a decode step."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.workload import make_queries
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import api, encdec
    from repro_torch.steps.serve import build_decode_step, build_prefill_step

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = get_config(ENC_ARCH)
    if not cuda:
        cfg = cfg.smoke()
    B, prompt, new = (LM_B, LM_PROMPT, LM_NEW) if cuda else (2, 24, 4)
    g = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(cfg, g, device=dev)
    frames = torch.randn((B, cfg.num_frames, cfg.d_model), generator=g,
                         device=dev)
    toks = torch.from_numpy(np.stack(make_queries(
        B, cfg.vocab_size, prompt, seed=11)).astype(np.int32)).to(dev)
    shape = ShapeConfig("whisper-serve", prompt + new, B, "decode")
    prefill = build_prefill_step(cfg, shape, cache_dtype=torch.float32,
                                 max_len=prompt + new)
    step = build_decode_step(cfg, shape)
    E, Ly, V = cfg.encoder_layers, cfg.num_layers, cfg.vocab_size
    reset_launch_counts()                 # the served path starts here
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": toks, "frames": frames})
        sync()
        t1 = time.perf_counter()
        gen = [logits.argmax(-1).to(torch.int32)]
        for _ in range(new - 1):
            tok, cache = step(params, cache, {"token": gen[-1]})
            gen.append(tok)
        sync()
        t2 = time.perf_counter()
    counts = launch_counts()              # ... and ends here
    gen = torch.stack(gen, 1)
    out = {"model": cfg.name, "encoder_layers": E, "decoder_layers": Ly,
           "d_model": cfg.d_model, "frames": cfg.num_frames, "batch": B,
           "prompt": prompt, "new_tokens": new,
           "params_bytes": param_bytes(params),
           "launches": counts, "served_prefill_ms": (t1 - t0) * 1e3,
           "served_decode_ms_per_step": (t2 - t1) * 1e3 / (new - 1)}
    require(tuple(gen.shape) == (B, new)
            and bool(((gen >= 0) & (gen < V)).all().item())
            and bool(torch.isfinite(logits).all().item())
            and cache["pos"] == prompt + new - 1,
            f"whisper: tokens {tuple(gen.shape)}, not ({B}, {new}) ids in "
            f"[0, {V}), non-finite logits or cache at {cache['pos']}")
    if cuda:
        want = {"flash_attention": E + 2 * Ly, "flash_decode": (new - 1) * Ly}
        require(all(counts[k] == n for k, n in want.items()),
                f"whisper's path launched {counts}, not {want}")

    # off the counted path, teacher-forced on the served tokens (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    forced = gen[:, :-1].T.contiguous()
    steps = {}
    for tag, cdt in (("fp32_", torch.float32), ("", torch.bfloat16)):
        steps[tag] = encdec_forced(params, cfg, toks, frames, forced, cdt)
        with plain_kernels():
            plain = encdec_forced(params, cfg, toks, frames, forced, cdt)
        require(bool(torch.isfinite(steps[tag]).all().item()),
                f"whisper {tag}logits not finite")
        out[f"{tag}kernel_vs_plain_min_cosine"] = [
            min_cosine(a, b) for a, b in zip(steps[tag], plain)]
    # decode against a fresh prefill of the longer prompt, same frames
    for tag, key, cdt in (("", "fp32_", torch.float32),
                          ("bf16_", "", torch.bfloat16)):
        cos = []
        with torch.inference_mode():
            for t in range(new - 1):
                longer = torch.cat([toks, forced[:t + 1].T], dim=1)
                want, _ = encdec.prefill(params, cfg, longer, frames,
                                         cache_dtype=torch.float32,
                                         compute_dtype=cdt)
                cos.append(min_cosine(steps[key][t + 1], want))
        out[f"{tag}decode_vs_prefill_min_cosine"] = cos
    # the encoder's states, kernels against plain versions
    for tag, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        with torch.inference_mode():
            enc = encdec.encode(params, cfg, frames, cdt)
            with plain_kernels():
                plain = encdec.encode(params, cfg, frames, cdt)
        require(bool(torch.isfinite(enc).all().item()),
                f"whisper {tag} encoder states not finite")
        out[f"encoder_kernel_vs_plain_max_abs_err_{tag}"] = (
            enc.float() - plain.float()).abs().max().item()
        out[f"encoder_max_abs_{tag}"] = enc.float().abs().max().item()
    held = ["fp32_kernel_vs_plain_min_cosine", "decode_vs_prefill_min_cosine",
            "kernel_vs_plain_min_cosine"]
    if min(out["kernel_vs_plain_min_cosine"]) < COSINE_BAR:
        held.remove("kernel_vs_plain_min_cosine")
        out["bf16_kernel_vs_plain_reported_because"] = (
            "bf16 rounding in another order through 4 + 4 random layers")
    out["held"] = held

    # host clock and device trace of encode, prefill and one decode step
    # (bf16 compute, the served one)
    trace_dir = os.path.join(ROOT, "build", "profile")
    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])

    def run_encode():
        with torch.inference_mode():
            return encdec.encode(params, cfg, frames)

    def run_prefill():
        with torch.inference_mode():
            return prefill(params, {"tokens": toks, "frames": frames})

    _, cache = run_prefill()
    tok = gen[:, 0]

    def run_decode():
        # the same position every call: the step's work stays the same
        with torch.inference_mode():
            return step(params, cache, {"token": tok})

    for name, fn in (("encode", run_encode), ("prefill", run_prefill),
                     ("decode_step", run_decode)):
        out[name] = profile_steps(fn, sync, acts, os.path.join(
            trace_dir, f"profile_whisper_{name}.json"))
    emit({"phase": "encdec", **out})
    for key in held:
        require(min(out[key]) >= COSINE_BAR,
                f"whisper {key}: {min(out[key])} < {COSINE_BAR}")
    summary = {key: min(out[key]) for key in out
               if key.endswith("_min_cosine")}
    summary.update({k: out[k] for k in out
                    if k.startswith(("encoder_kernel", "encoder_max")) or k in (
                        "held", "launches", "params_bytes",
                        "served_prefill_ms", "served_decode_ms_per_step",
                        "bf16_kernel_vs_plain_reported_because")})
    summary.update({f"{name}_{k}": out[name][k]
                    for name in ("encode", "prefill", "decode_step")
                    for k in ("wall_ms", "device_busy_ms", "idle_share",
                              "kernels_per_step")})
    return summary


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
    under each policy, and one prefill (B=16 x S=64) and decode step
    (B=16 against the 64-token prompt's cache) of each decoder."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import embedder
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

    for arch in LM_ARCHS:
        out[arch] = profile_lm(dev, arch, rng, sync, acts, trace)
    return out


def profile_lm(dev, arch, rng, sync, acts, trace) -> dict:
    """One prefill (B=16 x S=64) and one decode step (B=16 against the
    64-token prompt's cache) of ``arch`` at its published width, on the
    weights the generate phase serves it with."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(arch)
    if dev.type != "cuda":
        cfg = cfg.smoke()
    elif arch in DEPTH_CUTS:
        cfg = cfg.replace(num_layers=DEPTH_CUTS[arch])
    wdt = torch.bfloat16 if arch in BF16_WEIGHTS else torch.float32
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev, dtype=wdt)
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

    tag = arch.split("-")[0]
    out = {"B": LM_B, "S": LM_PROMPT, "cache_slots": LM_PROMPT + LM_NEW,
           "weights_dtype": dtype_name(wdt),
           "prefill": profile_steps(prefill, sync, acts,
                                    trace(f"{tag}_prefill")),
           "decode_step": profile_steps(decode, sync, acts,
                                        trace(f"{tag}_decode"))}
    del params, cache
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_devices(dev) -> list:
    """MESH_POSITIONS logical devices placed round-robin on the visible
    cards (on the CPU: the CPU each time)."""
    import torch

    if dev.type != "cuda":
        return [dev] * MESH_POSITIONS
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(MESH_POSITIONS)]


def mesh_fanout(dev, devices) -> tuple:
    """bge-large-zh-v1.5's embed tier fanned out over ``devices`` in fp32
    and bf16 against the one-device backend on the same queries.  Returns
    (summary, launches of the fanned-out runs)."""
    import numpy as np
    import torch

    from repro_torch.core.routing import Query
    from repro_torch.core.sharded_backend import ShardedEmbedderBackend
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg, params = bge_fp32(dev)
    rng = np.random.default_rng(21)
    # 24 queries of 8-96 tokens: chunks of 16 and 8 rows, 4 and 2 a device
    lengths = rng.integers(8, 97, 24)
    qs = [Query(qid=i, payload=rng.integers(1, cfg.vocab_size, n), length=n)
          for i, n in enumerate(lengths)]
    out, counts = {"model": cfg.name, "queries": len(qs)}, {}
    for dtype in ("fp32", "bf16"):
        one = ShardedEmbedderBackend(cfg, params, max_tokens=96, dtype=dtype,
                                     device=dev)
        want = np.stack(one.embed_batch(qs))
        del one
        fan = ShardedEmbedderBackend(cfg, params, max_tokens=96, dtype=dtype,
                                     devices=devices, async_dispatch=True)
        reset_launch_counts()                 # the fanned-out run ...
        got = np.stack(fan.embed_batch_async(qs)())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        after = launch_counts()               # ... ends here
        counts = {k: counts.get(k, 0) + after[k] for k in after}
        err = float(np.abs(got - want).max())
        cos = float((got * want).sum(-1).min())
        norm_err = float(np.abs(np.linalg.norm(got, axis=-1) - 1.0).max())
        out[dtype] = {"backend": fan.name, "device_count": fan.device_count,
                      "min_batch_bucket": fan.min_batch_bucket,
                      "max_abs_err_vs_one_device": err,
                      "min_cosine_vs_one_device": cos,
                      "max_norm_err": norm_err, "launches": after}
        require(got.shape == want.shape and np.isfinite(got).all()
                and norm_err <= 1e-3, f"fan-out {dtype}: bad vectors")
        # fp32: the same function on other row blocks, 1e-5 as the golden
        # bar on the card; bf16: a GEMM of other rows may take another
        # cuBLAS kernel, so the vectors are held at cosine 0.999
        require(err <= 1e-5 if dtype == "fp32" else cos >= 0.999,
                f"fan-out {dtype} vs one device: max abs {err}, cosine {cos}")
        del fan
    emit({"phase": "mesh", "fanout": out})
    return out, counts


def mesh_decode(dev, devices) -> tuple:
    """qwen2-72b at its published width (its depth cut, bf16-resident
    weights, fp32 compute and cache) through steps/serve.py's builders on a
    (1, 4) mesh with ``decode_shard_map``: each prompt's cache split over
    the 4 shards, 16 greedy decode steps, against the same steps on the
    whole cache.  Returns (summary, launches of the sharded runs)."""
    import gc

    import numpy as np
    import torch

    from repro_torch import perf_flags
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.workload import make_queries
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.steps import serve

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = get_config(MESH_ARCH)
    cfg = (cfg.replace(num_layers=DEPTH_CUTS[MESH_ARCH]) if cuda
           else cfg.smoke())
    # on the CPU: 80 slots, 4 shards of 20, prompts of 62 and 12 tokens
    slots, prompts = ((MESH_CACHE, MESH_PROMPTS) if cuda
                      else (80, (62, 12)))
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev, dtype=torch.bfloat16)
    mesh = Mesh(devices, (1, MESH_POSITIONS), ("data", "model"))
    shape = ShapeConfig("mesh", slots, MESH_B, "decode")
    kw = dict(cache_dtype=torch.float32, max_len=slots,
              compute_dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "B": MESH_B, "cache_slots": slots, "shards": MESH_POSITIONS,
           "mesh": mesh.shape, "weights_dtype": "bfloat16",
           "compute_dtype": "float32", "cases": []}
    counts = {}
    for i, prompt in enumerate(prompts):
        toks = torch.from_numpy(np.stack(make_queries(
            MESH_B, cfg.vocab_size, prompt, seed=30 + i))).to(dev)
        runs = {}
        for sharded in (False, True):
            perf_flags.set_flags(decode_shard_map=sharded)
            try:
                if sharded:
                    reset_launch_counts()     # the sharded run ...
                with torch.inference_mode():
                    logits, cache = serve.build_prefill_step(
                        cfg, shape, mesh, **kw)(params, {"tokens": toks})
                    step = serve.build_decode_step(
                        cfg, shape, mesh, compute_dtype=torch.float32)
                    tok, fed = logits.argmax(-1).to(torch.int32), []
                    sync()
                    t0 = time.perf_counter()
                    for _ in range(MESH_NEW):
                        tok, cache = step(params, cache, {"token": tok})
                        fed.append(tok)
                    sync()
                    step_ms = (time.perf_counter() - t0) * 1e3 / MESH_NEW
                if sharded:
                    after = launch_counts()   # ... ends here
                    counts = {k: counts.get(k, 0) + after[k] for k in after}
                    shards = cache["kpos"].along(0)
                    valid = [int((kp >= 0).sum().item()) for kp in shards]
                    cache = lm.unshard_cache(cache)
            finally:
                perf_flags.reset_flags()
            runs[sharded] = (torch.stack(fed).cpu(), cache, step_ms)
        (want, whole, whole_ms), (got, shd, shd_ms) = runs[False], runs[True]
        case = {"prompt": prompt, "valid_slots_per_shard": valid,
                "owner_shard": (prompt % slots) // (slots // MESH_POSITIONS),
                "tokens_equal": bool(torch.equal(got, want)),
                "kpos_equal": bool(torch.equal(shd["kpos"], whole["kpos"])),
                "whole_decode_ms_per_step": whole_ms,
                "sharded_decode_ms_per_step": shd_ms}
        for key in ("k", "v"):
            err, mag = _rel_err(shd[key], whole[key])
            case[f"{key}_max_abs_err"], case[f"{key}_max_abs"] = err, mag
            case[f"{key}_within_1e-6"] = err <= 1e-6 * mag
        out["cases"].append(case)
        emit({"phase": "mesh", "decode_case": case})
        require(case["tokens_equal"] and case["kpos_equal"]
                and case["k_within_1e-6"] and case["v_within_1e-6"],
                f"sharded decode after a {prompt}-token prompt differs from "
                f"the whole cache's: {case}")
        del runs, whole, shd
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out, counts


def phase_mesh(args, dev) -> dict:
    """The mesh layer: 4 logical devices placed round-robin on the visible
    cards; (a) bge's embed tier fanned out over them against one device,
    (b) qwen2-72b's decode on a cache whose sequence is split over them
    against the whole cache.  The launches of the path are those of the
    fanned-out and sharded runs."""
    devices = mesh_devices(dev)
    emit({"phase": "mesh", "placement": [str(d) for d in devices]})
    fan, fan_counts = mesh_fanout(dev, devices)
    dec, dec_counts = mesh_decode(dev, devices)
    counts = {k: fan_counts[k] + dec_counts[k] for k in fan_counts}
    if dev.type == "cuda":
        for name in ("flash_attention", "pool_norm", "rmsnorm",
                     "flash_decode"):
            require(counts[name] > 0, f"{name} was not launched on the mesh "
                                      f"path: {counts}")
        # one flash_decode launch a shard, a layer, a step
        want = (len(MESH_PROMPTS) * MESH_NEW * dec["layers"]
                * MESH_POSITIONS)
        require(dec_counts["flash_decode"] == want,
                f"flash_decode launches {dec_counts['flash_decode']}, want "
                f"{want}")
    return {"placement": [str(d) for d in devices], "fanout": fan,
            "decode": dec, "launches": counts}


def leaf_cosines(a, b) -> dict:
    """{leaf path: cosine} of two gradient trees, each leaf flattened and
    taken in float64."""
    from repro_torch.steps.checkpoint import _flatten

    out = {}
    for (key, x), (_, y) in zip(_flatten(a), _flatten(b)):
        x, y = x.double().flatten(), y.double().flatten()
        den = (x.norm() * y.norm()).item()
        out[key] = (x @ y).item() / den if den > 0 else (
            1.0 if x.abs().max().item() == y.abs().max().item() == 0 else 0.0)
    return out


def train_resume(dev) -> dict:
    """launch/train.py at the smoke config on the card: 6 straight steps
    against 3 steps, a checkpoint, and 3 steps resumed from it."""
    import tempfile

    from repro_torch.launch.train import train
    from repro_torch.steps import optim

    kw = dict(batch=2, seq=32, smoke=True, seed=3, log_every=100,
              device=str(dev))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        ck = os.path.join(d, "ck.npz")
        p_full, _, l_full = train(TRAIN_ARCH, steps=6, **kw)
        train(TRAIN_ARCH, steps=3, ckpt=ck, **kw)
        ck_bytes = os.path.getsize(ck)
        p_res, o_res, l_res = train(TRAIN_ARCH, steps=3, resume=ck, **kw)
    loss_err = max(abs(a - b) for a, b in zip(l_full[3:], l_res))
    param_err = max((a - b).abs().max().item() for a, b in
                    zip(optim.tree_leaves(p_full), optim.tree_leaves(p_res)))
    return {"losses_straight": l_full[3:], "losses_resumed": l_res,
            "max_loss_diff": loss_err, "max_param_diff": param_err,
            "checkpoint_bytes": ck_bytes, "step": int(o_res["step"]),
            "ok": loss_err <= 1e-5 and param_err <= 1e-6
            and int(o_res["step"]) == 6}


def train_counts(cfg) -> dict:
    """Kernel launches one remat'd train step of ``cfg`` makes: each
    layer's attention, norms and scan forward twice (the forward, then its
    recompute in the backward) and backward once, and the final norm once
    each way."""
    L = cfg.num_layers
    want = {"rmsnorm": 2 * 2 * L + 1, "rmsnorm_bwd": 2 * L + 1}
    if cfg.has_attention:
        want.update(flash_attention=2 * L, flash_attention_bwd=L)
    if cfg.has_ssm:
        want.update(ssm_scan=2 * L, ssm_scan_bwd=L)
    return want


def train_arch(dev, arch: str) -> dict:
    """``arch`` at its published width and depth (fp32 weights and AdamW
    state), B 8 x S 512: (a) one step's loss and gradients through the
    kernels against the plain versions in fp32 compute; (b) TRAIN_STEPS
    steps in bf16 compute at lr 3e-4 on the zipf TokenStream, launch counts
    zeroed just before and read just after, the loss falling, step time by
    CUDA events, peak memory, then one traced step."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.workload import TokenStream, TrainBatchSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import api
    from repro_torch.steps import optim
    from repro_torch.steps.train import (build_loss_fn, build_train_step,
                                         value_and_grad)

    cuda = dev.type == "cuda"
    cfg = get_config(arch)
    B, S = TRAIN_B, TRAIN_S
    if not cuda:
        cfg, B, S = cfg.smoke(), 2, 32
    shape = ShapeConfig("train", S, B, "train")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    params = api.init_params(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    n_params = sum(p.numel() for p in optim.tree_leaves(params))
    stream = TokenStream(TrainBatchSpec(B, S, cfg.vocab_size), seed=0)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "params": n_params, "B": B, "S": S}

    # (a) kernels against plain versions, fp32 compute, before the optimizer
    batch = next(stream)
    loss32 = build_loss_fn(cfg, shape, compute_dtype=torch.float32)
    (lk, _), gk = value_and_grad(loss32, params, batch)
    with plain_kernels():
        (lp, _), gp = value_and_grad(loss32, params, batch)
    cos = leaf_cosines(gk, gp)
    worst = min(cos, key=cos.get)
    rel = abs(lk.item() - lp.item()) / abs(lp.item())
    out["fp32_kernels_vs_plain"] = {
        "loss_kernels": lk.item(), "loss_plain": lp.item(), "loss_rel": rel,
        "min_grad_cosine": cos[worst], "min_grad_cosine_leaf": worst,
        "leaves": len(cos)}
    require(rel <= TRAIN_LOSS_REL, f"fp32 loss kernels vs plain {rel}")
    require(cos[worst] >= TRAIN_GRAD_COSINE,
            f"gradient {worst}: cosine {cos[worst]} kernels vs plain")
    del gk, gp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # (b) the main path: bf16 compute, AdamW, counted
    opt = optim.init(params)
    step = build_train_step(cfg, shape,
                            opt_cfg=optim.AdamWConfig(lr=TRAIN_LR))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, times, enqueue = [], [], []
    sync()
    reset_launch_counts()                 # the train path starts here
    for _ in range(TRAIN_STEPS):
        b = next(stream)
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        else:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    sync()
    counts = launch_counts()              # ... and ends here
    out["launches"] = {k: v for k, v in counts.items() if v}
    want = train_counts(cfg)
    out["launches_per_step_want"] = want
    if cuda:
        for name, n in counts.items():
            require(n == want.get(name, 0) * TRAIN_STEPS,
                    f"{name}: {n} launches, want "
                    f"{want.get(name, 0) * TRAIN_STEPS}")
    first, last = (statistics.mean(losses[:5]), statistics.mean(losses[-5:]))
    steady = statistics.median(times[2:])
    tokens = B * S
    # 6 N D with N the active params (all of them for a dense model)
    mflops = roofline.model_flops(cfg, shape, params)
    out.update({
        "losses": losses, "first5_mean_loss": first, "last5_mean_loss": last,
        "finite": all(math.isfinite(x) for x in losses),
        "step_ms": times, "step_ms_median": steady,
        # host time to enqueue a step: above the step time, the host sets it
        "enqueue_ms_median": statistics.median(enqueue[2:]),
        "tokens_per_s": tokens / (steady / 1e3),
        "model_flops": mflops,
        "share_of_bf16_peak": (mflops
                               / (steady / 1e3 * PEAK_FLOPS["bfloat16"])),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if cuda else None),
        "grad_norm_last": float(m["grad_norm"])})
    require(out["finite"], "a non-finite loss")
    require(last < first, f"loss did not fall: first-5 mean {first}, "
                          f"last-5 mean {last}")
    # one traced step: the device operations that took most time
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    b = next(stream)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if cuda:
        # device busy: the kernels' durations in the trace, over the wall
        path = os.path.join(ROOT, "build", "profile", f"train_step_{arch}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        with open(path) as f:
            kernels = [e for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
        by_name: dict = {}
        for e in kernels:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        busy_ms = sum(by_name.values()) / 1e3
        out["traced_step"] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "kernels": len(kernels),
            "top_kernels": [{"name": n[:80], "ms": d / 1e3}
                            for n, d in sorted(by_name.items(),
                                               key=lambda kv: -kv[1])[:6]]}
    rows = prof.key_averages()
    # self time: the device work an entry ran itself, not its callees'
    attr = ("self_device_time_total"
            if hasattr(rows[0], "self_device_time_total")
            else "self_cuda_time_total")
    top = sorted(rows, key=lambda r: -getattr(r, attr))[:5]
    out["top_device_ops"] = [{"name": r.key[:80],
                              "ms": getattr(r, attr) / 1e3,
                              "calls": r.count} for r in top]
    return out


def phase_train(args, dev) -> dict:
    """Each of TRAIN_ARCHS through ``train_arch``, one at a time (each
    one's params, AdamW state and step freed before the next), then (c)
    launch/train.py's checkpoint resume at the smoke config.  The train
    path's launches are the sum of the archs' counted runs."""
    import gc

    import torch

    out = {"card": card_line()}
    launches: dict = {}
    failed = []
    for arch in TRAIN_ARCHS:
        try:
            res = train_arch(dev, arch)
        except PhaseFailed as e:          # report it, run the next arch
            res = {"error": str(e)}
            failed.append(f"{arch}: {e}")
        out[arch] = res
        for name, n in res.get("launches", {}).items():
            launches[name] = launches.get(name, 0) + n
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["launches"] = launches
    require(not failed, "; ".join(failed))

    # (c) checkpoint round trip through launch/train.py, smoke config
    out["resume"] = train_resume(dev)
    require(out["resume"]["ok"], f"resume differs: {out['resume']}")
    return out


# ----------------------------------------------------------------------------
# the dry run against the card
# ----------------------------------------------------------------------------

def dryrun_step(name: str, dev, cuda: bool) -> tuple:
    """(step, its arguments, model flops) of one of DRYRUN_STEPS on
    ``dev``: meta tensors (the dry run), or, on the card, random weights
    and inputs from seeded generators (a decode step after its prompt's
    prefill).  The card's sizes when ``cuda``, else smoke ones (the CPU
    rehearsal)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api, embedder, lm, quantize
    from repro_torch.steps import inputs, optim
    from repro_torch.steps.serve import build_decode_step, build_prefill_step
    from repro_torch.steps.train import build_train_step

    meta = dev.type == "meta"

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    def params(cfg):
        return (api.param_shapes(cfg) if meta
                else api.init_params(cfg, gen(0), device=dev))

    def batch(cfg, shape):
        return (inputs.input_specs(cfg, shape) if meta
                else inputs.make_batch(cfg, shape, gen(1)))

    arch, B, S = DRYRUN_STEPS[name]
    cfg = get_config(arch)
    if not cuda:
        cfg, B, S = cfg.smoke(), 2, 24
    if name == "stablelm_train":
        shape = ShapeConfig("train", S, B, "train")
        p = params(cfg)
        step = build_train_step(cfg, shape,
                                opt_cfg=optim.AdamWConfig(lr=TRAIN_LR))
        args = (p, optim.init(p), batch(cfg, shape))
    elif name == "hymba_decode":
        # the generate phase's first decode step: B prompts of S tokens in
        # an S + LM_NEW-slot fp32 cache, bf16 compute, fp32 weights
        Sc = S + LM_NEW
        shape = ShapeConfig("decode", Sc, B, "decode")
        p = params(cfg)
        if meta:
            cache = lm.init_cache(cfg, B, Sc, torch.float32, "meta")
            cache["pos"] = S
        else:
            prompt = ShapeConfig("prefill", S, B, "prefill")
            cache = build_prefill_step(cfg, prompt, cache_dtype=torch.float32,
                                       max_len=Sc)(p, batch(cfg, prompt))[1]
        step = build_decode_step(cfg, shape)
        args = (p, cache, batch(cfg, shape))
    else:                                   # bge's bf16-policy forward
        shape = ShapeConfig("prefill", S, B, "prefill")
        p, cdt = quantize.serve_params(params(cfg), "bf16")

        def step(p, tokens):
            return embedder.embed(p, cfg, tokens, compute_dtype=cdt)

        args = (p, batch(cfg, shape)["tokens"])
    return step, args, roofline.model_flops(cfg, shape, args[0])


def dryrun_one(name: str, dev) -> dict:
    """One step traced on the meta device, then run on ``dev``: kernel
    calls on meta against launches on the card, the roofline bound
    against the device time, the dry run's argument + temp bytes against
    the card's peak allocation."""
    import gc

    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.roofline import op_cost

    cuda = dev.type == "cuda"
    step, args, mflops = dryrun_step(name, torch.device("meta"), cuda)
    cost = op_cost.analyse_step(step, *args)
    roof = roofline.analyse(cost, 1, mflops)
    arg_bytes = op_cost.tree_bytes(args)
    del step, args
    out = {"model_flops": mflops, "flops": cost.flops,
           "bytes": cost.bytes, "dot_flops": cost.dot_flops,
           "kernel_flops": cost.kernel_flops, "ops": cost.ops,
           "compute_ms": roof.compute_s * 1e3,
           "memory_ms": roof.memory_s * 1e3, "dominant": roof.dominant,
           "bound_ms": roof.bound_s * 1e3,
           "meta_kernel_calls": dict(sorted(cost.kernel_calls.items())),
           "argument_bytes": arg_bytes,
           "temp_bytes": cost.peak_temp_bytes}

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    step, args, _ = dryrun_step(name, dev, cuda)
    step(*args)                           # warm-up: allocator, cuBLAS
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()                 # the counted step starts here
    step(*args)
    sync()
    counts = {k: v for k, v in launch_counts().items() if v}   # ends here
    out["launches"] = counts
    if cuda:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        out["argument_plus_temp_over_allocated"] = (
            (arg_bytes + cost.peak_temp_bytes)
            / out["max_memory_allocated"])
        # the step's span on the device by CUDA events (median of 3), and
        # its busy time: the kernels' durations in a trace of one step
        times = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            step(*args)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        out["event_ms"] = statistics.median(times)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(*args)
            sync()
        path = os.path.join(ROOT, "build", "profile", f"dryrun_{name}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        with open(path) as f:
            durs = [e["dur"] for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "kernel"]
        out["busy_ms"] = sum(durs) / 1e3 if durs else out["event_ms"]
        out["busy_from"] = "trace" if durs else "events"
        out["kernels_traced"] = len(durs)
        out["bound_over_busy"] = out["bound_ms"] / out["busy_ms"]
        out["share_of_bf16_peak"] = (mflops / (out["event_ms"] / 1e3
                                               * PEAK_FLOPS["bfloat16"]))
        require(counts == out["meta_kernel_calls"],
                f"{name}: kernel calls on meta {out['meta_kernel_calls']}, "
                f"launches on the card {counts}")
        for key in ("busy_ms", "event_ms"):
            require(out[key] >= out["bound_ms"],
                    f"{name}: {key} {out[key]} below the roofline bound "
                    f"{out['bound_ms']}")
    del step, args
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def phase_dryrun(args, dev) -> dict:
    """Each of DRYRUN_STEPS through ``dryrun_one``, one at a time; the
    launches of the counted steps are this path's."""
    out = {"card": card_line()}
    launches: dict = {}
    for name in DRYRUN_STEPS:
        res = dryrun_one(name, dev)
        out[name] = res
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out["launches"] = launches
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
           ("flash_decode", FD_SOURCE, FD_REPLACES),
           ("flash_attention_bwd", FAB_SOURCE, FA_REPLACES),
           ("rmsnorm_bwd", RN_SOURCE, RN_REPLACES),
           ("ssm_scan_bwd", SS_SOURCE, SS_REPLACES))


def kernel_summary(main: dict, by_path: dict) -> dict:
    """One row a kernel: its case at the main path's shape, and its
    launches on the main paths (``by_path``: path -> launch counts)."""
    rows = []
    keys = ("kernel_ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
            "max_abs_err")
    # fp32 attention's CUDA-core figure; quantize_rows' traffic yardstick;
    # the sharded decode read's launches alone and its log-sum-exps' error
    extra = ("bound_cuda_core_ms", "yardstick_to_int8_ms", "lse_launches_ms",
             "lse_max_abs_err", "held", "dq", "dk", "dv", "dx", "dscale",
             "ddt", "dBm", "dCm", "dA", "bitwise_repeat")
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
                   for path in ("serve", "offload", "chaos", "generate",
                                "encdec", "mesh", "train", "dryrun")
                   if path in results}
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
