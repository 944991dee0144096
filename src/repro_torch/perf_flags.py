"""Serving and training toggles, set from the command line with
``--opt k=v,...``.

The fields the serving and training paths read, copied from the
reference's ``perf_flags.py``.  ``attn_kernel`` and ``embed_donate`` are
left out: eager PyTorch has nothing they switch (attention follows the
tensor's device; static buffers for CUDA graphs are later work).  Defaults
are the reference's, the paper-faithful baseline.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class PerfFlags:
    # mamba selective scan in training (``layers.mamba_forward``) on CPU
    # tensors: 0 = the per-timestep scan (baseline); N = an outer loop over
    # S/N chunks, each chunk checkpointed (``layers.mamba_scan_chunked``), so
    # the backward keeps only the chunk-boundary states.  On the card the
    # scan is always the ``ssm_scan`` kernel.
    mamba_chunk: int = 0
    # train remat policy: "full" (baseline: save only layer inputs) or
    # "dots" (save the matmul outputs; recompute only the cheap
    # elementwise/attention math).
    remat_policy: str = "full"
    # embedding serving precision: "fp32" (fp32-resident weights, fp32
    # trunk -- the precision oracle), "bf16" (weights cast ONCE at load,
    # all matmuls bf16), "int8" (projection weights quantized ONCE at load
    # to int8 with per-channel scales, fp32 activations) or "int8_w8a8"
    # (the same weights, and per-row int8 activations at every
    # projection, int8 x int8 with int32 accumulation).  The pool_norm
    # epilogue always accumulates fp32, so served vectors stay fp32 unit
    # vectors.
    embed_dtype: str = "fp32"
    # embedding serving: enqueue the embed and return a fetch handle so the
    # engine worker overlaps batch N's compute with batch N-1's
    # device->host fetch (double buffering) instead of blocking per batch.
    embed_async: bool = False
    # serving: N > 0 puts an exact-match embedding cache of N entries at
    # the head of the dispatch topology (token-hash keyed LRU, zero-latency
    # TierSpec -- repro_torch.core.cache).  0 = no cache (baseline).
    cache: int = 0
    # serving: optional byte budget for the cache tier (summed embedding
    # nbytes) on top of the entry count; 0 = entries-only bound.
    cache_bytes: int = 0
    # serving fault tolerance: N > 0 arms every submitted query with a
    # relative deadline of N milliseconds.  0 = no deadline (baseline).
    deadline_ms: int = 0
    # serving fault tolerance: re-dispatch each query of a failed batch up
    # to N times through the normal policy path.  0 = one attempt.
    retries: int = 0
    # serving fault tolerance: base exponential backoff (milliseconds)
    # before retry attempt k: backoff * 2^(k-1).
    retry_backoff_ms: int = 0
    # serving fault tolerance: trip a tier's circuit breaker after N
    # consecutive batch failures.  0 = no breakers (baseline).
    breaker: int = 0
    # serving fault tolerance: how long (milliseconds) a tripped breaker
    # stays open before the half-open recovery probe.
    breaker_cooldown_ms: int = 1000
    # serving overload control: SLO-aware admission at dispatch.
    admission: bool = False
    # serving overload control: the admission price of turning a query
    # away, against an expected SLO-violation cost of 1.0.
    reject_cost: float = 0.5
    # serving overload control: fraction of each tier's depth open to NEW
    # arrivals (1.0 = full depth).
    watermark: float = 1.0
    # serving overload control: three-stage brownout (normal -> degraded ->
    # shedding) on a dispatch-time utilization EWMA.
    brownout: bool = False
    # MoE: dispatch tokens to expert buckets per batch row (capacity from
    # the row's tokens) instead of one global dispatch over every token
    # of the batch (capacity from all of them).  Off = baseline.
    moe_row_dispatch: bool = False
    # decode: flash-decode over a sequence-sharded cache -- each shard
    # attends its own slots (``flash_decode`` with its log-sum-exp) and the
    # shards combine on the home device; only the owner shard writes the
    # new token.  Needs a mesh (``steps/serve.build_decode_step``).
    decode_shard_map: bool = False
    # serving: place weights tensor/expert-parallel only (resident weights,
    # no FSDP specs).  Executing that placement across cards is not ported
    # yet: the serve-step builders raise when it would split a weight.
    serve_tp_only: bool = False
    # the dry run's decode cache (launch/dryrun.py): fp32 when on, else
    # bf16 (the reference's flag; the LM backend's cache is fp32).
    cache_f32: bool = False


FLAGS = PerfFlags()


def set_flags(**kw) -> PerfFlags:
    global FLAGS
    FLAGS = dataclasses.replace(FLAGS, **kw)
    return FLAGS


def reset_flags() -> None:
    global FLAGS
    FLAGS = PerfFlags()


def parse_opt(spec: str) -> dict:
    """'embed_dtype=bf16,embed_async=1' -> kwargs dict."""
    out = {}
    for part in filter(None, spec.split(",")):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in PerfFlags.__dataclass_fields__:
            valid = ", ".join(sorted(PerfFlags.__dataclass_fields__))
            raise ValueError(f"unknown perf flag {k!r}; valid flags: {valid}")
        field = PerfFlags.__dataclass_fields__[k]
        if field.type in ("int", int):
            out[k] = int(v)
        elif field.type in ("float", float):
            out[k] = float(v)
        elif field.type in ("str", str):
            out[k] = v.strip()
        else:
            out[k] = v.strip() in ("1", "true", "True", "yes", "on")
        if k == "embed_dtype":
            # validate the VALUE here too: a typo'd policy must fail at the
            # CLI, not at first backend construction minutes into a run
            from repro_torch.models.quantize import EMBED_DTYPES
            if out[k] not in EMBED_DTYPES:
                raise ValueError(
                    f"unknown embed_dtype {out[k]!r}; valid values: "
                    f"{'|'.join(EMBED_DTYPES)}")
    return out
