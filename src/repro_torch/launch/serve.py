"""Serving driver: the full WindVE pipeline, with the real embedder pool on
the card.

Device detector -> estimator calibration (profiling the REAL PyTorch
embedder for the real pool and the paper-calibrated model for the NPU pool)
-> queue manager -> threaded engine -> workload replay -> stats.

The real embedding pool runs ``repro_torch.core.sharded_backend``, fanned
out over ``--devices N`` of the visible cards (0 = all of them; the pool is
clamped to a power of two), and the serving flags select the optimized
rows::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        --devices 0 --queries 64 --slo 1.0 \
        --opt embed_dtype=bf16,embed_async=1 --prewarm

``embed_dtype`` is ``fp32`` (the precision oracle), ``bf16``, ``int8``
(int8 projection weights, fp32 activations) or ``int8_w8a8`` (int8 weights
and per-row int8 activations at every projection).  With ``--policy
length-aware`` the dispatch threshold is calibrated from one Eq. 12 fit PER
seq-length bucket, so it tracks the bucketed service curve instead of a
hand-picked constant.  ``--device cpu`` runs the same pipeline on the host
with the kernels' plain versions, over ``--devices`` CPU positions.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import perf_flags
from repro_torch.configs import get_config
from repro_torch.core import adaptive
from repro_torch.core.admission import AdmissionController
from repro_torch.core.bucketing import length_bucket_fn
from repro_torch.core.cache import cache_tier
from repro_torch.core.device_detector import DeviceInventory, detect
from repro_torch.core.estimator import (estimate_depth, estimate_depth_per_bucket,
                                  fanout_probe_points, replica_fits)
from repro_torch.core.health import BrownoutController, CircuitBreaker
from repro_torch.core.routing import (CPU, NPU, CascadePolicy, LeastLoadedPolicy,
                                LengthAwarePolicy, PredictivePolicy, Query,
                                RetryPolicy, RoundRobinPolicy, TierSpec,
                                replicate)
from repro_torch.core.sharded_backend import ShardedEmbedderBackend
from repro_torch.core.simulator import PAPER_DEVICES, profile_fn_for
from repro_torch.core.windve import ModeledBackend, WindVE, resolve_device
from repro_torch.data.workload import make_queries
from repro_torch.launch.mesh import visible_devices
from repro_torch.models import embedder

POLICIES = {
    "cascade": CascadePolicy,
    "length-aware": LengthAwarePolicy,
    "least-loaded": LeastLoadedPolicy,
    "predictive": PredictivePolicy,
    "round-robin": RoundRobinPolicy,
}

MAX_TOKENS = 96
MIN_SEQ_BUCKET = 16


def build_engine(model: str = "bge-large-zh-v1.5", slo: float = 1.0,
                 smoke: bool = True, heter: bool = True,
                 npu_model: str = "tesla-v100/bge", seed: int = 0,
                 policy: str = "cascade", devices: int = 0,
                 npu_devices: int = 1, prewarm: bool = False, hosts: int = 1,
                 replicas: int = 1, device="cuda"):
    cfg = get_config(model)
    if smoke:
        cfg = cfg.smoke()
    dev = resolve_device(device)
    params = embedder.init_embedder(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)

    det = detect(DeviceInventory(npus=1, cpus=1), heter_requested=heter)
    print(f"[serve] detector: main={det.device_main} aux={det.device_auxiliary} "
          f"heter={det.heter_enable}")

    # the modeled accelerator pool: --npu-devices N fans the tier out over
    # an N-device mesh model (per-device pow2 chunks + gather overhead), so
    # the depth calibrated below fits the curve a sharded deployment shows.
    # --hosts H --replicas R expands this tier into H*R replica tiers, each
    # with its OWN backend instance (independently-failing capacity units);
    # 1x1 stays bitwise the single-replica path.
    npu_dev = PAPER_DEVICES[npu_model]

    def npu_backend(h: int, r: int) -> ModeledBackend:
        return ModeledBackend(npu_dev, embed_dim=cfg.d_model,
                              devices=npu_devices)

    npu_be = npu_backend(0, 0)
    # the real pool: one tier fans out over the visible cards (on the CPU:
    # over `devices` positions of the host); dtype / async dispatch follow
    # the embed_* serving flags
    local = visible_devices() if dev.type == "cuda" else [dev] * max(devices, 1)
    cpu_be = ShardedEmbedderBackend(
        cfg, params, max_tokens=MAX_TOKENS,
        devices=local[:devices] if devices else local,
        min_seq_bucket=MIN_SEQ_BUCKET)
    print(f"[serve] embed pool: {cpu_be.name} "
          f"(mesh fan-out over {cpu_be.device_count}/{len(local)} devices)")
    if prewarm:
        n = cpu_be.prewarm(cpu_be.warm_grid(max_batch=16))
        print(f"[serve] prewarmed {n} (B, S) buckets — no new shape while "
              f"serving")

    # --- §4.2.2: calibrate queue depths with the linear-regression estimator
    # (probing the FAN-OUT model at multiples of the device count, so the
    # fitted line is the sharded tier's service curve, not one device's)
    d_npu, fit_n = estimate_depth(profile_fn_for(npu_be.model),
                                  slo,
                                  probe_points=fanout_probe_points(npu_devices))

    def profile_cpu(c: int) -> float:
        qs = make_queries(c, cfg.vocab_size, length=75, seed=seed)
        batch = [Query(qid=i, payload=q, length=75) for i, q in enumerate(qs)]
        t0 = time.monotonic()
        cpu_be.embed_batch(batch)
        return time.monotonic() - t0

    # probe at multiples of the backend's batch-bucket floor: on an N-device
    # mesh every batch pads up to at least N rows, so probing (1, 2, 4, 8)
    # raw would execute ONE identical shape four times, fit a flat line and
    # return the estimator's unbounded-depth sentinel
    base = max(1, cpu_be.min_batch_bucket)
    d_cpu, fit_c = (estimate_depth(profile_cpu, slo,
                                   probe_points=tuple(base * c
                                                      for c in (1, 2, 4, 8)))
                    if det.heter_enable else (0, None))
    d_npu, d_cpu = max(d_npu, 1), max(d_cpu, 0)
    print(f"[serve] depths: C_NPU={d_npu} (a={fit_n.alpha:.4f} b={fit_n.beta:.3f}) "
          f"C_CPU={d_cpu}" + (f" (a={fit_c.alpha:.4f} b={fit_c.beta:.3f})"
                              if fit_c else ""))

    # the accelerator tier, expanded to hosts x replicas first-class tiers
    # (replicate(spec, 1, 1) returns the original spec untouched): each
    # replica gets its own ModeledBackend — and below its own breaker, its
    # own Eq. 12 fit, and its own admission watermark, because a replica is
    # an independently-failing capacity unit
    npu_tiers = replicate(TierSpec(NPU, d_npu, backend=npu_be),
                          hosts, replicas, backend=npu_backend)
    if len(npu_tiers) > 1:
        print(f"[serve] replicas: {hosts} host(s) x {replicas} = "
              f"{len(npu_tiers)} {NPU} replica tier(s), "
              f"C_total={d_npu * len(npu_tiers)}: "
              + " ".join(t.name for t in npu_tiers))
    # per-replica Eq. 12 fits, keyed by replica tier name — what makes the
    # predictive policy and the admission controller price each replica's
    # backlog against its own service curve
    npu_fits = replica_fits(
        {t.name: t.backend.model for t in npu_tiers},
        probe_points=fanout_probe_points(npu_devices))

    policy_obj = POLICIES[policy]()
    if policy == "predictive":
        # seed the latency-predictive dispatch with the offline Eq. 12 fits
        # (per-tier service curves); the online calibrator attached below
        # refreshes them from live traffic through the batch hook
        policy_obj = PredictivePolicy(
            fits={**npu_fits, **({CPU: fit_c} if fit_c else {})},
            bucket_fn=length_bucket_fn(MIN_SEQ_BUCKET, MAX_TOKENS))
    if policy == "length-aware" and det.heter_enable and d_cpu > 0:
        # one Eq. 12 fit PER seq-length bucket: the long-query threshold is
        # the first bucket whose measured CPU depth collapses to 0, so the
        # policy follows the bucketed service curve instead of the
        # hand-picked default
        def profile_bucket(c: int, length: int) -> float:
            batch = [Query(qid=i, length=length) for i in range(c)]
            cpu_be.embed_batch(batch)    # warm this (B, S) bucket: the fit
            best = float("inf")          # must see service time, not set-up
            for _ in range(2):
                t0 = time.monotonic()
                cpu_be.embed_batch(batch)
                best = min(best, time.monotonic() - t0)
            return best

        s, lengths = MIN_SEQ_BUCKET, []
        while s < MAX_TOKENS:
            lengths.append(s)
            s *= 2
        lengths.append(MAX_TOKENS)
        fits = estimate_depth_per_bucket(
            profile_bucket, slo, lengths,
            probe_points=tuple(base * c for c in (1, 2, 4)))
        policy_obj = LengthAwarePolicy.from_bucket_depths(
            {b: d for b, (d, _) in fits.items()})
        print("[serve] per-bucket depths: "
              + " ".join(f"S{b}:C={d}" for b, (d, _) in sorted(fits.items()))
              + f" -> long_threshold={policy_obj.long_threshold}")

    # the topology is a TierSpec list: N tiers are a config change, not a
    # rewrite (e.g. append a little-core CPU pool here)
    tiers = list(npu_tiers)
    if det.heter_enable and d_cpu > 0:
        # an int8 tier is marked quantized: brownout degradation prefers it
        # at equal backlog
        tiers.append(TierSpec(CPU, d_cpu, backend=cpu_be,
                              bucket_fn=length_bucket_fn(MIN_SEQ_BUCKET,
                                                         MAX_TOKENS),
                              quantized=cpu_be.dtype.startswith("int8")))
    # --opt cache=N[,cache_bytes=M]: the zero-cost tier at the head of the
    # topology — exact-match hits bypass every device queue entirely
    flags = perf_flags.FLAGS
    if flags.cache > 0:
        tiers.insert(0, cache_tier(flags.cache,
                                   flags.cache_bytes or None))
        print(f"[serve] cache tier: {flags.cache} entries"
              + (f", {flags.cache_bytes} bytes" if flags.cache_bytes else "")
              + " (exact-match LRU at the head of the topology)")
    # --opt breaker=N[,breaker_cooldown_ms=M]: per-tier circuit breakers —
    # N consecutive batch failures trip a tier out of dispatch until its
    # half-open probe recovers; every policy routes around it transparently
    if flags.breaker > 0:
        for t in tiers:
            if t.cache is None:
                t.breaker = CircuitBreaker(
                    failure_threshold=flags.breaker,
                    cooldown_s=flags.breaker_cooldown_ms / 1e3)
        print(f"[serve] breakers: trip after {flags.breaker} consecutive "
              f"failures, cooldown {flags.breaker_cooldown_ms}ms")
    # --opt retries=N[,retry_backoff_ms=M] + deadline_ms=D: failed batches
    # re-dispatch through the policy path; overdue queued queries expire
    retry = RetryPolicy(max_retries=flags.retries,
                        backoff_s=flags.retry_backoff_ms / 1e3)
    deadline_s = flags.deadline_ms / 1e3 if flags.deadline_ms > 0 else None
    if flags.retries or deadline_s is not None:
        print(f"[serve] fault tolerance: retries={flags.retries} "
              f"backoff={flags.retry_backoff_ms}ms "
              f"deadline={flags.deadline_ms or 'none'}ms")
    # --opt admission=on[,reject_cost=X,watermark=N] + brownout=on: the
    # overload-control pair
    admission = None
    if flags.admission:
        admission = AdmissionController(
            fits={**npu_fits, **({CPU: fit_c} if fit_c else {})},
            slo_s=slo, reject_cost=flags.reject_cost,
            watermark=flags.watermark)
        print(f"[serve] admission control: reject_cost={flags.reject_cost} "
              f"watermark={flags.watermark} "
              f"(priced against the calibrated Eq. 12 fits)")
    brownout = None
    if flags.brownout:
        brownout = BrownoutController()
        print(f"[serve] brownout: degraded@{brownout.degraded_at} "
              f"shedding@{brownout.shedding_at} "
              f"deadline_scale={brownout.deadline_scale}")
    engine = WindVE(tiers=tiers, policy=policy_obj, retry=retry,
                    default_deadline_s=deadline_s,
                    admission=admission, brownout=brownout)
    if policy == "predictive":
        # live fits: every completed batch feeds the calibrator; every refit
        # streams fresh per-tier (and per-bucket) curves into the policy
        adaptive.attach(engine, adaptive.OnlineCalibrator(slo),
                        policy=policy_obj,
                        bucket_fn=length_bucket_fn(MIN_SEQ_BUCKET,
                                                   MAX_TOKENS))
    return engine, cfg


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="bge-large-zh-v1.5")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--slo", type=float, default=1.0)
    ap.add_argument("--length", type=int, default=75)
    ap.add_argument("--no-heter", action="store_true",
                    help="disable CPU offloading (the paper's baseline)")
    ap.add_argument("--policy", default="cascade", choices=sorted(POLICIES),
                    help="dispatch policy (cascade == paper Algorithm 1)")
    ap.add_argument("--device", default="cuda",
                    help="device of the real embed pool (cuda, cuda:N or "
                         "cpu)")
    ap.add_argument("--opt", default="",
                    help="perf flags, e.g. embed_dtype=bf16,embed_async=1"
                         ",cache=4096,cache_bytes=0 "
                         "(embed_dtype: fp32|bf16|int8|int8_w8a8; cache=N "
                         "puts an N-entry exact-match embedding cache at "
                         "the head of the dispatch topology); fault "
                         "tolerance: deadline_ms=N,retries=N,"
                         "retry_backoff_ms=N,breaker=N,breaker_cooldown_ms=N"
                         "; overload control: admission=on,reject_cost=X,"
                         "watermark=N,brownout=on")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices the embed tier fans out over (0 = all "
                         "visible cards; with --device cpu, CPU positions)")
    ap.add_argument("--npu-devices", type=int, default=1,
                    help="devices the MODELED accelerator tier fans out "
                         "over (DES-calibrated Eq. 12 fan-out curve)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="hosts the accelerator tier replicates across; "
                         "each host carries --replicas replica tiers "
                         "(1x1 = today's single-replica path)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="accelerator replicas per host — each an "
                         "independently-failing tier with its own queue, "
                         "breaker, and Eq. 12 fit")
    ap.add_argument("--prewarm", action="store_true",
                    help="run the (B, S) bucket grid once before serving")
    args = ap.parse_args()

    if args.opt:
        perf_flags.set_flags(**perf_flags.parse_opt(args.opt))
    engine, cfg = build_engine(args.model, args.slo, heter=not args.no_heter,
                               policy=args.policy, devices=args.devices,
                               npu_devices=args.npu_devices,
                               prewarm=args.prewarm,
                               hosts=args.hosts, replicas=args.replicas,
                               device=args.device)
    queries = make_queries(args.queries, cfg.vocab_size, args.length)
    t0 = time.monotonic()
    futs = [engine.submit(payload=q, length=args.length) for q in queries]
    done, failures = [], []
    for f in futs:
        if f is None:
            continue
        try:
            done.append(f.result(timeout=60))
        except Exception as e:       # ServeError / DeadlineExceeded
            failures.append(e)
    wall = time.monotonic() - t0
    s = engine.stats
    print(f"[serve] {args.queries} queries in {wall:.2f}s: "
          f"accepted={s.accepted} rejected(BUSY)={s.rejected} "
          f"completed={len(done)} failed={len(failures)}")
    if any(s.rejections.values()) or s.brownout_transitions:
        rej = " ".join(f"{k}={v}" for k, v in sorted(s.rejections.items())
                       if v)
        bro = " ".join(f"->{k}x{v}" for k, v in
                       sorted(s.brownout_transitions.items()))
        print(f"[serve] overload: rejections {rej or 'none'}"
              + (f"  brownout {bro}" if bro else ""))
    if failures or s.deadline_misses or s.backend_errors or s.retries:
        print(f"[serve] faults: deadline_misses="
              f"{sum(s.deadline_misses.values())} "
              f"retries={sum(s.retries.values())} "
              f"backend_errors={sum(s.backend_errors.values())} "
              f"breaker trips={sum(s.breaker_trips.values())} "
              f"recoveries={sum(s.breaker_recoveries.values())}")
    print(f"[serve] per-device: {s.per_device}  "
          f"p50={s.p(50):.3f}s p99={s.p(99):.3f}s  "
          f"SLO({args.slo}s) violations="
          f"{sum(1 for l in s.latencies if l > args.slo)}")
    if args.hosts * args.replicas > 1:
        # replica-aware summary: per-replica counters rolled up by logical
        # tier, so imbalance (and a quarantined replica) is visible at a
        # glance instead of buried in @hXrY-keyed raw counters
        for base, g in sorted(s.replica_rollup().items()):
            if len(g["replicas"]) < 2:
                continue
            split = g.get("dispatched_by_replica", {})
            print(f"[serve] replicas[{base}]: dispatched="
                  f"{g.get('dispatched', 0)} completed="
                  f"{g.get('completed', 0)} over {len(g['replicas'])} "
                  f"replicas  ["
                  + " ".join(f"{n}={split.get(n, 0)}"
                             for n in g["replicas"]) + "]")
    tails = "  ".join(
        f"{t}: p95={s.batch_p(95, t)*1e3:.1f}ms"
        for t in sorted(s.tier_batch_latencies))
    print(f"[serve] batch service tail: p50={s.batch_p(50)*1e3:.1f}ms "
          f"p95={s.batch_p(95)*1e3:.1f}ms p99={s.batch_p(99)*1e3:.1f}ms "
          f"over {len(s.batch_latencies)} batches  [{tails}]")
    if s.cache_hits or s.cache_misses:
        print(f"[serve] cache: hit-rate={s.cache_hit_rate():.1%} "
              f"hits={sum(s.cache_hits.values())} "
              f"misses={sum(s.cache_misses.values())} "
              f"inserts={sum(s.cache_inserts.values())} "
              f"evictions={sum(s.cache_evictions.values())} "
              f"staleness p50={s.cache_staleness(50):.2f}s")
    print(f"[serve] max concurrency C = {engine.max_concurrency}")
    engine.shutdown()
    print(f"[serve] clean shutdown: {engine.stats.clean_shutdown}")


if __name__ == "__main__":
    main()
