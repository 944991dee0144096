"""Discrete-event serving simulator with paper-calibrated device models.

This CPU-only container has no NPU/GPU, so the paper's hardware is modeled:
each device's processing latency under concurrency C follows the paper's
Eq. 12 shape with a small convex term,

    t_d(C) = beta_d + b_d * C + a_d * C^2 ,

where (b_d, a_d) are solved EXACTLY from the paper's two stress-test anchors
(C@1s, C@2s from Tables 1-3) and beta_d from Fig. 4.  The mild convexity is
what the paper itself observed: its linear-regression estimator slightly
undershoots the fine-tuned depth (Table 3, V100: regression 40 vs fine-tuned
44) — this simulator reproduces that emergently.

The DES engine is the second *driver* of the shared scheduling core
(``repro_torch.core.routing``): it feeds arrival traces through the SAME
``QueueManager.dispatch`` + ``DispatchPolicy`` the threaded engine uses and
measures e2e latency / SLO violations / busy rate, so the no-offload vs
CPU-offload comparison (Tables 1-2) runs end to end with dispatch semantics
that cannot diverge from the real engine's.
"""
from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.routing import (ADMISSION, BUSY, CPU, EXPIRED, NPU,
                                DispatchPolicy, Query, QueueManager,
                                RetryPolicy, TierSpec)
from repro_torch.core.telemetry import SimResult, Telemetry


# ---------------------------------------------------------------------------
# calibrated device latency models
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceModel:
    name: str
    beta: float                  # fixed cost (Fig. 4 intercepts)
    b: float                     # linear term
    a: float                     # convex term (anchor-solved)
    noise_std: float = 0.0       # relative noise (Atlas/Kunpeng outliers §5.3)
    # query-length scaling (paper §5.4: latency grows with input length;
    # default length 75 tokens is the paper's RAG segmentation setting)
    ref_length: int = 75

    def latency(self, concurrency: float, length: int = 75,
                rng: Optional[random.Random] = None) -> float:
        c = max(0.0, float(concurrency))
        t = self.beta + self.b * c + self.a * c * c
        # linear-in-length scaling of the compute part (embedding FLOPs are
        # ~linear in tokens for fixed batch)
        t = self.beta + (t - self.beta) * (length / self.ref_length)
        if self.noise_std and rng is not None:
            t *= max(0.1, 1.0 + rng.gauss(0.0, self.noise_std))
        return t


def solve_anchors(beta: float, c1: float, t1: float, c2: float, t2: float
                  ) -> Tuple[float, float]:
    """Solve (b, a) so beta + b*c + a*c^2 passes exactly through both
    stress-test anchors (c1, t1), (c2, t2)."""
    d1, d2 = t1 - beta, t2 - beta
    det = c1 * c2 * c2 - c2 * c1 * c1
    a = (c1 * d2 - c2 * d1) / det
    b = (d1 - a * c1 * c1) / c1
    return b, a


def _mk(name: str, beta: float, c1: float, t1: float, c2: float, t2: float,
        noise: float = 0.0) -> DeviceModel:
    b, a = solve_anchors(beta, c1, t1, c2, t2)
    if a < 0.0:
        # anchors imply concavity for the given beta: fall back to the pure
        # linear Eq. 12 through both anchors (beta refit, a = 0)
        b = (t2 - t1) / (c2 - c1)
        beta = t1 - b * c1
        a = 0.0
    return DeviceModel(name, beta, b, a, noise)


# Anchors: Tables 1-3 (bge) and Table 2 (jina); betas: Fig. 4.
PAPER_DEVICES: Dict[str, DeviceModel] = {
    # bge-large-zh-v1.5 calibration
    "tesla-v100/bge": _mk("tesla-v100/bge", 0.27, 44, 1.0, 96, 2.0),
    "xeon-e5-2690/bge": _mk("xeon-e5-2690/bge", 0.32, 8, 1.0, 22, 2.0),
    "atlas-300i-duo/bge": _mk("atlas-300i-duo/bge", 0.24, 84, 1.0, 172, 2.0,
                              noise=0.03),
    "kunpeng-920/bge": _mk("kunpeng-920/bge", 0.85, 2, 1.0, 8, 2.0,
                           noise=0.05),
    # jina calibration
    "tesla-v100/jina": _mk("tesla-v100/jina", 0.25, 48, 1.0, 112, 2.0),
    "xeon-e5-2690/jina": _mk("xeon-e5-2690/jina", 0.30, 11, 1.0, 30, 2.0),
    "atlas-300i-duo/jina": _mk("atlas-300i-duo/jina", 0.22, 128, 1.0, 256, 2.0,
                               noise=0.03),
    "kunpeng-920/jina": _mk("kunpeng-920/jina", 0.80, 6, 1.0, 20, 2.0,
                            noise=0.05),
}


def _pow2_chunks(batch: int, floor: int) -> List[int]:
    """Pow2 chunk sizes covering ``batch`` with every chunk >= ``floor``.

    Mirrors ``BucketedEmbedderBackend._batch_plan`` (greedy binary
    decomposition, single rounded-up launch preferred when it pads no more
    rows) so the DES models the same executions the real sharded backend
    performs.  Duplicated rather than imported: ``bucketing`` sits above the
    engine layer and importing it here would cycle."""
    g = max(1, floor)
    greedy: List[int] = []
    rem = int(batch)
    while rem > 0:
        c = max(1 << (rem.bit_length() - 1), g)   # largest pow2 <= rem
        greedy.append(c)
        rem -= min(c, rem)
    single = g if batch <= g else 1 << (int(batch) - 1).bit_length()
    return [single] if single <= sum(greedy) else greedy


@dataclass(frozen=True)
class FanOutModel:
    """Sharded accelerator tier: one batch fans out over ``devices``.

    The paper's Eq. 12 fits the *measured per-tier service curve*; when the
    tier is a device mesh (``ShardedEmbedderBackend``), that curve is NOT
    the single-device one — a batch is bucketed to pow2 chunks floored at
    the mesh size, each chunk runs data-parallel with ``chunk/devices`` rows
    per device, and the chunk completes when the SLOWEST device does.  This
    model reproduces exactly that shape so ``estimate_depth`` calibrated on
    it matches the depth calibrated on the real sharded backend:

    * ``chunk_plan`` mirrors the bucketed backend's binary batch
      decomposition with the floor raised to the largest power of two that
      fits the device count — a *degraded* mesh (one host quarantined by
      its breaker leaves e.g. 6 of 8 devices) stays plannable: chunks stay
      pow2 (compile-cache bucketing preserved) and the straggler device
      takes ``ceil(chunk / devices)`` rows;
    * per-device service time comes from the wrapped single-device
      ``DeviceModel`` at the per-device row count (the existing
      length/batch cost model, unchanged);
    * each chunk adds a fan-out/gather overhead term
      (``fanout_beta_s * log2(devices)`` — a tree scatter+gather, plus
      ``interhost_beta_s * log2(hosts)`` when the mesh spans hosts: the
      cross-host all-gather rides the slower network fabric), and a
      noisy base model samples each device independently, so the chunk
      latency is the straggler's (max over devices);
    * chunks of one batch serialize (the real backend enqueues them on the
      same mesh back to back).

    ``devices=1`` is rejected — use the base ``DeviceModel`` directly
    (``sharded_model`` below does this), so a 1-device tier stays bitwise
    the single-device bucketed path.
    """

    base: DeviceModel
    devices: int
    fanout_beta_s: float = 0.0
    hosts: int = 1
    interhost_beta_s: float = 0.0

    def __post_init__(self):
        if self.devices < 2:
            raise ValueError("FanOutModel needs >= 2 devices; use the base "
                             "DeviceModel for a single device")
        if self.hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {self.hosts}")
        if self.devices % self.hosts:
            raise ValueError(f"devices ({self.devices}) must split evenly "
                             f"over hosts ({self.hosts})")

    # profile_fn_for / telemetry duck-type these off DeviceModel
    @property
    def name(self) -> str:
        tag = f"{self.base.name}x{self.devices}dev"
        return tag if self.hosts <= 1 else f"{tag}x{self.hosts}h"

    @property
    def noise_std(self) -> float:
        return self.base.noise_std

    @property
    def ref_length(self) -> int:
        return self.base.ref_length

    @property
    def overhead_s(self) -> float:
        """Per-execution scatter+gather cost of the mesh: the intra-host
        tree (depth log2(devices)) plus, when the mesh spans hosts, a
        cross-host gather tree on the network fabric (depth log2(hosts))."""
        over = self.fanout_beta_s * math.log2(self.devices)
        if self.hosts > 1:
            over += self.interhost_beta_s * math.log2(self.hosts)
        return over

    @property
    def chunk_floor(self) -> int:
        """Largest power of two <= ``devices``: chunks stay pow2 (the
        compile-cache bucket grid) even when the device count is degraded
        mid-outage to a non-pow2 value."""
        return 1 << (self.devices.bit_length() - 1)

    def chunk_plan(self, batch: int) -> List[int]:
        """Pow2 execution chunks for a batch (floored at the largest pow2
        that fits the — possibly degraded — mesh size)."""
        return _pow2_chunks(batch, self.chunk_floor)

    def latency(self, concurrency: float, length: int = 75,
                rng: Optional[random.Random] = None) -> float:
        batch = max(1, int(math.ceil(concurrency)))
        total = 0.0
        for chunk in self.chunk_plan(batch):
            # ceil: on a non-pow2 (degraded) mesh the rows split unevenly
            # and the chunk completes with the fullest device; exact
            # division — bitwise the old path — when devices is pow2
            rows = -(-chunk // self.devices)
            if self.base.noise_std and rng is not None:
                # independent per-device noise: the chunk finishes with the
                # straggler (the Atlas/Kunpeng outliers of §5.3, fanned out)
                per_dev = max(self.base.latency(rows, length, rng)
                              for _ in range(self.devices))
            else:
                per_dev = self.base.latency(rows, length)
            total += self.overhead_s + per_dev
        return total


def sharded_model(base: DeviceModel, devices: int = 1,
                  fanout_beta_s: float = 0.0, hosts: int = 1,
                  interhost_beta_s: float = 0.0):
    """The DES-side mirror of ``ShardedEmbedderBackend``'s mesh degrade
    rule: 1 device IS the base model (bitwise the single-device path),
    2+ devices wrap it in the fan-out service-curve model — spanning
    ``hosts`` machines when a replica group is carved across the pool."""
    if devices <= 1:
        return base
    return FanOutModel(base, devices, fanout_beta_s, hosts, interhost_beta_s)


def cpu_core_scaled(dev: DeviceModel, cores: int, full_cores: int = 44
                    ) -> DeviceModel:
    """§5.4 CPU-core scalability, calibrated to the paper's Fig. 6:

    * above the knee (``full_cores``): near-linear speedup, capped at 2x —
      "the concurrency can not be improved continuously after a border, due
      to the bottleneck of host memory bandwidth";
    * below the knee: a CLIFF — "the loss of computing ability leads to the
      dramatical increase of CPU latency", i.e. <44 cores bring no benefit
      at the 1s SLO and <36 none at 2s.  Modeled as 10^((full-cores)/8)."""
    if cores <= 0:
        raise ValueError("cores must be positive")
    if cores >= full_cores:
        scale = max(full_cores / cores, 0.5)      # bandwidth saturation cap
    else:
        scale = 10.0 ** ((full_cores - cores) / 8.0)
    return DeviceModel(f"{dev.name}@{cores}c", dev.beta, dev.b * scale,
                       dev.a * scale, dev.noise_std, dev.ref_length)


def quantized_model(dev: DeviceModel, slope_scale: float,
                    tag: str = "w8a8") -> DeviceModel:
    """DES mirror of a quantized serving policy on ``dev``: the measured
    quantized/fp32 service-time ratio scales the concurrency-dependent
    terms (b, a — the per-query slope the estimator fits as ``beta_s``)
    while the fixed dispatch cost ``beta`` stays.  ``slope_scale < 1``
    (quantization helps) therefore raises the Eq. 11 depth
    ``(SLO - beta)/alpha`` — the DES and ``estimator.quantized_fit`` agree
    on how the quantized tier is priced."""
    if slope_scale <= 0:
        raise ValueError(f"slope_scale must be positive, got {slope_scale}")
    return DeviceModel(f"{dev.name}+{tag}", dev.beta, dev.b * slope_scale,
                       dev.a * slope_scale, dev.noise_std, dev.ref_length)


# ---------------------------------------------------------------------------
# discrete-event simulation
# ---------------------------------------------------------------------------

class ServingSimulator:
    """Event-driven WindVE: DES driver of the shared scheduling core.

    New-style: ``ServingSimulator(tiers=[TierSpec(name, depth, model=...),
    ...], slo_s=..., policy=...)`` for arbitrary topologies.  Legacy form
    ``ServingSimulator(npu_model, cpu_model, npu_depth, cpu_depth, slo_s)``
    builds the paper's 2-tier cascade.

    Fault tolerance (mirrors the threaded engine event for event, so the
    DES can *size* a topology under failures, not just under load):

    * ``deadline_s`` arms every arrival with a relative deadline; queued
      queries past it are swept out at exact per-query "expire" events and
      ``pop_batch`` sweeps before every batch formation — dead work never
      reaches a device model;
    * ``retry`` re-dispatches failed batches through the policy path with
      bounded attempts; the exponential backoff is *priced* as simulated
      delay on the failed tier (its server sleeps it, like the engine's
      worker thread does);
    * ``faults`` maps tier name -> :class:`~repro_torch.core.faults.FaultModel`
      — the DES-side injector matching the engine's ``FaultyBackend``
      (same ordinal-plan / wall-time-schedule vocabularies);
    * a ``TierSpec.breaker`` trips/recovers on the simulated clock via the
      same ``QueueManager.tier_success`` / ``tier_failure`` bridges;
    * ``admission`` / ``brownout`` plug the engine's overload controllers
      (:class:`~repro_torch.core.admission.AdmissionController`,
      :class:`~repro_torch.core.health.BrownoutController`) into the shared
      ``QueueManager`` — the capacity planner (``repro_torch.core.planner``)
      sweeps them against load and outage traces.
    """

    def __init__(self, npu: Optional[DeviceModel] = None,
                 cpu: Optional[DeviceModel] = None,
                 npu_depth: int = 0, cpu_depth: int = 0, slo_s: float = 1.0,
                 query_length: int = 75, seed: int = 0, *,
                 tiers: Optional[Sequence[TierSpec]] = None,
                 policy: Optional[DispatchPolicy] = None,
                 retry: Optional[RetryPolicy] = None,
                 deadline_s: Optional[float] = None,
                 faults: Optional[Dict[str, "object"]] = None,
                 admission: "object" = None,
                 brownout: "object" = None):
        if tiers is None:
            if npu is None:
                raise ValueError("need an NPU model or an explicit tier list")
            tiers = [TierSpec(NPU, npu_depth, model=npu)]
            if cpu is not None and cpu_depth > 0:
                tiers.append(TierSpec(CPU, cpu_depth, model=cpu))
        tiers = list(tiers)
        for t in tiers:
            if t.model is None and t.cache is None:
                raise ValueError(f"tier {t.name!r} has no DeviceModel")
        self.qm = QueueManager(tiers, policy=policy,
                               stats=Telemetry(slo=slo_s),
                               admission=admission, brownout=brownout)
        self.slo = slo_s
        self.length = query_length
        self.rng = random.Random(seed)
        # same default as the engine: one attempt, structured failure
        self.retry = retry if retry is not None else RetryPolicy(max_retries=0)
        self.deadline_s = deadline_s
        self.faults: Dict[str, "object"] = dict(faults or {})

    # legacy accessors (pre-TierSpec callers peeked at these)
    @property
    def npu_model(self) -> DeviceModel:
        return self.qm.tiers[0].model

    @property
    def cpu_model(self) -> Optional[DeviceModel]:
        return self.qm.tiers[1].model if len(self.qm.tiers) > 1 else None

    def run_burst(self, n_queries: int) -> SimResult:
        """The paper's stress scenario: n queries arrive simultaneously."""
        return self.run([(0.0, self.length)] * n_queries)

    def run(self, arrivals: List[Tuple[float, int]]) -> SimResult:
        """arrivals: list of (time, query_length) or (time, query_length,
        payload) — the optional payload gives a query its cache identity
        (exact-match key) when the topology carries a cache tier; without
        it, payload-less queries of one length share one key, mirroring the
        engine's deterministic synthetic token streams."""
        res = self.qm.reset(stats=Telemetry(slo=self.slo))
        # every terminal death (queued expiry, retry exhaustion, re-dispatch
        # into a full topology) counts `failed` — same bridge the engine's
        # future-failing path drives
        self.qm.on_expire = lambda q: res.record_failed()
        for fm in self.faults.values():
            fm.reset()
        # event key: (time, priority, seq) — device "kick"s run AFTER every
        # same-instant arrival so a burst is batched, not started one-by-one;
        # "expire" sweeps run after kicks (pop_batch sweeps first anyway, so
        # a same-instant batch never contains the dead query either way)
        events: List[Tuple[float, int, int, str, object]] = []
        for i, arr in enumerate(arrivals):
            t, ln = arr[0], arr[1]
            payload = arr[2] if len(arr) > 2 else None
            dl = None if self.deadline_s is None else t + self.deadline_s
            heapq.heappush(events, (t, 0, i, "arrive",
                                    Query(qid=i, payload=payload, length=ln,
                                          arrival_t=t, deadline=dl)))
        device_tiers = [t for t in self.qm.tiers if t.cache is None]
        admit = bool(self.qm.cache_tiers)
        free_at = {t.name: 0.0 for t in device_tiers}
        models = {t.name: t.model for t in device_tiers}
        seq = len(arrivals)

        def nseq() -> int:
            nonlocal seq
            seq += 1
            return seq

        def armed(q: Query, tier: str) -> None:
            """A queued query with a deadline gets an exact expiry sweep."""
            if q.deadline is not None:
                heapq.heappush(events, (q.deadline, 2, nseq(),
                                        "expire", tier))

        def try_start(tier: str, now: float):
            if free_at[tier] > now + 1e-12:
                return
            # qm.pop_batch: same batch-formation code as the threaded engine
            # (bucket_fn-aware, deadline-swept); latency follows the LONGEST
            # query — the batch is one padded execution, not batch[0]'s
            batch = self.qm.pop_batch(tier, now=now)
            if not batch:
                return
            fm = self.faults.get(tier)
            failed, extra = fm.outcome(now) if fm is not None else (False, 0.)
            if failed:
                # the execution dies instead of serving: it costs failure
                # *detection* (plus any injected stall), never service
                dur = fm.fail_latency_s + extra
            else:
                dur = extra + models[tier].latency(
                    len(batch), max(q.length for q in batch), self.rng)
                res.record_batch(tier, dur)  # same tail metric as engine
            done = now + dur
            free_at[tier] = done
            heapq.heappush(events, (done, 0, nseq(), "done",
                                    (tier, batch, failed, dur)))

        def on_batch_failed(tier: str, batch: List[Query], now: float):
            """Mirror of the engine's ``_retry_or_fail``: bounded attempts,
            exhaustion counts ``failed``, survivors re-dispatch after the
            backoff — which the failed tier's server sits out."""
            self.qm.tier_failure(tier, now)
            retryable: List[Query] = []
            for q in batch:
                q.attempts += 1
                if q.attempts > self.retry.max_retries:
                    res.record_failed()
                else:
                    retryable.append(q)
            if not retryable:
                try_start(tier, now)
                return
            t2 = now + self.retry.backoff(retryable[0].attempts)
            free_at[tier] = max(free_at[tier], t2)
            heapq.heappush(events, (t2, 1, nseq(), "redispatch",
                                    (tier, retryable)))

        def on_redispatch(tier: str, qs: List[Query], now: float):
            kicked = {tier}
            for q in qs:
                if q.expired(now):
                    # burned its last attempt waiting out the backoff
                    res.record_deadline_miss(tier)
                    res.record_failed()
                    continue
                res.record_retry(tier)
                verdict = self.qm.dispatch(q, now=now)
                if verdict == BUSY or verdict == ADMISSION:
                    # no surviving capacity / admission shed a retry that
                    # already burned device time — terminal either way
                    # (mirror of the engine's _retry_or_fail)
                    res.record_failed()
                    continue
                if self.qm.is_cache_tier(verdict):
                    q.done_t = now
                    res.record_completion(q, verdict)
                    continue
                armed(q, verdict)
                kicked.add(verdict)
            for t2 in kicked:
                try_start(t2, now)

        while events:
            now, _, _, kind, obj = heapq.heappop(events)
            if kind == "arrive":
                verdict = self.qm.dispatch(obj)
                if verdict == BUSY:
                    continue
                if verdict == ADMISSION:
                    # shed at arrival: a rejection (rejections_admission),
                    # not a terminal failure — same as the engine's submit
                    continue
                if verdict == EXPIRED:
                    res.record_failed()
                    continue
                if self.qm.is_cache_tier(verdict):
                    # zero-latency tier: the hit completes at +0 service
                    # time — no queue slot, no device event
                    obj.done_t = now
                    res.record_completion(obj, verdict)
                    continue
                armed(obj, verdict)
                heapq.heappush(events, (now, 1, nseq(), "kick", verdict))
            elif kind == "kick":
                try_start(obj, now)
            elif kind == "expire":
                self.qm.sweep(obj, now)
            elif kind == "redispatch":
                on_redispatch(obj[0], obj[1], now)
            else:
                tier, batch, failed, dur = obj
                self.qm.queues[tier].finish(len(batch))
                if failed:
                    on_batch_failed(tier, batch, now)
                    continue
                self.qm.tier_success(tier, dur, now)
                for q in batch:
                    q.done_t = now
                    res.record_completion(q, tier)
                    if admit:
                        # admission hook: the computed embedding (a value
                        # the DES never materializes) enters the cache the
                        # instant its batch completes
                        self.qm.admit(q)
                try_start(tier, now)
        return res


# ---------------------------------------------------------------------------
# stress / profile helpers used by the estimator benchmarks
# ---------------------------------------------------------------------------

def profile_fn_for(dev: DeviceModel, length: int = 75,
                   seed: int = 0) -> Callable[[int], float]:
    """Latency-at-concurrency probe (one batched execution, like the paper's
    standalone profiling runs)."""
    rng = random.Random(seed)
    return lambda c: dev.latency(c, length, rng if dev.noise_std else None)


def poisson(rng: random.Random, lam: float) -> int:
    """Poisson sample (Knuth's product method; Gaussian tail for large lam).

    stdlib ``random`` has no Poisson sampler — the seed's
    ``hasattr(rng, "poissonvariate")`` branch was dead code and every trace
    silently fell back to a rounded Gaussian.  Knuth's method is exact for
    the moderate rates the Fig.-2 traces use; above ``lam > 100`` the normal
    approximation is within the model noise and avoids O(lam) sampling.
    """
    if lam <= 0.0:
        return 0
    if lam > 100.0:
        return max(0, int(round(rng.gauss(lam, math.sqrt(lam)))))
    L = math.exp(-lam)
    k, p = 0, 1.0
    while p > L:
        k += 1
        p *= rng.random()
    return k - 1


def diurnal_trace(n_seconds: int, base_rate: float, peak_rate: float,
                  length: int = 75, seed: int = 0) -> List[Tuple[float, int]]:
    """Fig.-2-style day curve: sinusoidal Poisson rate between base and peak."""
    rng = random.Random(seed)
    out: List[Tuple[float, int]] = []
    for s in range(n_seconds):
        phase = math.sin(2 * math.pi * s / max(n_seconds, 1) - math.pi / 2)
        rate = base_rate + (peak_rate - base_rate) * (phase + 1) / 2
        for _ in range(poisson(rng, rate)):
            out.append((s + rng.random(), length))
    out.sort()
    return out
