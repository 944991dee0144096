"""Unified serving telemetry — one counter object for every driver.

The seed carried three divergent stat records: ``DispatchStats`` (queue
manager), ``EngineStats`` (threaded engine) and ``SimResult`` (DES).  They
counted the same events with different names, so the drivers could silently
disagree about what "accepted" meant.  ``Telemetry`` is the single record
now: the ``QueueManager`` writes dispatch verdicts into it, the drivers
(threads or DES) write completions into it, and every legacy accessor
(``to_npu``, ``rejected``, ``max_ok_concurrency``, ``p(50)``, ...) reads the
same underlying counts.

``DispatchStats``/``EngineStats``/``SimResult`` remain as aliases so older
call sites keep importing their familiar name.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - avoid circular import at runtime
    from repro_torch.core.routing import Query


@dataclass
class Telemetry:
    """Counts for one serving run: dispatch verdicts + completions.

    ``completed`` keeps the Query objects (the DES analyses them per run);
    ``latencies`` mirrors their e2e latencies for percentile/SLO queries
    without re-walking the list.  Long-running drivers (the threaded engine)
    set ``keep_queries=False`` so payloads are not pinned forever — every
    derived metric here reads ``latencies``, not ``completed``.
    """

    slo: float = 1.0
    busy: int = 0
    keep_queries: bool = True
    truncated: int = 0
    dispatched: Dict[str, int] = field(default_factory=dict)
    per_device: Dict[str, int] = field(default_factory=dict)
    # fault-tolerance counters (all zero / empty on a fault-free run, and
    # omitted from summary() so existing consumers see an unchanged shape):
    # deadline misses keyed by the tier the query was queued on ("arrival"
    # when it was already dead at dispatch), retries / backend errors /
    # breaker transitions keyed by the failing tier, plus terminal counts
    deadline_misses: Dict[str, int] = field(default_factory=dict)
    retries: Dict[str, int] = field(default_factory=dict)
    backend_errors: Dict[str, int] = field(default_factory=dict)
    breaker_trips: Dict[str, int] = field(default_factory=dict)
    breaker_recoveries: Dict[str, int] = field(default_factory=dict)
    failed: int = 0              # queries whose futures terminally failed
    hook_errors: int = 0         # batch hooks that raised (and were caught)
    # overload-control counters: rejections broken down by reason
    # ("no_capacity" = classic BUSY, "admission" = priced/watermark shed,
    # "expired" = dead on arrival at dispatch) and brownout stage
    # transitions keyed by the stage entered — all empty on a run that
    # never rejected, and omitted from summary() then
    rejections: Dict[str, int] = field(default_factory=dict)
    brownout_transitions: Dict[str, int] = field(default_factory=dict)
    # set by WindVE.shutdown(): False when a worker thread failed to join
    # (leaked); None until shutdown (and always None for the DES)
    clean_shutdown: Optional[bool] = None
    # zero-cost cache tier counters, keyed by cache tier name; hit ages are
    # entry staleness samples (hit time - insert time, driver clock)
    cache_hits: Dict[str, int] = field(default_factory=dict)
    cache_misses: Dict[str, int] = field(default_factory=dict)
    cache_inserts: Dict[str, int] = field(default_factory=dict)
    cache_evictions: Dict[str, int] = field(default_factory=dict)
    cache_hit_ages: Dict[str, List[float]] = field(default_factory=dict)
    completed: List["Query"] = field(default_factory=list)
    latencies: List[float] = field(default_factory=list)
    batch_latencies: List[float] = field(default_factory=list)
    tier_batch_latencies: Dict[str, List[float]] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    # -- writers (QueueManager.dispatch / the drivers) ---------------------
    def record_dispatch(self, tier: str) -> None:
        with self._lock:
            self.dispatched[tier] = self.dispatched.get(tier, 0) + 1

    def record_busy(self) -> None:
        with self._lock:
            self.busy += 1
            self.rejections["no_capacity"] = \
                self.rejections.get("no_capacity", 0) + 1

    def record_rejection(self, reason: str) -> None:
        """One arrival turned away for ``reason`` (``admission`` /
        ``expired``; ``no_capacity`` is written by :meth:`record_busy` so
        the legacy ``rejected == busy`` reader stays exact)."""
        with self._lock:
            self.rejections[reason] = self.rejections.get(reason, 0) + 1

    def record_brownout(self, stage: str) -> None:
        """The brownout controller entered ``stage`` (counted per stage
        entered, so ``brownout_transitions`` reads as a transition log)."""
        with self._lock:
            self.brownout_transitions[stage] = \
                self.brownout_transitions.get(stage, 0) + 1

    def record_truncations(self, n: int) -> None:
        """Queries whose payload was cut to the backend's max_tokens: the
        served embedding silently covers a prefix of the document, which is
        a quality bug, not a latency one — count it so operators see it."""
        if n:
            with self._lock:
                self.truncated += n

    def record_batch(self, tier: str, service_s: float) -> None:
        """One batch execution's service latency (enqueue -> results ready).
        Both drivers report it, so tail service latency (``batch_p``) is a
        first-class metric next to per-query e2e latency — means hide the
        p99 stalls that actually break the SLO contract.  Kept per tier as
        well: a modeled NPU tier and a real CPU tier have very different
        distributions, and mixing them would mask a tail regression."""
        with self._lock:
            self.batch_latencies.append(service_s)
            self.tier_batch_latencies.setdefault(tier, []).append(service_s)

    def record_cache_hit(self, tier: str, age_s: float) -> None:
        """One exact-match cache hit: the query is served at ~zero latency
        and zero FLOPs.  ``age_s`` is the entry's staleness at hit time —
        how long ago the served embedding was computed."""
        with self._lock:
            self.cache_hits[tier] = self.cache_hits.get(tier, 0) + 1
            self.cache_hit_ages.setdefault(tier, []).append(float(age_s))

    def record_cache_miss(self, tier: str) -> None:
        with self._lock:
            self.cache_misses[tier] = self.cache_misses.get(tier, 0) + 1

    def record_cache_insert(self, tier: str, evicted: int = 0) -> None:
        with self._lock:
            self.cache_inserts[tier] = self.cache_inserts.get(tier, 0) + 1
            if evicted:
                self.cache_evictions[tier] = \
                    self.cache_evictions.get(tier, 0) + int(evicted)

    # -- fault-tolerance writers ------------------------------------------
    def record_deadline_miss(self, tier: str) -> None:
        """One query expired before serving: swept out of ``tier``'s queue
        past its deadline, or dead on arrival (``tier == "arrival"``)."""
        with self._lock:
            self.deadline_misses[tier] = self.deadline_misses.get(tier, 0) + 1

    def record_retry(self, tier: str) -> None:
        """One re-dispatch attempt burned after ``tier`` failed a batch."""
        with self._lock:
            self.retries[tier] = self.retries.get(tier, 0) + 1

    def record_backend_error(self, tier: str) -> None:
        """One batch execution on ``tier`` raised instead of returning."""
        with self._lock:
            self.backend_errors[tier] = self.backend_errors.get(tier, 0) + 1

    def record_breaker_trip(self, tier: str) -> None:
        with self._lock:
            self.breaker_trips[tier] = self.breaker_trips.get(tier, 0) + 1

    def record_breaker_recovery(self, tier: str) -> None:
        with self._lock:
            self.breaker_recoveries[tier] = \
                self.breaker_recoveries.get(tier, 0) + 1

    def record_failed(self) -> None:
        """One query terminally failed: its future carries a ServeError
        (retries exhausted / worker death), not an embedding."""
        with self._lock:
            self.failed += 1

    def record_hook_error(self) -> None:
        """A batch-completion hook raised; the worker loop survived it but
        silent hook death is an observability bug, so it is counted."""
        with self._lock:
            self.hook_errors += 1

    def record_completion(self, query: "Query", tier: str) -> None:
        """The driver sets ``query.done_t`` first; latency is derived."""
        with self._lock:
            if self.keep_queries:
                self.completed.append(query)
            self.latencies.append(query.e2e_latency)
            self.per_device[tier] = self.per_device.get(tier, 0) + 1

    # -- dispatch-side readers --------------------------------------------
    @property
    def accepted(self) -> int:
        return sum(self.dispatched.values())

    @property
    def rejected(self) -> int:
        return self.busy

    @property
    def admission_rejected(self) -> int:
        """Arrivals shed by the admission controller (priced / watermark)."""
        return self.rejections.get("admission", 0)

    @property
    def to_npu(self) -> int:      # legacy DispatchStats field
        return self.dispatched.get("NPU", 0)

    @property
    def to_cpu(self) -> int:      # legacy DispatchStats field
        return self.dispatched.get("CPU", 0)

    # -- completion-side readers (all derived from ``latencies`` so they
    # work with keep_queries=False) ---------------------------------------
    @property
    def n_completed(self) -> int:
        return len(self.latencies)

    @property
    def violations(self) -> int:
        return sum(1 for l in self.latencies if l > self.slo + 1e-9)

    @property
    def max_ok_concurrency(self) -> int:
        """Largest number of simultaneously-resident queries that all met
        the SLO (the paper's 'maximum concurrency' metric)."""
        return sum(1 for l in self.latencies if l <= self.slo + 1e-9)

    # -- cache-tier readers ------------------------------------------------
    def cache_hit_rate(self, tier: Optional[str] = None) -> float:
        """Fraction of cache lookups that hit (``tier`` restricts to one
        cache tier; default aggregates every cache tier consulted)."""
        if tier is None:
            h = sum(self.cache_hits.values())
            m = sum(self.cache_misses.values())
        else:
            h = self.cache_hits.get(tier, 0)
            m = self.cache_misses.get(tier, 0)
        return h / (h + m) if (h + m) else 0.0

    def cache_staleness(self, q: float = 50.0,
                        tier: Optional[str] = None) -> float:
        """Percentile of entry age at hit time (seconds): how stale the
        embeddings actually being served from cache are."""
        if tier is None:
            ages = [a for v in self.cache_hit_ages.values() for a in v]
        else:
            ages = self.cache_hit_ages.get(tier, [])
        return float(np.percentile(ages, q)) if ages else 0.0

    def p(self, q: float) -> float:
        return float(np.percentile(self.latencies, q)) if self.latencies else 0.0

    def batch_p(self, q: float, tier: Optional[str] = None) -> float:
        """Percentile of per-batch service latency (seconds); ``tier``
        restricts to one device pool's batches."""
        lats = self.batch_latencies if tier is None else \
            self.tier_batch_latencies.get(tier, [])
        return float(np.percentile(lats, q)) if lats else 0.0

    def throughput(self, window_s: float) -> float:
        return self.accepted / window_s if window_s > 0 else 0.0

    def replica_rollup(self) -> Dict[str, Dict[str, object]]:
        """Per-tier counters regrouped by LOGICAL tier — the replica lens.

        Every counter here is already per-replica (replicas are ordinary
        tiers keyed by their ``NPU@h0r1``-style names); this rolls them
        back up by ``routing.replica_base`` so a serve summary can show
        both the logical total and the per-replica split:
        ``{"NPU": {"replicas": ["NPU@h0r0", ...], "dispatched": 120,
        "dispatched_by_replica": {"NPU@h0r0": 61, ...}, ...}}``.  Tiers
        that were never replicated group under their own name with a
        single-entry replica list, so the rollup is safe on any topology.
        """
        from repro_torch.core.routing import replica_base
        per_tier = {
            "dispatched": self.dispatched,
            "completed": self.per_device,
            "deadline_misses": self.deadline_misses,
            "retries": self.retries,
            "backend_errors": self.backend_errors,
            "breaker_trips": self.breaker_trips,
            "breaker_recoveries": self.breaker_recoveries,
        }
        groups: Dict[str, Dict[str, object]] = {}
        names: Dict[str, set] = {}
        for metric, counts in per_tier.items():
            for name, v in counts.items():
                base = replica_base(name)
                g = groups.setdefault(base, {})
                names.setdefault(base, set()).add(name)
                g[metric] = g.get(metric, 0) + v
                g.setdefault(f"{metric}_by_replica", {})[name] = v
        for base, g in groups.items():
            g["replicas"] = sorted(names[base])
        return groups

    def summary(self) -> Dict[str, float]:
        """One flat record of the run: dispatch verdicts, completions, SLO
        compliance and payload-truncation count (quality loss is surfaced
        next to latency, not hidden in a backend counter).  When a cache
        tier was consulted, hit-rate / counter / staleness fields join the
        record; when any fault-tolerance event occurred (deadline miss,
        retry, backend error, breaker transition, terminal failure, hook
        error), the fault counters join it too (omitted entirely on
        fault-free cache-less runs so existing consumers see an unchanged
        shape).  The same invariant holds for overload control:
        per-reason ``rejections_*`` and per-stage ``brownout_to_*`` keys
        join the record only when a rejection or brownout transition
        actually happened.  ``clean_shutdown`` appears once the engine has shut down:
        1.0 when every worker thread joined, 0.0 when one leaked."""
        fault: Dict[str, float] = {}
        if (self.deadline_misses or self.retries or self.backend_errors
                or self.breaker_trips or self.breaker_recoveries
                or self.failed or self.hook_errors):
            fault = {
                "deadline_misses": sum(self.deadline_misses.values()),
                "retries": sum(self.retries.values()),
                "backend_errors": sum(self.backend_errors.values()),
                "breaker_trips": sum(self.breaker_trips.values()),
                "breaker_recoveries": sum(self.breaker_recoveries.values()),
                "failed": self.failed,
                "hook_errors": self.hook_errors,
                **{f"deadline_misses_{k}": v
                   for k, v in sorted(self.deadline_misses.items())},
                **{f"backend_errors_{k}": v
                   for k, v in sorted(self.backend_errors.items())},
            }
        if self.clean_shutdown is not None:
            fault["clean_shutdown"] = float(self.clean_shutdown)
        overload: Dict[str, float] = {}
        if any(self.rejections.values()) or self.brownout_transitions:
            overload = {f"rejections_{k}": v
                        for k, v in sorted(self.rejections.items()) if v}
            overload.update({f"brownout_to_{k}": v for k, v in
                             sorted(self.brownout_transitions.items())})
        cache: Dict[str, float] = {}
        if self.cache_hits or self.cache_misses or self.cache_inserts:
            cache = {
                "cache_hit_rate": self.cache_hit_rate(),
                "cache_hits": sum(self.cache_hits.values()),
                "cache_misses": sum(self.cache_misses.values()),
                "cache_inserts": sum(self.cache_inserts.values()),
                "cache_evictions": sum(self.cache_evictions.values()),
                "cache_staleness_p50_s": self.cache_staleness(50),
                "cache_staleness_p95_s": self.cache_staleness(95),
                **{f"cache_hit_rate_{k}": self.cache_hit_rate(k)
                   for k in sorted(set(self.cache_hits)
                                   | set(self.cache_misses))},
            }
        return {
            **fault,
            **overload,
            **cache,
            "accepted": self.accepted,
            "rejected": self.rejected,
            "completed": self.n_completed,
            "violations": self.violations,
            "truncated": self.truncated,
            "p50_s": self.p(50),
            "p95_s": self.p(95),
            "p99_s": self.p(99),
            "batch_p50_s": self.batch_p(50),
            "batch_p95_s": self.batch_p(95),
            "batch_p99_s": self.batch_p(99),
            **{f"batch_p95_{k}": self.batch_p(95, k)
               for k in sorted(self.tier_batch_latencies)},
            **{f"dispatched_{k}": v for k, v in sorted(self.dispatched.items())},
            **{f"completed_{k}": v for k, v in sorted(self.per_device.items())},
        }


# Back-compat names: the three seed-era records are now literally the same
# object so engine/simulator/calibrator can no longer diverge.
DispatchStats = Telemetry
EngineStats = Telemetry
SimResult = Telemetry
