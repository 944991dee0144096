"""The scheduling core: N device tiers x pluggable dispatch policies.

The paper's Algorithm 1 is a cascade over an *ordered list of device tiers*
(main NPU queue, then the auxiliary CPU queue).  The seed hardcoded exactly
two string-keyed queues in three divergent places (threaded engine, DES,
calibrator monkey-patch); this module is the single implementation they all
drive now:

* ``TierSpec``       — one device pool: name, queue depth (C^max), optional
                       engine backend / DES latency model, batch and worker
                       limits.  A topology is just a list of these.
* ``DispatchPolicy`` — orders the tiers a query may enter.  ``CascadePolicy``
                       is paper-exact Algorithm 1 generalized to N tiers;
                       ``LengthAwarePolicy`` pins long queries to the fast
                       tier(s) (§5.4: CPU concurrency collapses with query
                       length); ``LeastLoadedPolicy`` balances by free share.
* ``QueueManager``   — bounded per-tier FIFOs + atomic policy dispatch +
                       shared :class:`~repro_torch.core.telemetry.Telemetry`.

Queue depths are the SLO contract: depth == the largest concurrency whose
processing latency still meets the SLO (estimated by
``repro_torch.core.estimator``).  Thread-safe; the real engine (windve.py) drives
it from a request thread while worker threads drain it, and the DES
(simulator.py) drives it single-threaded.

The legacy two-queue constructor ``QueueManager(npu_depth, cpu_depth,
heter_enable=...)`` still works and builds the equivalent 2-tier cascade.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, replace as _dc_replace
from typing import (Any, Callable, Deque, Dict, Iterable, List, Optional,
                    Sequence, Tuple, Union)

from repro_torch.core.health import CLOSED as BREAKER_CLOSED
from repro_torch.core.health import NORMAL as BROWNOUT_NORMAL
from repro_torch.core.health import OPEN as BREAKER_OPEN
from repro_torch.core.telemetry import Telemetry

NPU = "NPU"
CPU = "CPU"
BUSY = "BUSY"
# dispatch verdict for a query already past its deadline on arrival (or on a
# retry re-dispatch): it never enters a queue and never reaches a device
EXPIRED = "EXPIRED"
# dispatch verdict for a query the admission controller turned away (priced
# as a predictable SLO miss, or over every tier's backpressure watermark):
# rejected at arrival, it never occupies a queue slot
ADMISSION = "ADMISSION"
# pseudo-tier key for deadline misses detected at dispatch time (the query
# was never queued on any tier, so no tier owns the miss)
ARRIVAL = "arrival"


class ServeError(RuntimeError):
    """Structured terminal serving failure — what a client future carries
    instead of a raw backend traceback.

    ``kind``: ``"backend_error"`` (every retry attempt failed),
    ``"deadline"`` (see :class:`DeadlineExceeded`), ``"worker_death"`` (the
    tier's last worker thread died with this query stranded in its queue),
    ``"no_capacity"`` (re-dispatch after a failure found every surviving
    tier full), ``"admission"`` (the admission controller shed the query —
    at arrival it is a rejection, not a terminal serving failure; on a
    retry re-dispatch it is terminal).  ``attempts`` is how many
    re-dispatches were burned and ``cause`` the last underlying exception
    (None for deadline misses).
    """

    def __init__(self, kind: str, tier: Optional[str] = None,
                 qid: Optional[int] = None, attempts: int = 0,
                 cause: Optional[BaseException] = None):
        self.kind = kind
        self.tier = tier
        self.qid = qid
        self.attempts = attempts
        self.cause = cause
        msg = f"{kind} (tier={tier}, qid={qid}, attempts={attempts})"
        if cause is not None:
            msg += f": {cause!r}"
        super().__init__(msg)


class DeadlineExceeded(ServeError):
    """The query's absolute deadline passed before it could be served —
    while queued (the sweep expired it), at dispatch (it arrived dead), or
    between retry attempts."""

    def __init__(self, tier: Optional[str] = None, qid: Optional[int] = None,
                 attempts: int = 0):
        super().__init__("deadline", tier=tier, qid=qid, attempts=attempts)


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded re-dispatch of queries from a failed batch.

    A failed batch's queries go back through ``QueueManager.dispatch`` (the
    normal policy path — so survivors route to whatever healthy tier the
    policy picks), each re-dispatch burning one of ``max_retries`` attempts
    carried on ``Query.attempts``.  ``backoff(attempt)`` is the exponential
    pause before attempt N (1-based): ``backoff_s * backoff_factor**(N-1)``
    — the DES prices it as simulated delay, the engine sleeps it in the
    failed tier's worker (the tier that just failed is the one that waits).
    """

    max_retries: int = 2
    backoff_s: float = 0.0
    backoff_factor: float = 2.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_s < 0:
            raise ValueError("backoff_s must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")

    def backoff(self, attempt: int) -> float:
        if attempt < 1:
            raise ValueError("attempt is 1-based")
        return self.backoff_s * self.backoff_factor ** (attempt - 1)


@dataclass
class Query:
    qid: int
    payload: Any = None          # token ids / text
    length: int = 75             # paper default query length (tokens)
    arrival_t: float = 0.0
    # filled by the system:
    device: Optional[str] = None
    start_t: float = 0.0
    done_t: float = 0.0
    emb: Any = None              # filled by a cache-tier hit at dispatch
    # fault tolerance: absolute deadline on the driver's clock (monotonic /
    # sim time; None = no deadline) and the retry attempts burned so far
    deadline: Optional[float] = None
    attempts: int = 0

    @property
    def e2e_latency(self) -> float:
        return self.done_t - self.arrival_t

    def expired(self, now: float) -> bool:
        """Dead at ``now``?  The deadline is the first dead instant
        (``now >= deadline``), so an expiry swept exactly at the deadline
        behaves identically whichever same-instant event runs first."""
        return self.deadline is not None and now >= self.deadline


class BoundedQueue:
    """FIFO with a hard depth bound == the device's C^max."""

    def __init__(self, depth: int):
        if depth < 0:
            raise ValueError("queue depth must be >= 0")
        self.depth = depth
        self._q: Deque[Query] = deque()
        self._lock = threading.Lock()
        # paper semantics: queue length counts queued AND in-flight queries —
        # C^max bounds *concurrency*, not just waiting items.
        self._in_flight = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._q) + self._in_flight

    @property
    def is_full(self) -> bool:
        return len(self) >= self.depth

    def push(self, q: Query) -> bool:
        with self._lock:
            if len(self._q) + self._in_flight >= self.depth:
                return False
            self._q.append(q)
            return True

    def pop_batch(self, max_batch: int,
                  bucket_fn: Optional[Callable[[Query], Any]] = None
                  ) -> List[Query]:
        """Dequeue up to max_batch queries and mark them in-flight.

        With a ``bucket_fn`` the batch is *length-aware*: the oldest queued
        query picks the bucket (strict FIFO decides who is served next), then
        only queries in that same bucket join the batch — so one execution
        pads to the bucket's shape, not to the longest straggler.  Queries in
        other buckets keep their arrival order and wait for a later pop.
        """
        out: List[Query] = []
        with self._lock:
            if bucket_fn is None:
                while self._q and len(out) < max_batch:
                    out.append(self._q.popleft())
            elif self._q:
                key = bucket_fn(self._q[0])
                rest: Deque[Query] = deque()
                while self._q:
                    q = self._q.popleft()
                    if len(out) < max_batch and bucket_fn(q) == key:
                        out.append(q)
                    else:
                        rest.append(q)
                self._q = rest
            self._in_flight += len(out)
        return out

    def expire(self, now: float) -> List[Query]:
        """Remove and return every *queued* query whose deadline has passed
        at ``now`` (in-flight work cannot be recalled).  The returned
        queries never count as in-flight — their slots free immediately."""
        dead: List[Query] = []
        with self._lock:
            if not self._q:
                return dead
            live: Deque[Query] = deque()
            for q in self._q:
                (dead if q.expired(now) else live).append(q)
            self._q = live
        return dead

    def finish(self, n: int) -> None:
        with self._lock:
            self._in_flight -= n
            assert self._in_flight >= 0


@dataclass
class TierSpec:
    """One device pool in the topology, in cascade-priority order.

    ``backend`` is what the threaded engine runs (``embed_batch``-capable);
    ``model`` is what the DES samples latencies from (a ``DeviceModel``).
    Either may be None when the spec is used by the other driver.
    ``max_batch`` defaults to the live queue depth; ``workers`` is the number
    of engine threads draining this tier (Algorithm 2's N instances).

    ``bucket_fn`` (optional, ``Query -> hashable``) makes this tier drain its
    queue in length buckets: each popped batch contains only queries whose
    bucket matches the oldest waiting query's (see
    ``BoundedQueue.pop_batch``).  Pair it with a shape-bucketed backend
    (``repro_torch.core.bucketing``) so intra-batch padding collapses to the
    bucket boundary.

    ``cache`` (optional, an ``repro_torch.core.cache.EmbeddingCache``) makes this
    a *zero-latency cache tier*: it holds no queue and no device —
    ``QueueManager.dispatch`` consults it before policy dispatch, a hit
    completes the query immediately, and the drivers admit computed
    embeddings back via ``QueueManager.admit``.  Cache tiers are invisible
    to ``DispatchPolicy.candidates`` (see :func:`dispatchable`): they have
    no queue depth to fill and no service curve to price.

    ``breaker`` (optional, a ``repro_torch.core.health.CircuitBreaker``) gives
    the tier health state: the drivers feed batch outcomes through
    ``QueueManager.tier_success`` / ``tier_failure`` and a tripped (open)
    breaker removes the tier from :func:`dispatchable`, so every policy
    transparently routes around it until its half-open probe recovers.

    ``quantized`` marks a reduced-precision (W8A8/int8) tier: under
    brownout degradation the candidate re-rank prefers quantized tiers at
    equal backlog — quality is shed before queries are (see
    ``repro_torch.core.health.BrownoutController.reorder``).  Inert otherwise.

    ``replica_of`` / ``host`` are replica identity, set by
    :func:`replicate` when this spec is one replica of a logical tier:
    ``replica_of`` names the logical tier and ``host`` the host index the
    replica's device group lives on.  The scheduler itself treats replicas
    as ordinary tiers (that is the point — each replica is an
    independently-failing capacity unit with its own queue, breaker,
    admission watermark, and service-curve fit); the identity fields exist
    so summaries and telemetry can roll per-replica counters back up to
    the logical tier (``replica_base``).
    """

    name: str
    depth: int
    backend: Any = None
    model: Any = None
    max_batch: Optional[int] = None
    workers: int = 1
    bucket_fn: Optional[Callable[[Query], Any]] = None
    cache: Any = None
    breaker: Any = None
    quantized: bool = False
    replica_of: Optional[str] = None
    host: int = 0


def device_tiers(tiers: Sequence[TierSpec]) -> List[TierSpec]:
    """The tiers that hold a bounded queue and a device: everything but the
    zero-latency cache tiers.  This is the *structural* set — queues and
    workers exist for these regardless of live health state."""
    return [t for t in tiers if t.cache is None]


def dispatchable(tiers: Sequence[TierSpec]) -> List[TierSpec]:
    """The tiers a policy may route a query into RIGHT NOW: device tiers
    (cache tiers are consulted by ``QueueManager.dispatch`` BEFORE the
    policy runs — a hit never reaches a device) whose circuit breaker, if
    any, is not open.  A tripped tier keeps its queue and workers — queued
    work still drains, cache hits still serve — but receives no new
    queries until its half-open probe succeeds, so every policy ranks over
    this filtered list and degrades around failures without knowing they
    exist.
    """
    return [t for t in tiers if t.cache is None and
            (t.breaker is None or t.breaker.dispatchable)]


# ---------------------------------------------------------------------------
# replicas: one logical tier expanded into hosts x replicas capacity units
# ---------------------------------------------------------------------------

def replica_name(base: str, host: int, replica: int) -> str:
    """Canonical replica tier name: ``NPU`` on host 1, replica 0 ->
    ``NPU@h1r0``.  Telemetry, fits, breakers, and watermarks all key by
    this name, so every per-tier mechanism is per-replica automatically."""
    return f"{base}@h{host}r{replica}"


def replica_base(name: str) -> str:
    """Logical tier a replica name belongs to (``NPU@h1r0`` -> ``NPU``);
    identity for non-replica names, so roll-ups are safe on any tier."""
    i = name.rfind("@h")
    return name[:i] if i > 0 else name


def replicate(spec: TierSpec, hosts: int = 1, replicas: int = 1, *,
              backend: Optional[Callable[[int, int], Any]] = None,
              model: Optional[Callable[[int, int], Any]] = None,
              breaker: Optional[Callable[[int, int], Any]] = None,
              ) -> List[TierSpec]:
    """Expand one logical tier into ``hosts * replicas`` first-class
    ``TierSpec``s (cascade order: host-major, replica-minor).

    Each replica must be an *independently-failing* capacity unit, so the
    stateful parts are built per replica through the optional factories
    (``(host, replica) -> instance``): a shared backend would serialize
    replicas on one device group, a shared breaker would quarantine all
    replicas when one host dies.  Fields with no factory are copied from
    ``spec`` (depth, max_batch, bucket_fn, quantized — per-replica policy
    knobs are a ``dataclasses.replace`` away).

    The degrade rule mirrors ``sharded_model``: ``replicate(spec, 1, 1)``
    returns ``[spec]`` UNCHANGED — same object, same name — so a 1x1
    topology is bitwise today's single-replica path (the factories are not
    consulted; the spec's own backend/model ARE the single replica).
    """
    if hosts < 1 or replicas < 1:
        raise ValueError(f"hosts and replicas must be >= 1, "
                         f"got {hosts}x{replicas}")
    if spec.cache is not None:
        raise ValueError("cache tiers hold no device group to replicate")
    if hosts == 1 and replicas == 1:
        return [spec]
    out: List[TierSpec] = []
    for h in range(hosts):
        for r in range(replicas):
            out.append(_dc_replace(
                spec,
                name=replica_name(spec.name, h, r),
                backend=backend(h, r) if backend is not None else spec.backend,
                model=model(h, r) if model is not None else spec.model,
                breaker=breaker(h, r) if breaker is not None else spec.breaker,
                replica_of=spec.name,
                host=h))
    return out


@dataclass(frozen=True)
class ReplicaSet:
    """The replica view of one logical tier: the expanded specs plus the
    grouping lens (per-host, per-name) that serve summaries and telemetry
    roll-ups look through.  ``build`` is :func:`replicate` + bookkeeping;
    at 1x1 the set holds the original spec under its original name."""

    base: str
    hosts: int
    replicas: int
    specs: Tuple[TierSpec, ...]

    @classmethod
    def build(cls, spec: TierSpec, hosts: int = 1, replicas: int = 1,
              **factories: Any) -> "ReplicaSet":
        return cls(spec.name, hosts, replicas,
                   tuple(replicate(spec, hosts, replicas, **factories)))

    @property
    def names(self) -> List[str]:
        return [t.name for t in self.specs]

    def on_host(self, host: int) -> List[TierSpec]:
        return [t for t in self.specs if t.host == host]

    def __iter__(self):
        return iter(self.specs)

    def __len__(self) -> int:
        return len(self.specs)


class DispatchPolicy:
    """Orders the tiers a query may enter; first with free capacity wins.

    ``QueueManager.dispatch`` holds its lock while trying the candidates in
    order, so a policy only decides *ordering* — admission stays atomic.
    """

    name = "policy"

    def candidates(self, query: Query, tiers: Sequence[TierSpec],
                   qm: "QueueManager") -> Iterable[str]:
        raise NotImplementedError


class CascadePolicy(DispatchPolicy):
    """Paper-exact Algorithm 1, generalized: overflow down the tier list."""

    name = "cascade"

    def candidates(self, query, tiers, qm):
        return [t.name for t in dispatchable(tiers)]


class LengthAwarePolicy(DispatchPolicy):
    """§5.4-informed: long queries only fit the fast tier(s).

    Fig. 5 shows the CPU pool's additional concurrency collapsing to 0 by
    query length 500 at the 1 s SLO — a long query offloaded to a slow tier
    is a guaranteed SLO violation, so spend slow-tier slots on short queries
    only and cascade long ones over the first ``fast_tiers`` entries.
    """

    name = "length-aware"

    def __init__(self, long_threshold: int = 300, fast_tiers: int = 1):
        if long_threshold <= 0:
            raise ValueError("long_threshold must be positive")
        if fast_tiers < 1:
            raise ValueError("need at least one fast tier")
        self.long_threshold = long_threshold
        self.fast_tiers = fast_tiers

    @classmethod
    def from_bucket_depths(cls, bucket_depths: Dict[int, int],
                           fast_tiers: int = 1) -> "LengthAwarePolicy":
        """Derive the long-query threshold from measured per-bucket depths.

        ``bucket_depths`` maps a seq-length bucket to its SLO-safe slow-tier
        depth (one Eq. 12 fit per bucket — see
        ``repro_torch.core.estimator.estimate_depth_per_bucket``).  Queries round
        UP into their bucket (``bucketing.bucket_length``), so the first
        bucket whose depth collapsed to 0 (the paper's Eq. 11 "CPU cannot
        be used" case, observed per bucket instead of assumed at a fixed
        length) poisons every length ABOVE the previous live bucket — the
        threshold is that lower boundary, not the dead bucket's own padded
        length.  If every profiled bucket still has capacity, anything
        beyond the profiled range counts as long — unprofiled lengths must
        not be routed onto the slow tier on faith.
        """
        if not bucket_depths:
            raise ValueError("need at least one bucket depth")
        buckets = sorted(bucket_depths)
        dead = [b for b in buckets if bucket_depths[b] <= 0]
        if not dead:
            threshold = buckets[-1] + 1
        else:
            prev = [b for b in buckets if b < dead[0]]
            # smallest profiled bucket dead -> every length pads into a
            # dead bucket, so every query is long (threshold must stay > 0)
            threshold = prev[-1] + 1 if prev else 1
        return cls(long_threshold=threshold, fast_tiers=fast_tiers)

    def candidates(self, query, tiers, qm):
        # fast_tiers counts REAL device tiers: a cache tier at the head of
        # the topology must not eat the fast slot(s)
        real = dispatchable(tiers)
        if query.length >= self.long_threshold:
            return [t.name for t in real[:self.fast_tiers]]
        return [t.name for t in real]


class LeastLoadedPolicy(DispatchPolicy):
    """Route to the tier with the largest free share (ties: cascade order).

    Unlike the cascade this spreads sub-peak load across tiers, trading the
    paper's strict fast-tier priority for drain-queue headroom everywhere.
    """

    name = "least-loaded"

    def candidates(self, query, tiers, qm):
        real = dispatchable(tiers)

        def free_share(t: TierSpec) -> float:
            d = qm.depth(t.name)
            return (d - len(qm.queues[t.name])) / d if d > 0 else -1.0

        order = sorted(range(len(real)),
                       key=lambda i: (-free_share(real[i]), i))
        return [real[i].name for i in order]


class PredictivePolicy(DispatchPolicy):
    """Route to the tier with the minimal *predicted completion time*.

    The paper's Eq. 12 says tier service latency is (near-)linear in
    concurrency; the cascade ignores that and fills the fast tier to its
    depth before spilling, so at peak every fast-tier query pays the
    full-depth latency while slow-tier slots idle at t(1).  This policy
    prices each candidate tier with its calibrated service curve at the
    backlog the query would join:

        predicted(tier) = fit_tier.latency(backlog(tier) + 1)

    where backlog counts queued + in-flight queries (the paper's C
    semantics) and ``fit`` is anything with a ``latency(concurrency)``
    method — an ``estimator.LatencyFit`` (offline calibration), a
    ``simulator.DeviceModel``/``FanOutModel`` (the DES), or whatever the
    online calibrator refits from live traffic
    (``adaptive.attach(..., policy=...)`` keeps the fits fresh through the
    engine's batch-completion hook).

    ``bucket_fn`` (optional, ``Query -> bucket``) selects per-bucket fits
    registered via ``update(tier, fit, bucket=...)`` — a bucketed CPU tier
    serves a 16-token bucket several times faster than a 96-token one, so
    one global line misprices long queries (§5.4).  Lookup falls back from
    ``(tier, bucket)`` to the tier-level fit; tiers with no fit at all keep
    their cascade order BEHIND every fitted tier, so an uncalibrated
    topology degrades to Algorithm 1 instead of routing blind.
    """

    name = "predictive"

    def __init__(self, fits: Optional[Dict[str, Any]] = None,
                 bucket_fn: Optional[Callable[[Query], Any]] = None):
        self.bucket_fn = bucket_fn
        self._fits: Dict[Any, Any] = dict(fits or {})
        self._fit_lock = threading.Lock()

    def update(self, tier: str, fit: Any, bucket: Any = None) -> None:
        """Install/replace the service-curve estimate for a tier (or one of
        its length buckets).  Called by the online calibrator on refit."""
        with self._fit_lock:
            self._fits[tier if bucket is None else (tier, bucket)] = fit

    def fit_for(self, tier: str, query: Optional[Query] = None) -> Any:
        with self._fit_lock:
            if query is not None and self.bucket_fn is not None:
                f = self._fits.get((tier, self.bucket_fn(query)))
                if f is not None:
                    return f
            return self._fits.get(tier)

    def predicted_completion_s(self, tier: str, query: Query,
                               qm: "QueueManager") -> Optional[float]:
        """Service latency this query would see joining ``tier`` now, per
        the tier's calibrated curve; None when the tier has no fit yet."""
        fit = self.fit_for(tier, query)
        if fit is None:
            return None
        return float(fit.latency(len(qm.queues[tier]) + 1))

    def candidates(self, query, tiers, qm):
        # cache tiers never appear as candidates: a hit completed at
        # dispatch (predicted completion ~0 needs no pricing) and a MISS by
        # definition cannot be served there — only device tiers hold a
        # backlog for the fits to price
        real = dispatchable(tiers)

        def key(i: int):
            p = self.predicted_completion_s(real[i].name, query, qm)
            # fitted tiers first, cheapest predicted completion wins;
            # unfitted tiers trail in cascade order (graceful degrade)
            return (0, p, i) if p is not None else (1, 0.0, i)

        return [real[i].name for i in sorted(range(len(real)), key=key)]


class RoundRobinPolicy(DispatchPolicy):
    """Replica-oblivious baseline: rotate the dispatchable tier list one
    position per dispatch, blind to backlog, service curves, or replica
    identity.  This is the strawman front-end router the multi-replica A/B
    (``benchmarks/multihost_microbench.py``) measures ``PredictivePolicy``
    against — same hardware, no per-replica pricing.  Deterministic: the
    rotation counter advances exactly once per ``candidates`` call, so
    both drivers see the same sequence for the same arrival order."""

    name = "round-robin"

    def __init__(self):
        self._n = 0
        self._rr_lock = threading.Lock()

    def candidates(self, query, tiers, qm):
        real = dispatchable(tiers)
        if not real:
            return []
        with self._rr_lock:
            k = self._n % len(real)
            self._n += 1
        return [t.name for t in real[k:] + real[:k]]


class QueueManager:
    """Policy dispatch over N bounded tier queues (Algorithm 1 core).

    New-style: ``QueueManager([TierSpec(...), ...], policy=CascadePolicy())``.
    Legacy:    ``QueueManager(npu_depth, cpu_depth, heter_enable=...)`` —
    builds the paper's 2-tier NPU/CPU cascade.
    """

    def __init__(self, tiers: Union[int, Sequence[TierSpec], None] = None,
                 cpu_depth: int = 0, heter_enable: bool = True, *,
                 npu_depth: Optional[int] = None,
                 policy: Optional[DispatchPolicy] = None,
                 stats: Optional[Telemetry] = None,
                 admission: Any = None,
                 brownout: Any = None):
        if npu_depth is not None:           # legacy keyword form
            tiers = npu_depth
        if isinstance(tiers, int):          # legacy positional form
            specs = [TierSpec(NPU, tiers)]
            if heter_enable and cpu_depth > 0:
                specs.append(TierSpec(CPU, cpu_depth))
            tiers = specs
        if not tiers:
            raise ValueError("need at least one tier")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        self.tiers: List[TierSpec] = list(tiers)
        # zero-latency cache tiers are consulted before policy dispatch and
        # hold no bounded queue (a hit never occupies a concurrency slot)
        self.cache_tiers: List[TierSpec] = [t for t in self.tiers
                                            if t.cache is not None]
        if not device_tiers(self.tiers):
            raise ValueError("need at least one non-cache tier")
        self.policy: DispatchPolicy = policy or CascadePolicy()
        # queues exist per DEVICE tier, tripped or not: a breaker gates
        # admission, never the existence of the tier's queue/workers
        self.queues: Dict[str, BoundedQueue] = {
            t.name: BoundedQueue(t.depth) for t in device_tiers(self.tiers)}
        self.stats: Telemetry = stats if stats is not None else Telemetry()
        # overload control (both optional): an
        # ``repro_torch.core.admission.AdmissionController`` consulted after the
        # cache tiers and before policy dispatch, and a
        # ``repro_torch.core.health.BrownoutController`` whose utilization EWMA
        # is fed every arrival and whose stage reorders candidates /
        # tightens deadlines under overload
        self.admission = admission
        self.brownout = brownout
        self._brownout_stage = BROWNOUT_NORMAL
        # driver hook: called (outside the queue lock) for every queued
        # query the deadline sweep expires — the engine fails its future
        # with DeadlineExceeded; the DES needs no action beyond telemetry
        self.on_expire: Optional[Callable[[Query], None]] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    @property
    def heter_enable(self) -> bool:
        """Legacy flag: True iff an auxiliary tier exists."""
        return len(self.tiers) > 1

    def is_cache_tier(self, name: str) -> bool:
        return any(t.name == name for t in self.cache_tiers)

    def dispatch(self, query: Query, now: Optional[float] = None) -> str:
        """Route one query.  Returns the admitting tier's name, BUSY,
        EXPIRED (already past its deadline — it never enters a queue), or
        ADMISSION (shed by the admission controller at arrival).

        Cache tiers are consulted first, in topology order: an exact-match
        hit fills ``query.emb``, counts as a dispatch to (and completion
        responsibility of) the cache tier, and never touches a device queue
        — the driver must complete the query immediately (zero service
        time).  Misses record per-tier miss telemetry and fall through to
        overload control, then normal policy dispatch.  Cache hits are
        served at EVERY brownout stage and are never subject to admission:
        they cost nothing, which is exactly what an overloaded system
        wants to serve.  ``now`` defaults to ``query.arrival_t``
        (the lookup clock for cache staleness and the breaker clock under
        both drivers: monotonic / sim time); retry re-dispatch passes the
        current clock explicitly since ``arrival_t`` is then stale.
        """
        if now is None:
            now = query.arrival_t
        with self._lock:
            if query.expired(now):
                self.stats.record_deadline_miss(ARRIVAL)
                self.stats.record_rejection("expired")
                return EXPIRED
            # advance every breaker's clock: open tiers whose cooldown has
            # elapsed become half-open (dispatchable again) on THIS
            # driver's clock, so the recovery probe is deterministic
            for t in self.tiers:
                if t.breaker is not None:
                    t.breaker.tick(now)
            for ct in self.cache_tiers:
                entry = ct.cache.get(query, now=now)
                if entry is not None:
                    query.device = ct.name
                    query.emb = entry.value
                    self.stats.record_dispatch(ct.name)
                    self.stats.record_cache_hit(
                        ct.name, max(0.0, now - entry.t))
                    return ct.name
                self.stats.record_cache_miss(ct.name)
            stage = BROWNOUT_NORMAL
            if self.brownout is not None:
                stage = self.brownout.observe(self.utilization(), now)
                if stage != self._brownout_stage:
                    self.stats.record_brownout(stage)
                    self._brownout_stage = stage
                # degraded/shedding: tighten the remaining deadline budget
                # so queued work that cannot finish in time expires early
                query.deadline = self.brownout.tighten(query.deadline, now)
            allowed = None
            if self.admission is not None:
                allowed = self.admission.decide(
                    query, self.tiers, self, now, stage)
                if allowed is None:
                    self.stats.record_rejection("admission")
                    return ADMISSION
            names = self.policy.candidates(query, self.tiers, self)
            if self.brownout is not None:
                names = self.brownout.reorder(list(names), self)
            for name in names:
                if name not in self.queues:     # custom policies may emit
                    continue                    # cache-tier names: skip
                if allowed is not None and name not in allowed:
                    continue                    # over its watermark
                if self.queues[name].push(query):
                    query.device = name
                    self.stats.record_dispatch(name)
                    return name
            self.stats.record_busy()
            return BUSY

    def utilization(self) -> float:
        """Live load fraction: queued + in-flight over the dispatchable
        capacity (the paper's C summed over reachable tiers), clamped to
        [0, 1].  1.0 when no capacity is reachable — a fully-tripped
        topology IS overloaded.  The clamp matters: retry/failover
        re-dispatch onto a shrunken dispatchable set (a tripped tier keeps
        its in-flight work while leaving the denominator), or an online
        ``set_depth`` below the live backlog, can push the raw ratio past
        1.0 — a *fraction* above 1 would over-drive the brownout EWMA
        through its shedding threshold in a single sample."""
        cap = self.degraded_max_concurrency
        if cap <= 0:
            return 1.0
        load = sum(len(self.queues[t.name]) for t in dispatchable(self.tiers)
                   if t.name in self.queues)
        return max(0.0, min(1.0, load / cap))

    # -- fault-tolerance bridges (drivers -> breaker + telemetry) ----------
    def tier_success(self, device: str, service_s: float, now: float) -> None:
        """One completed batch on ``device``: feed the tier's breaker (if
        any) and record a half-open probe success as a recovery."""
        t = self.tier(device)
        if t.breaker is None:
            return
        before = t.breaker.state
        t.breaker.record_success(service_s, now)
        after = t.breaker.state
        if before != after:
            if after == BREAKER_CLOSED:
                self.stats.record_breaker_recovery(device)
            elif after == BREAKER_OPEN:    # latency-EWMA stall trip
                self.stats.record_breaker_trip(device)

    def tier_failure(self, device: str, now: float) -> None:
        """One failed batch on ``device``: count the backend error and feed
        the tier's breaker; a threshold crossing records the trip."""
        self.stats.record_backend_error(device)
        t = self.tier(device)
        if t.breaker is None:
            return
        before = t.breaker.state
        t.breaker.record_failure(now)
        if before != BREAKER_OPEN and t.breaker.state == BREAKER_OPEN:
            self.stats.record_breaker_trip(device)

    def sweep(self, device: str, now: float) -> List[Query]:
        """Expire overdue *queued* queries on one tier: each is removed
        from the queue (its slot frees immediately), counted as a
        ``deadline_miss`` against the tier, and handed to ``on_expire`` so
        the driver can fail its future.  The engine sweeps on every worker
        poll; the DES sweeps at exact per-query deadline events and before
        every batch formation — either way ``pop_batch`` never forms a
        batch from dead work."""
        if device not in self.queues:
            return []
        dead = self.queues[device].expire(now)
        for q in dead:
            self.stats.record_deadline_miss(device)
            if self.on_expire is not None:
                self.on_expire(q)
        return dead

    def tripped(self) -> List[str]:
        """Names of tiers currently removed from dispatch by their breaker."""
        return [t.name for t in device_tiers(self.tiers)
                if t.breaker is not None and not t.breaker.dispatchable]

    @property
    def degraded_max_concurrency(self) -> int:
        """sum of C^max over the tiers dispatch can reach *right now* —
        the live capacity the SLO contract actually has while breakers are
        open (``cost_model.degraded_capacity`` gives the closed form)."""
        return sum(self.queues[t.name].depth for t in dispatchable(self.tiers)
                   if t.name in self.queues)

    def admit(self, query: Query, value: Any = None) -> Optional[str]:
        """Admission hook: insert one computed embedding into the head
        cache tier (if any).  Drivers call this per completed query, BEFORE
        resolving its future — so any caller that observed a result can
        rely on the key being cached.  ``query.done_t`` timestamps the
        entry (the staleness clock under either driver).  Returns the
        admitting cache tier's name, or None when the topology has none."""
        for ct in self.cache_tiers:
            evicted = ct.cache.put(query, value, now=query.done_t)
            self.stats.record_cache_insert(ct.name, evicted)
            return ct.name
        return None

    def tier(self, name: str) -> TierSpec:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(name)

    def depth(self, device: str) -> int:
        return self.queues[device].depth if device in self.queues else 0

    def set_depth(self, device: str, depth: int) -> None:
        """Resize a tier's SLO contract (online re-calibration)."""
        if depth < 0:
            raise ValueError("queue depth must be >= 0")
        self.queues[device].depth = depth
        self.tier(device).depth = depth

    def max_batch(self, device: str) -> int:
        """Effective batch bound: the spec's max_batch or the live depth."""
        spec = self.tier(device)
        return spec.max_batch if spec.max_batch else \
            max(1, self.queues[device].depth)

    def pop_batch(self, device: str, now: Optional[float] = None
                  ) -> List[Query]:
        """Drain one batch from a tier, honouring its ``bucket_fn``.

        Both drivers (threaded engine, DES) form batches through this single
        entry point so batch composition cannot diverge between them.  With
        ``now`` set, overdue queued queries are swept out first (see
        :meth:`sweep`) — a batch never contains dead work.
        """
        if now is not None:
            self.sweep(device, now)
        return self.queues[device].pop_batch(self.max_batch(device),
                                             self.tier(device).bucket_fn)

    def reset(self, stats: Optional[Telemetry] = None) -> Telemetry:
        """Fresh queues (at current depths), empty caches, closed breakers
        + fresh telemetry — one DES run starts cold and deterministic."""
        with self._lock:
            self.queues = {t.name: BoundedQueue(self.depth(t.name) if
                                                t.name in self.queues else
                                                t.depth)
                           for t in device_tiers(self.tiers)}
            for ct in self.cache_tiers:
                ct.cache.clear()
            for t in self.tiers:
                if t.breaker is not None:
                    t.breaker.reset()
            if self.brownout is not None:
                self.brownout.reset()
            self._brownout_stage = BROWNOUT_NORMAL
            self.stats = stats if stats is not None else Telemetry()
        return self.stats

    @property
    def max_concurrency(self) -> int:
        """sum of C^max over tiers — the paper's headline metric."""
        return sum(q.depth for q in self.queues.values())
