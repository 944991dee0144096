"""Per-tier health state: a deterministic, clock-free circuit breaker.

WindVE's deployment-cost argument (Eq. 12) assumes every provisioned tier
keeps serving; production traffic guarantees the opposite.  A tier whose
backend has started failing (crashed worker pool, stalled device, network
partition to a remote mesh) must be *routed around*, not hammered: every
query dispatched into a dead tier's queue is a client future that either
burns a retry attempt or times out against its deadline.

``CircuitBreaker`` is the standard three-state machine, shaped for the
shared scheduling core:

* **closed** — healthy.  Consecutive backend failures (``record_failure``)
  and a service-latency EWMA crossing ``latency_trip_s`` (a *stall* is a
  failure that never raises) both count toward a trip.
* **open** — tripped.  :func:`repro_torch.core.routing.dispatchable` filters the
  tier out, so all four dispatch policies transparently route around it
  (exactly like cache tiers are filtered — the topology list is unchanged,
  only the candidate set shrinks).  Queries already queued on the tier are
  still drained by its workers: the breaker gates *admission*, not drain.
* **half-open** — after ``cooldown_s`` the tier becomes dispatchable again
  and the next completed batch is the probe: success closes the breaker
  (recovery), failure re-opens it for another cooldown.

Determinism contract (same as the cache tier): the breaker never reads a
wall clock.  Callers pass ``now`` — the threaded engine passes
``time.monotonic()``, the DES passes simulated time — and the internal
clock is monotone (``max`` of everything seen), so a seeded DES run replays
the identical trip/recover sequence.  Thread-safe for the engine.

``BrownoutController`` is the second health machine here: a three-stage
*overload* controller (normal -> degraded -> shedding) driven by a
utilization EWMA sampled at dispatch time.  Where the breaker reacts to a
tier *failing*, brownout reacts to the whole topology *saturating* — and
sheds quality before the admission controller sheds queries.  Same
determinism contract: no wall clock, EWMA updates are keyed to dispatch
events (identical in both drivers under the parity suites' pinned bursts),
so a seeded DES run replays the identical stage sequence.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

# brownout stages, in escalation order
NORMAL = "normal"
DEGRADED = "degraded"
SHEDDING = "shedding"
_STAGES = (NORMAL, DEGRADED, SHEDDING)


class CircuitBreaker:
    """Trip on consecutive failures or a latency-EWMA stall; recover via a
    half-open probe.  Attach one per device tier (``TierSpec.breaker``)."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 1.0,
                 latency_trip_s: Optional[float] = None,
                 ewma_alpha: float = 0.3):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown_s <= 0:
            raise ValueError("cooldown_s must be positive")
        if latency_trip_s is not None and latency_trip_s <= 0:
            raise ValueError("latency_trip_s must be positive when set")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.latency_trip_s = latency_trip_s
        self.ewma_alpha = ewma_alpha
        self._lock = threading.Lock()
        self._init_state()

    def _init_state(self) -> None:
        self.state = CLOSED
        self.consecutive_failures = 0
        self.latency_ewma_s: Optional[float] = None
        self.trips = 0
        self.recoveries = 0
        self.last_trip_reason: Optional[str] = None
        self._open_until = 0.0
        self._now = 0.0

    # ------------------------------------------------------------------
    @property
    def dispatchable(self) -> bool:
        """May new work be routed here?  Open == no; half-open == yes (the
        probe); callers must ``tick(now)`` first so open -> half-open
        transitions happen on the driver's clock, not a hidden one."""
        with self._lock:
            return self.state != OPEN

    def tick(self, now: float) -> str:
        """Advance the breaker's clock (monotone).  An open breaker whose
        cooldown has elapsed transitions to half-open — the next dispatch
        becomes the recovery probe.  Returns the post-tick state."""
        with self._lock:
            self._now = max(self._now, now)
            if self.state == OPEN and self._now >= self._open_until:
                self.state = HALF_OPEN
            return self.state

    def _trip(self, reason: str) -> None:
        self.state = OPEN
        self.trips += 1
        self.last_trip_reason = reason
        self.consecutive_failures = 0
        self._open_until = self._now + self.cooldown_s

    def record_success(self, latency_s: float, now: float) -> None:
        """One completed batch.  Resets the failure streak; in half-open
        this is the probe succeeding (recovery).  A closed breaker with
        ``latency_trip_s`` set trips when the latency EWMA crosses it —
        the tier is *stalling*, which a raise-based detector never sees."""
        with self._lock:
            self._now = max(self._now, now)
            self.consecutive_failures = 0
            if self.state == HALF_OPEN:
                self.state = CLOSED
                self.recoveries += 1
                # the stale pre-trip EWMA must not instantly re-trip a
                # freshly recovered tier: restart it from the probe
                self.latency_ewma_s = float(latency_s)
                return
            a = self.ewma_alpha
            self.latency_ewma_s = float(latency_s) if \
                self.latency_ewma_s is None else \
                a * float(latency_s) + (1.0 - a) * self.latency_ewma_s
            if (self.state == CLOSED and self.latency_trip_s is not None
                    and self.latency_ewma_s > self.latency_trip_s):
                self._trip("latency")

    def record_failure(self, now: float) -> None:
        """One failed batch.  Half-open: the probe failed — re-open for
        another cooldown.  Closed: count toward the consecutive-failure
        threshold.  Open (in-flight work finishing after the trip): extend
        the cooldown from ``now``."""
        with self._lock:
            self._now = max(self._now, now)
            if self.state == HALF_OPEN:
                self._trip("probe-failure")
            elif self.state == OPEN:
                self._open_until = max(self._open_until,
                                       self._now + self.cooldown_s)
            else:
                self.consecutive_failures += 1
                if self.consecutive_failures >= self.failure_threshold:
                    self._trip("failures")

    def reset(self) -> None:
        """Fresh closed breaker (counters included) — one DES run's state."""
        with self._lock:
            self._init_state()

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "latency_ewma_s": self.latency_ewma_s,
                "trips": self.trips,
                "recoveries": self.recoveries,
                "last_trip_reason": self.last_trip_reason,
            }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"CircuitBreaker(state={self.state!r}, trips={self.trips}, "
                f"recoveries={self.recoveries})")


class BrownoutController:
    """Three-stage overload controller: shed *quality* before shedding
    queries.

    ``QueueManager.dispatch`` feeds every arrival's topology utilization
    (queued + in-flight over total calibrated depth) into ``observe``; the
    EWMA of those samples drives the stage machine:

    * **normal** — EWMA below ``degraded_at``: no behaviour change.
    * **degraded** — EWMA crossed ``degraded_at``: candidate tiers are
      re-ranked to prefer the quantized (W8A8/int8) tier at equal backlog
      (``reorder``) and effective deadlines are tightened by
      ``deadline_scale`` (``tighten``) so queued work that cannot finish in
      time expires early instead of burning device time late.  Cache tiers
      are consulted *before* brownout in dispatch, so repeat-heavy traffic
      keeps being served from cache for free at every stage.
    * **shedding** — EWMA crossed ``shedding_at``: everything above, plus
      the admission controller switches to its shedding watermark and
      rejects any query its fits predict late (see
      :class:`repro_torch.core.admission.AdmissionController`).

    De-escalation applies ``hysteresis``: the EWMA must fall below the
    stage's entry threshold minus the hysteresis band before the controller
    steps down, so a flapping load signal does not flap the stage.

    Clock-free like :class:`CircuitBreaker`: ``now`` is only tracked for
    the snapshot/tighten math, never read from a wall clock, and the EWMA
    advances on dispatch events only — so the DES replays a seeded stage
    sequence deterministically and the pinned-GIL parity bursts see the
    identical transitions in the threaded engine.
    """

    def __init__(self, degraded_at: float = 0.7, shedding_at: float = 0.9,
                 ewma_alpha: float = 0.3, hysteresis: float = 0.1,
                 deadline_scale: float = 0.5):
        if not 0.0 < degraded_at < shedding_at:
            raise ValueError("need 0 < degraded_at < shedding_at")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if hysteresis < 0.0:
            raise ValueError("hysteresis must be >= 0")
        if not 0.0 < deadline_scale <= 1.0:
            raise ValueError("deadline_scale must be in (0, 1]")
        self.degraded_at = degraded_at
        self.shedding_at = shedding_at
        self.ewma_alpha = ewma_alpha
        self.hysteresis = hysteresis
        self.deadline_scale = deadline_scale
        self._lock = threading.Lock()
        self._init_state()

    def _init_state(self) -> None:
        self.stage = NORMAL
        self.utilization_ewma: Optional[float] = None
        self.transitions = 0

    # ------------------------------------------------------------------
    def observe(self, utilization: float, now: float = 0.0) -> str:
        """Fold one dispatch-time utilization sample into the EWMA and
        return the (possibly new) stage.  Escalation is immediate on the
        updated EWMA; de-escalation waits out the hysteresis band."""
        with self._lock:
            x = max(0.0, float(utilization))
            a = self.ewma_alpha
            self.utilization_ewma = x if self.utilization_ewma is None \
                else a * x + (1.0 - a) * self.utilization_ewma
            u = self.utilization_ewma
            if u >= self.shedding_at:
                target = SHEDDING
            elif u >= self.degraded_at:
                target = DEGRADED
            else:
                target = NORMAL
            cur = _STAGES.index(self.stage)
            new = _STAGES.index(target)
            if new < cur:
                # stepping down: require clearance below the *current*
                # stage's entry threshold by the hysteresis band
                entry = self.shedding_at if self.stage == SHEDDING \
                    else self.degraded_at
                if u >= entry - self.hysteresis:
                    return self.stage
            if target != self.stage:
                self.stage = target
                self.transitions += 1
            return self.stage

    def tighten(self, deadline: Optional[float], now: float) -> Optional[float]:
        """Degraded/shedding deadline tightening: scale the *remaining*
        budget by ``deadline_scale`` so predictably-late work expires in
        the queue early.  Identity in the normal stage or without a
        deadline."""
        with self._lock:
            if deadline is None or self.stage == NORMAL:
                return deadline
            remaining = max(0.0, float(deadline) - float(now))
            return float(now) + remaining * self.deadline_scale

    def reorder(self, names: Sequence[str], qm) -> Sequence[str]:
        """Degraded/shedding candidate re-rank: stable-sort the policy's
        candidate tiers by backlog, breaking ties in favour of quantized
        tiers — at equal backlog the cheap W8A8 tier absorbs the overload
        first.  Identity in the normal stage (the policy's order stands)."""
        with self._lock:
            if self.stage == NORMAL:
                return names
        spec = {t.name: t for t in qm.tiers}
        return sorted(
            names,
            key=lambda n: (len(qm.queues[n]) if n in qm.queues else 0,
                           0 if getattr(spec.get(n), "quantized", False)
                           else 1))

    def reset(self) -> None:
        """Fresh normal-stage controller — one DES run's state."""
        with self._lock:
            self._init_state()

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "stage": self.stage,
                "utilization_ewma": self.utilization_ewma,
                "transitions": self.transitions,
            }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"BrownoutController(stage={self.stage!r}, "
                f"ewma={self.utilization_ewma}, "
                f"transitions={self.transitions})")
