"""SLO-aware admission control: price a rejection against a predicted miss.

The paper's deployment-cost formula (Eq. 12) makes *accepted concurrency
per node* the quantity that cuts cost — which makes overload the worst
regime the system has: a query that queues past its deadline consumes a
queue slot, a batch slot, and device seconds, and still returns an error.
``AdmissionController`` closes that hole at the only cheap place to close
it: arrival.  ``QueueManager.dispatch`` consults it after the cache tier
(hits are free and always served) and before policy dispatch, and a query
that is predictably late is rejected with a structured
``ServeError(kind="admission")`` instead of being enqueued to die.

Two mechanisms, both deterministic and stateless per decision:

* **Backpressure watermarks** — a tier only *accepts new* work while its
  backlog (queued + in-flight, the paper's ``C``) is under
  ``watermark x depth`` slots; under brownout shedding the watermark
  tightens by ``shed_scale``.  A flash crowd therefore cannot grow queues
  to the hard depth bound: the band between watermark and depth stays
  reserved for retry/failover traffic, and when every tier is over its
  watermark (but slots remain) the arrival is rejected as ``admission``
  rather than queued into a guaranteed deadline miss.  Only when every
  tier is *hard* full does dispatch fall through to the classic
  ``no_capacity`` BUSY verdict.
* **SLO-violation pricing** — with the calibrated Eq. 12 fits
  (``estimator.LatencyFit``, the same objects ``PredictivePolicy`` ranks
  with), the controller predicts the completion latency of joining the
  best passing tier, ``fit.latency(backlog + 1)``.  If even the best tier
  predicts past the query's budget (``min(slo_s, deadline - now)``), then
  serving it has expected cost ``violation_cost`` and rejecting costs
  ``reject_cost``; the query is rejected when rejection is the cheaper
  outcome (``reject_cost < violation_cost``), and unconditionally under
  brownout *shedding*.  Tiers without a fit are optimistic: no prediction,
  no pricing rejection — calibration earns the right to reject.

Determinism contract: no wall clock, no RNG; everything is a pure function
of the queue state both drivers already agree on, so the engine-vs-DES
parity suites extend to admission counters counter-for-counter.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Sequence, Set

from repro_torch.core.health import SHEDDING

__all__ = ["AdmissionController"]


class AdmissionController:
    """Arrival-time admit/reject oracle for ``QueueManager.dispatch``.

    ``decide`` returns ``None`` to reject the query (``admission``
    verdict), or the set of tier names the query may be enqueued on.  An
    empty set means every tier is hard-full: dispatch falls through to its
    normal push loop and reports BUSY (``no_capacity``), keeping the two
    rejection reasons distinct in telemetry.
    """

    def __init__(self, fits: Optional[Dict[str, object]] = None,
                 slo_s: float = 1.0, reject_cost: float = 0.5,
                 violation_cost: float = 1.0, watermark: float = 1.0,
                 shed_scale: float = 0.5):
        if slo_s <= 0:
            raise ValueError("slo_s must be positive")
        if reject_cost < 0 or violation_cost <= 0:
            raise ValueError("costs must be nonnegative (violation positive)")
        if not 0.0 < watermark <= 1.0:
            raise ValueError("watermark must be in (0, 1]")
        if not 0.0 < shed_scale <= 1.0:
            raise ValueError("shed_scale must be in (0, 1]")
        self.fits: Dict[str, object] = dict(fits or {})
        self.slo_s = slo_s
        self.reject_cost = reject_cost
        self.violation_cost = violation_cost
        self.watermark = watermark
        self.shed_scale = shed_scale
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def update_fit(self, tier: str, fit) -> None:
        """Install/replace a tier's calibrated fit (online recalibration)."""
        with self._lock:
            self.fits[tier] = fit

    def watermark_slots(self, depth: int, stage: str = "normal") -> int:
        """Accepting-new-work slot bound for a tier of ``depth``: floor of
        the (stage-scaled) watermark fraction, at least 1 for any usable
        tier, never above the hard depth."""
        w = self.watermark * (self.shed_scale if stage == SHEDDING else 1.0)
        return min(int(depth), max(1, int(math.floor(depth * w + 1e-9))))

    def decide(self, query, tiers: Sequence, qm, now: float,
               stage: str = "normal") -> Optional[Set[str]]:
        """Admit/reject ``query`` against the live queue state.

        Returns ``None`` (reject as ``admission``) or the set of passing
        tier names (possibly empty — see class docstring).
        """
        from repro_torch.core.routing import dispatchable  # cycle-free at call time

        passing = []
        hard_free = False
        for t in dispatchable(tiers):
            q = qm.queues.get(t.name)
            if q is None:
                continue
            backlog = len(q)
            if backlog < q.depth:
                hard_free = True
            if backlog < self.watermark_slots(q.depth, stage):
                passing.append((t.name, backlog))
        if not passing:
            # over every watermark: reject (backpressure) while hard slots
            # remain; once nothing is even hard-free, let dispatch report
            # the classic no_capacity BUSY instead
            return None if hard_free else set()

        budget = self.slo_s
        if query is not None and getattr(query, "deadline", None) is not None:
            budget = min(budget, float(query.deadline) - float(now))
        with self._lock:
            best: Optional[float] = None
            unknown = False
            for name, backlog in passing:
                fit = self.fits.get(name)
                if fit is None:
                    unknown = True
                    break
                pred = float(fit.latency(backlog + 1))
                best = pred if best is None else min(best, pred)
            reject_cheaper = self.reject_cost < self.violation_cost
        if not unknown and best is not None and best > budget + 1e-12:
            # predictably late everywhere it could go: serving costs an
            # expected SLO violation, rejecting costs reject_cost
            if stage == SHEDDING or reject_cheaper:
                return None
        return {name for name, _ in passing}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"AdmissionController(slo_s={self.slo_s}, "
                f"reject_cost={self.reject_cost}, "
                f"watermark={self.watermark}, fits={sorted(self.fits)})")
