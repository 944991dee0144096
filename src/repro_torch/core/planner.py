"""Failure-aware capacity planner: the calibrated DES as a sizing tool.

The paper's deployment-cost analysis (Eqs. 5-6) prices a topology from
closed forms; this module closes the remaining gap to *operations*: it
evaluates candidate deployments — tier/device counts, admission and
brownout settings, fault exposure — by actually running them in the
discrete-event simulator against realistic arrival traces (diurnal,
flash-crowd, MTTF outage schedules) and reduces each run to the numbers a
sizing decision needs:

* **SLO attainment** — fraction of OFFERED queries served within the SLO
  (rejections and deadline misses both count against it: a shed query is
  a query the deployment did not serve);
* **cost per million accepted queries** —
  :func:`repro_torch.core.cost_model.cost_per_million_queries` over the
  trace horizon, the unit-economics curve of a capacity-plan sweep.

The controllers under test are the REAL ones: a ``PlanArm`` carries the
same :class:`~repro_torch.core.admission.AdmissionController` /
:class:`~repro_torch.core.health.BrownoutController` objects the threaded
engine serves with, wired into the same ``QueueManager`` — the planner never
simulates a simplification of the system, it runs the system.

Typical use (the JAX package's ``benchmarks/capacity_plan_microbench.py``
runs the full sweep; the port has no twin of it yet)::

    tiers, fits = calibrated_tiers({"NPU": npu_model, "CPU": cpu_model},
                                   slo_s=1.0, quantized={"CPU"})
    arm = PlanArm("npu+cpu", tiers=tiers, price_per_s=10.5,
                  admission=AdmissionController(fits=fits, slo_s=1.0),
                  brownout=BrownoutController(), deadline_s=2.0)
    trace = flash_crowd_trace(40, base_rate=60, burst_mult=6,
                              burst_start=10, burst_len=10)
    point = evaluate(arm, trace, slo_s=1.0)
    point.slo_attainment, point.cost_per_m_accepted
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.cost_model import cost_per_million_queries
from repro_torch.core.estimator import LatencyFit, fit_from_model
from repro_torch.core.routing import DispatchPolicy, RetryPolicy, TierSpec
from repro_torch.core.simulator import ServingSimulator

__all__ = ["PlanArm", "PlanPoint", "calibrated_tiers", "evaluate", "sweep",
           "best"]


@dataclass(frozen=True)
class PlanArm:
    """One candidate deployment the planner prices.

    ``tiers`` is a live TierSpec list (models set — this runs in the DES);
    ``price_per_s`` the topology's all-in price rate (devices x unit
    price, the Eq. 5/6 numerator); the optional controllers/policies are
    the exact serving objects, reset per evaluation by ``qm.reset`` /
    ``FaultModel.reset`` so one arm can be evaluated against many traces.
    Evaluate one arm sequentially — the TierSpecs hold live queue state
    during a run.
    """

    name: str
    tiers: Sequence[TierSpec]
    price_per_s: float
    admission: Optional[object] = None
    brownout: Optional[object] = None
    policy: Optional[DispatchPolicy] = None
    retry: Optional[RetryPolicy] = None
    deadline_s: Optional[float] = None
    faults: Mapping[str, object] = field(default_factory=dict)

    def __post_init__(self):
        if self.price_per_s < 0:
            raise ValueError("price_per_s must be >= 0")
        if not self.tiers:
            raise ValueError("need at least one tier")


@dataclass(frozen=True)
class PlanPoint:
    """One (arm, trace) evaluation, reduced to sizing numbers."""

    arm: str
    trace: str
    horizon_s: float
    arrivals: int
    accepted: int            # delivered: arrivals - rejections - failures
    completed: int
    in_slo: int              # completions within the SLO
    slo_attainment: float    # in_slo / arrivals — offered-load attainment
    deadline_misses: int
    failed: int
    rejections: Mapping[str, int]
    brownout_transitions: Mapping[str, int]
    cost: float              # price_per_s * horizon_s
    cost_per_m_accepted: float

    def row(self) -> Dict[str, float]:
        """Flat record for a capacity-plan sweep's JSON file."""
        out = {
            "arm": self.arm,
            "trace": self.trace,
            "horizon_s": self.horizon_s,
            "arrivals": self.arrivals,
            "accepted": self.accepted,
            "completed": self.completed,
            "in_slo": self.in_slo,
            "slo_attainment": self.slo_attainment,
            "deadline_misses": self.deadline_misses,
            "failed": self.failed,
            "cost": self.cost,
            "cost_per_m_accepted": self.cost_per_m_accepted,
        }
        out.update({f"rejections_{k}": v
                    for k, v in sorted(self.rejections.items()) if v})
        out.update({f"brownout_to_{k}": v for k, v in
                    sorted(self.brownout_transitions.items())})
        return out


def calibrated_tiers(models: Mapping[str, object], slo_s: float,
                     quantized: Sequence[str] = (),
                     probe_points: Sequence[int] = (1, 4, 16, 64),
                     ) -> Tuple[List[TierSpec], Dict[str, LatencyFit]]:
    """SLO-calibrated topology from DES device models: each tier's depth is
    its Eq. 12 ``max_concurrency(slo)`` (the paper's C^max), and the
    returned fits are the matching service curves for an
    ``AdmissionController``/``PredictivePolicy`` — one calibration feeding
    dispatch, admission, and the simulator consistently.

    ``models`` iterates in cascade-priority order (dicts preserve
    insertion order); ``quantized`` names the tiers brownout may prefer at
    equal backlog.
    """
    tiers: List[TierSpec] = []
    fits: Dict[str, LatencyFit] = {}
    for name, model in models.items():
        fit = fit_from_model(model, probe_points)
        depth = fit.max_concurrency(slo_s)
        tiers.append(TierSpec(name, depth, model=model,
                              quantized=name in quantized))
        fits[name] = fit
    if all(t.depth <= 0 for t in tiers):
        raise ValueError(f"no tier meets the {slo_s}s SLO even at C=1")
    return tiers, fits


def evaluate(arm: PlanArm, trace: Sequence[Tuple[float, int]], *,
             slo_s: float = 1.0, trace_name: str = "trace",
             seed: int = 0) -> PlanPoint:
    """Run one arm against one arrival trace in the DES and reduce it."""
    if not trace:
        raise ValueError("need a non-empty arrival trace")
    sim = ServingSimulator(
        tiers=list(arm.tiers), slo_s=slo_s, seed=seed,
        policy=arm.policy, retry=arm.retry, deadline_s=arm.deadline_s,
        faults=dict(arm.faults), admission=arm.admission,
        brownout=arm.brownout)
    res = sim.run(list(trace))
    arrivals = len(trace)
    # at-arrival turn-aways: classic BUSY, admission sheds, dead on arrival
    shed = (res.rejected + res.rejections.get("admission", 0)
            + res.rejections.get("expired", 0))
    # accepted = delivered capacity: arrivals minus turn-aways minus
    # terminal failures (queued expiry, retry exhaustion).  A query the
    # deployment admitted and then failed is not a unit of capacity — an
    # outage arm must not look CHEAPER per query because it admitted work
    # it went on to burn.
    accepted = max(0, arrivals - shed - res.failed)
    horizon = max(float(trace[-1][0]), 1e-9)
    cost = arm.price_per_s * horizon
    return PlanPoint(
        arm=arm.name, trace=trace_name, horizon_s=horizon,
        arrivals=arrivals, accepted=accepted, completed=res.n_completed,
        in_slo=res.max_ok_concurrency,
        slo_attainment=res.max_ok_concurrency / arrivals,
        deadline_misses=sum(res.deadline_misses.values()),
        failed=res.failed,
        rejections=dict(res.rejections),
        brownout_transitions=dict(res.brownout_transitions),
        cost=cost,
        cost_per_m_accepted=cost_per_million_queries(
            arm.price_per_s, horizon, accepted))


def sweep(arms: Sequence[PlanArm],
          traces: Mapping[str, Sequence[Tuple[float, int]]], *,
          slo_s: float = 1.0, seed: int = 0) -> List[PlanPoint]:
    """Every arm against every named trace — the planner's full grid."""
    return [evaluate(arm, trace, slo_s=slo_s, trace_name=name, seed=seed)
            for arm in arms for name, trace in traces.items()]


def best(points: Sequence[PlanPoint],
         min_attainment: float = 0.0) -> PlanPoint:
    """Cheapest point (cost per million accepted) meeting the attainment
    bar — the sizing decision the curve exists to answer."""
    ok = [p for p in points if p.slo_attainment >= min_attainment]
    if not ok:
        raise ValueError(
            f"no plan point reaches SLO attainment {min_attainment}; "
            f"best seen {max(p.slo_attainment for p in points):.3f}")
    return min(ok, key=lambda p: (p.cost_per_m_accepted, p.arm))
