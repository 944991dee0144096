"""Deployment-cost model — paper §3 (Eqs. 1-6) and §3.2 savings analysis.

Two provisioning regimes:
* throughput-provisioned (Eq. 5):  Cost = (N / n) / T * D * P
* peak-provisioned       (Eq. 6):  Cost = N_peak / C * D * P

and the §3.2 headline results for CPU offloading:
* peak-provisioned saving     = C_CPU / (C_CPU + C_NPU)
* average-provisioned uplift  = C_CPU / C_NPU
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Deployment:
    device_per_instance: int = 1     # D
    price_per_device: float = 1.0    # P


def waiting_slots(t_total_max: float, t_proc: float) -> int:
    """Eq. 4: n = floor((t^max_total - t_proc) / t_proc) — how many other
    queries may be processed while one waits without breaking the SLO."""
    if t_proc <= 0:
        raise ValueError("t_proc must be positive")
    return max(0, math.floor((t_total_max - t_proc) / t_proc))


def cost_throughput(n_queries_per_s: float, t_total_max: float,
                    t_proc: float, throughput: float,
                    d: Deployment = Deployment()) -> float:
    """Eq. 5 — provision by average throughput T with n-deep waiting."""
    n = max(1, waiting_slots(t_total_max, t_proc))
    return (n_queries_per_s / n) / throughput * d.device_per_instance * \
        d.price_per_device


def cost_peak(n_peak: float, max_concurrency: float,
              d: Deployment = Deployment()) -> float:
    """Eq. 6 — provision by peak query rate over system max concurrency."""
    if max_concurrency <= 0:
        raise ValueError("max concurrency must be positive")
    return n_peak / max_concurrency * d.device_per_instance * d.price_per_device


def peak_saving(c_npu: int, c_cpu: int) -> float:
    """§3.2: deployment-cost saving when peak-provisioned: C_CPU/(C_CPU+C_NPU)."""
    if c_npu <= 0:
        raise ValueError("c_npu must be positive")
    return c_cpu / (c_cpu + c_npu)


def throughput_uplift(c_npu: int, c_cpu: int) -> float:
    """§3.2: average-throughput uplift: C_CPU/C_NPU (also the paper's
    'concurrency improvement' in Tables 1-2)."""
    if c_npu <= 0:
        raise ValueError("c_npu must be positive")
    return c_cpu / c_npu


def fanout_depth(alpha: float, beta: float, devices: int, slo_s: float,
                 overhead_s: float = 0.0) -> int:
    """Closed-form Eq. 12 depth for an N-device fan-out tier.

    With the per-device curve t(c) = beta + alpha * c and a batch of C
    spreading C/N rows per device (plus a per-execution fan-out/gather
    overhead), the tier's service curve is

        t(C) = beta + overhead + alpha * C / N ,

    so the SLO-safe depth scales ~N-fold minus what the overhead eats:

        C_max = N * floor((T - beta - overhead) / alpha).
    """
    if alpha <= 0:
        raise ValueError("alpha must be positive")
    if devices < 1:
        raise ValueError("devices must be >= 1")
    budget = slo_s - beta - overhead_s
    if budget < alpha:            # even 1 row per device misses the SLO
        return 0
    return devices * math.floor(budget / alpha + 1e-9)


def mesh_overhead(fanout_beta_s: float, devices: int,
                  interhost_beta_s: float = 0.0, hosts: int = 1) -> float:
    """Per-execution scatter/gather overhead of a (possibly multi-host)
    replica mesh — the ``overhead_s`` term :func:`fanout_depth` subtracts
    from the SLO budget, and the closed form of
    ``simulator.FanOutModel.overhead_s``:

        fanout_beta * log2(devices) + interhost_beta * log2(hosts).

    The intra-host tree rides the device interconnect; when the replica's
    device group is carved across ``hosts`` machines the gather's top
    ``log2(hosts)`` levels ride the network fabric instead, which is why
    depth calibration at cluster scale must price the two terms separately
    (``interhost_beta_s`` is typically orders of magnitude above
    ``fanout_beta_s``)."""
    if devices < 1 or hosts < 1:
        raise ValueError("devices and hosts must be >= 1")
    if devices % hosts:
        raise ValueError(f"devices ({devices}) must split evenly over "
                         f"hosts ({hosts})")
    over = fanout_beta_s * math.log2(devices) if devices > 1 else 0.0
    if hosts > 1:
        over += interhost_beta_s * math.log2(hosts)
    return over


def replica_capacity(depth: int, replicas: int, down: int = 0) -> int:
    """System max concurrency of R identical replicas with k quarantined:
    ``(R - k) * depth`` — the replica-topology instance of
    :func:`degraded_capacity`, and what the Eq. 6 peak-provisioned cost
    divides by while k hosts are down.  A replica is a whole capacity unit:
    its breaker trips it entirely, so partial-replica capacity shows up as
    a *changed per-replica depth* (recalibrate on the degraded device
    count via :func:`fanout_depth`), never as a fractional replica."""
    if depth < 0:
        raise ValueError("depth must be >= 0")
    if replicas < 1:
        raise ValueError("replicas must be >= 1")
    if not 0 <= down <= replicas:
        raise ValueError(f"down must be in [0, {replicas}], got {down}")
    return (replicas - down) * depth


def fanout_efficiency(depth_n: int, depth_1: int, devices: int) -> float:
    """Fraction of the ideal N-fold depth scaling a fan-out tier realises:
    depth_N / (N * depth_1).  1.0 == perfect linear scaling; the
    fan-out/gather overhead and pow2 chunk padding pull it below."""
    if depth_1 <= 0 or devices < 1:
        raise ValueError("need positive single-device depth and devices")
    return depth_n / (devices * depth_1)


def cache_uplift(hit_rate: float) -> float:
    """Effective-concurrency uplift from an exact-match cache tier serving
    hit fraction p at ~zero latency: only (1 - p) of arrivals consume a
    device slot, so system capacity (and the Eq. 5/6 deployment-cost
    denominators) scale by 1 / (1 - p).  p = 0.5 doubles capacity — more
    than any single-device speedup in Tables 1-2 buys."""
    if not 0.0 <= hit_rate < 1.0:
        raise ValueError(f"hit_rate must be in [0, 1), got {hit_rate}")
    return 1.0 / (1.0 - hit_rate)


def cached_depth(depth: int, hit_rate: float) -> int:
    """Arrival-level SLO-safe concurrency of a device tier of depth
    ``depth`` behind a cache with hit fraction p: the device still bounds
    its RESIDENT load at ``depth``, but the arrival stream that load maps
    to is ``depth / (1 - p)`` — the closed form of
    ``estimator.cached_fit(fit, p).max_concurrency(slo)`` (p of the extra
    arrivals are hits that never occupy a slot)."""
    if depth < 0:
        raise ValueError("depth must be >= 0")
    return math.floor(depth * cache_uplift(hit_rate) + 1e-9)


def availability(mttf_s: float, mttr_s: float) -> float:
    """Steady-state availability of a repairable tier: MTTF/(MTTF+MTTR) —
    the up fraction of the alternating-renewal process
    ``faults.FaultSchedule.from_mttf`` draws its down windows from."""
    if mttf_s <= 0 or mttr_s <= 0:
        raise ValueError("mttf_s and mttr_s must be positive")
    return mttf_s / (mttf_s + mttr_s)


def degraded_capacity(depths: "dict[str, int]",
                      down: "Iterable[str]" = ()) -> int:
    """System max concurrency with the named tiers tripped/failed: the sum
    of C^max over the tiers dispatch can still reach — the closed form of
    ``QueueManager.degraded_max_concurrency`` while breakers are open.
    The paper's Eq. 6 peak-provisioned cost divides by THIS during an
    outage, not by the fault-free total."""
    unknown = set(down) - set(depths)
    if unknown:
        raise ValueError(f"unknown tier(s) {sorted(unknown)}; "
                         f"have {sorted(depths)}")
    return sum(d for name, d in depths.items() if name not in down)


def expected_capacity(depths: "dict[str, int]",
                      avail: "dict[str, float]") -> float:
    """Long-run expected max concurrency of a topology whose tiers fail
    independently with per-tier availability ``avail`` (missing tiers
    count as always-up): sum_t A_t * C^max_t.  What a fault-aware sizing
    pass should provision against instead of the fault-free sum."""
    for name, a in avail.items():
        if not 0.0 <= a <= 1.0:
            raise ValueError(f"availability[{name!r}] must be in [0, 1]")
    return sum(d * avail.get(name, 1.0) for name, d in depths.items())


def cost_per_million_queries(price_per_s: float, horizon_s: float,
                             accepted: int) -> float:
    """The planner's headline unit economics: what one million *accepted*
    queries cost on a topology priced at ``price_per_s`` over a serving
    window of ``horizon_s`` in which it accepted ``accepted`` queries.

    Accepted — not offered — is the denominator the paper's deployment
    argument implies: a topology that rejects half its arrivals under a
    flash crowd pays full price for half the work, which is exactly the
    signal a sizing sweep must surface.  A window that accepted nothing
    costs infinity per query (the topology is pure waste at this load).
    """
    if price_per_s < 0:
        raise ValueError("price_per_s must be >= 0")
    if horizon_s <= 0:
        raise ValueError("horizon_s must be positive")
    if accepted < 0:
        raise ValueError("accepted must be >= 0")
    if accepted == 0:
        return math.inf
    return price_per_s * horizon_s / accepted * 1e6


def overload_shed_fraction(arrival_rate: float, capacity_rate: float) -> float:
    """Lower bound on the fraction of arrivals ANY loss system must turn
    away at steady state: ``max(0, 1 - capacity/arrivals)``.  An admission
    controller cannot beat this bound — it can only choose *which* queries
    make up the shed fraction (the predictably-late ones) instead of
    letting the queue choose (the unlucky ones, after wasting device time
    on them)."""
    if arrival_rate <= 0:
        raise ValueError("arrival_rate must be positive")
    if capacity_rate < 0:
        raise ValueError("capacity_rate must be >= 0")
    return max(0.0, 1.0 - capacity_rate / arrival_rate)


def concurrency_uplift_bound(alpha_npu: float, alpha_cpu: float) -> float:
    """Ineq. 19: C_CPU/C_NPU < alpha_NPU/alpha_CPU — the uplift is bounded by
    the device performance-gap ratio."""
    if alpha_cpu <= 0:
        raise ValueError("alpha_cpu must be positive")
    return alpha_npu / alpha_cpu
