"""The port's cost model, affinity planner and capacity planner against the
JAX package's, on the CPU.

``repro_torch.core.{cost_model,affinity,planner}`` are copies of the
reference's framework-free modules with their imports rewritten; every
case here runs the same inputs through both packages and requires the same
value, or the same exception.  The planner's cases run whole DES
evaluations (admission, brownout, retries, ordinal and MTTF fault models)
and ``sweep``/``best`` must pick the same arm.  ``apply_affinity`` pins
only a child process, never the test worker.
"""
import dataclasses
import importlib
import os
import subprocess
import sys

import pytest

PKGS = ("repro", "repro_torch")
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.core.{name}")


def outcome(fn):
    """("ok", value) or (exception type name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:          # compared, not swallowed
        return (type(e).__name__, str(e))


def both(module, call):
    """``call(module)`` through each package's ``module``."""
    return [outcome(lambda p=pkg: call(mod(p, module))) for pkg in PKGS]


def public(m):
    return sorted(n for n in vars(m) if not n.startswith("_")
                  and callable(getattr(m, n))
                  and getattr(getattr(m, n), "__module__", "") == m.__name__)


@pytest.mark.parametrize("module", ["cost_model", "affinity", "faults",
                                    "planner"])
def test_port_module_has_the_reference_api(module):
    ref, port = (mod(p, module) for p in PKGS)
    assert public(port) == public(ref)
    assert port.__name__ == f"repro_torch.core.{module}"


# ------------------------------------------------------------ cost model --
COST_CASES = {
    "waiting_slots": lambda m: m.waiting_slots(1.0, 0.1),
    "waiting_slots_over_slo": lambda m: m.waiting_slots(0.05, 0.1),
    "waiting_slots_zero_proc": lambda m: m.waiting_slots(1.0, 0.0),
    "cost_throughput": lambda m: m.cost_throughput(100.0, 1.0, 0.1, 50.0),
    "cost_throughput_priced": lambda m: m.cost_throughput(
        100.0, 1.0, 0.3, 50.0, m.Deployment(2, 3.5)),
    "cost_peak": lambda m: m.cost_peak(500.0, 96, m.Deployment(8, 1.25)),
    "cost_peak_zero": lambda m: m.cost_peak(500.0, 0),
    "peak_saving_table1": lambda m: m.peak_saving(96, 22),
    "peak_saving_bad": lambda m: m.peak_saving(0, 3),
    "throughput_uplift_table1": lambda m: m.throughput_uplift(96, 22),
    "throughput_uplift_bad": lambda m: m.throughput_uplift(-1, 3),
    "fanout_depth": lambda m: m.fanout_depth(0.01, 0.05, 4, 1.0, 0.02),
    "fanout_depth_no_budget": lambda m: m.fanout_depth(0.01, 0.995, 4, 1.0),
    "fanout_depth_bad": lambda m: m.fanout_depth(0.0, 0.05, 1, 1.0),
    "mesh_overhead": lambda m: m.mesh_overhead(0.002, 8, 0.05, 2),
    "mesh_overhead_uneven": lambda m: m.mesh_overhead(0.002, 6, 0.0, 4),
    "replica_capacity": lambda m: m.replica_capacity(40, 4, 1),
    "replica_capacity_bad": lambda m: m.replica_capacity(40, 4, 5),
    "fanout_efficiency": lambda m: m.fanout_efficiency(300, 100, 4),
    "cache_uplift": lambda m: m.cache_uplift(0.5),
    "cache_uplift_bad": lambda m: m.cache_uplift(1.0),
    "cached_depth": lambda m: m.cached_depth(45, 0.3),
    "availability": lambda m: m.availability(6.0, 2.0),
    "availability_bad": lambda m: m.availability(0.0, 1.0),
    "degraded_capacity": lambda m: m.degraded_capacity(
        {"NPU": 45, "CPU": 2}, ["CPU"]),
    "degraded_capacity_unknown": lambda m: m.degraded_capacity(
        {"NPU": 45}, ["GPU"]),
    "expected_capacity": lambda m: m.expected_capacity(
        {"NPU": 45, "CPU": 2}, {"NPU": 0.75}),
    "expected_capacity_bad": lambda m: m.expected_capacity(
        {"NPU": 45}, {"NPU": 1.5}),
    "cost_per_million": lambda m: m.cost_per_million_queries(10.0, 100.0, 500),
    "cost_per_million_none": lambda m: m.cost_per_million_queries(
        10.0, 100.0, 0),
    "cost_per_million_bad": lambda m: m.cost_per_million_queries(
        10.0, 0.0, 5),
    "overload_shed_fraction": lambda m: m.overload_shed_fraction(100.0, 40.0),
    "overload_shed_none": lambda m: m.overload_shed_fraction(50.0, 100.0),
    "concurrency_uplift_bound": lambda m: m.concurrency_uplift_bound(
        0.0172, 0.0714),
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_model_returns_the_reference_value(case):
    ref, port = both("cost_model", COST_CASES[case])
    assert port == ref
    if case.endswith(("_bad", "_zero", "_unknown", "_uneven")):
        assert port[0] == "ValueError"


def test_paper_table1_headline_through_the_port():
    from repro_torch.core.cost_model import peak_saving, throughput_uplift

    # Table 1 (bge): 96 -> 118 concurrent queries with the CPU offload
    assert throughput_uplift(96, 22) == pytest.approx(0.2292, abs=1e-4)
    assert peak_saving(96, 22) == pytest.approx(22 / 118)


# -------------------------------------------------------------- affinity --
AFFINITY_CASES = [(128, 4, n, True) for n in (1, 8, 32, 33, 96, 97)] + [
    (64, 1, 8, True), (96, 3, 40, True), (8, 2, 4, False), (8, 2, 5, False),
    (16, 4, 0, True), (12, 3, 4, True)]


@pytest.mark.parametrize("case", AFFINITY_CASES, ids=str)
def test_plan_affinity_returns_the_reference_plan(case):
    total, numas, need, reserve = case

    def plan(m):
        topo = m.NumaTopology(total, numas)
        cores = m.plan_affinity(topo, need, reserve_first_numa=reserve)
        return cores, m.numa_crossings(topo, cores), topo.cores_per_numa

    ref, port = both("affinity", plan)
    assert port == ref


def test_apply_affinity_pins_a_child_process():
    code = ("import os\n"
            "from repro_torch.core.affinity import apply_affinity\n"
            "cores = sorted(os.sched_getaffinity(0))[-1:]\n"
            "assert apply_affinity(cores) is True\n"
            "assert sorted(os.sched_getaffinity(0)) == cores\n"
            "assert apply_affinity([-1]) is False\n"
            "print('pinned', cores)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    before = os.sched_getaffinity(0)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "pinned" in proc.stdout
    assert os.sched_getaffinity(0) == before       # this process untouched


# --------------------------------------------------------------- planner --
def models(pkg):
    S = mod(pkg, "simulator")
    return {"NPU": S.DeviceModel("npu", beta=0.05, b=0.01, a=0.0),
            "CPU": S.DeviceModel("cpu", beta=0.10, b=0.05, a=0.0)}


def traces(pkg):
    W = importlib.import_module(f"{pkg}.data.workload")
    S = mod(pkg, "simulator")
    return {"calm": W.flash_crowd_trace(10, 10.0, 1.0, 0, 0, seed=4),
            "storm": W.flash_crowd_trace(10, 200.0, 1.0, 0, 0, seed=4),
            "crowd": W.flash_crowd_trace(20, 60.0, 4.0, 5, 10, seed=5),
            "diurnal": S.diurnal_trace(20, 20.0, 120.0, seed=2)}


def arm(pkg, kind, price=10.0):
    """One candidate deployment built from ``pkg``'s own classes."""
    P, F = mod(pkg, "planner"), mod(pkg, "faults")
    A, H, R = mod(pkg, "admission"), mod(pkg, "health"), mod(pkg, "routing")
    tiers, fits = P.calibrated_tiers(models(pkg), 1.0, quantized={"CPU"})
    if kind == "bare":
        return P.PlanArm(kind, tiers=tiers, price_per_s=price)
    kw = dict(admission=A.AdmissionController(fits=fits, slo_s=1.0,
                                              reject_cost=0.5),
              brownout=H.BrownoutController(), deadline_s=2.0)
    if kind == "outage":
        sched = F.FaultSchedule.from_mttf(mttf_s=6.0, mttr_s=2.0,
                                          horizon_s=20.0, seed=7)
        kw.update(faults={"NPU": F.FaultModel(schedule=sched,
                                              fail_latency_s=0.05)},
                  retry=R.RetryPolicy(max_retries=1, backoff_s=0.0))
    elif kind == "plan":
        kw.update(faults={"NPU": F.FaultModel(
            plan=F.FaultPlan(fail={1, 3, 8}, stall={2}, stall_s=0.3))},
            retry=R.RetryPolicy(max_retries=2, backoff_s=0.01))
    return P.PlanArm(kind, tiers=tiers, price_per_s=price, **kw)


def test_calibrated_tiers_match_the_reference():
    got = []
    for pkg in PKGS:
        tiers, fits = mod(pkg, "planner").calibrated_tiers(
            models(pkg), 1.0, quantized={"CPU"})
        got.append(([(t.name, t.depth, t.quantized) for t in tiers],
                    {k: (f.alpha, f.beta) for k, f in fits.items()}))
    assert got[0] == got[1]
    assert got[1][0] == [("NPU", 95, False), ("CPU", 18, True)]


def test_traces_are_the_reference_traces():
    assert traces("repro_torch") == traces("repro")


def point(p):
    return {**dataclasses.asdict(p), "row": p.row()}


@pytest.mark.parametrize("trace", ["calm", "storm", "crowd", "diurnal"])
@pytest.mark.parametrize("kind", ["bare", "controlled", "outage", "plan"])
def test_evaluate_returns_the_reference_plan_point(kind, trace):
    got = [point(mod(pkg, "planner").evaluate(
        arm(pkg, kind), traces(pkg)[trace], slo_s=1.0, trace_name=trace))
        for pkg in PKGS]
    assert got[0] == got[1]
    assert got[1]["arrivals"] == len(traces("repro_torch")[trace])


def test_sweep_and_best_pick_the_reference_arm():
    picks = []
    for pkg in PKGS:
        P = mod(pkg, "planner")
        arms = [arm(pkg, "controlled", 10.0), arm(pkg, "bare", 8.0),
                arm(pkg, "outage", 9.0), arm(pkg, "plan", 20.0)]
        pts = P.sweep(arms, traces(pkg), slo_s=1.0)
        picks.append(([point(p) for p in pts],
                      [P.best(pts, m).arm for m in (0.0, 0.5, 0.9)],
                      {t: P.best([p for p in pts if p.trace == t]).arm
                       for t in traces(pkg)},
                      outcome(lambda: P.best(pts, 1.1))))
    assert picks[0] == picks[1]
    assert picks[1][3][0] == "ValueError"


def test_planner_validation_matches_the_reference():
    for case in (lambda P, t: P.PlanArm("x", tiers=t, price_per_s=-1.0),
                 lambda P, t: P.PlanArm("x", tiers=[], price_per_s=1.0),
                 lambda P, t: P.evaluate(P.PlanArm("x", tiers=t,
                                                   price_per_s=1.0), [])):
        got = []
        for pkg in PKGS:
            P, S = mod(pkg, "planner"), mod(pkg, "simulator")
            tiers, _ = P.calibrated_tiers({"NPU": models(pkg)["NPU"]}, 1.0)
            got.append(outcome(lambda: case(P, tiers)))
            got.append(outcome(lambda: P.calibrated_tiers(
                {"S": S.DeviceModel("s", beta=5.0, b=1.0, a=0.0)}, 1.0)))
        assert got[:2] == got[2:]
        assert got[0][0] == "ValueError" and "SLO" in got[1][1]
