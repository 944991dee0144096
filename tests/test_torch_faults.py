"""The port's fault injection (``repro_torch.core.faults``) against the JAX
package's, on the CPU.

Every case runs the same inputs through both packages and holds the port
to the reference: the ordinal plans and wall-time schedules, the DES with a
``FaultModel`` (port DES against reference DES), the threaded engine with a
``FaultyBackend`` around a modeled tier (port engine against reference
engine), and a ``FaultyBackend`` around the real embedders at smoke size
(``TorchEmbedderBackend`` against ``JaxEmbedderBackend`` on the same numpy
weights and queries).  The engine is never held against the DES here: on
some plans the two drivers of the reference disagree with each other (the
plan ``([0, 1], 1, 4, 1)`` below), and the port inherits that as it is.

Fixed, parametrised plans only (no Hypothesis).  Engine bursts are
submitted under a pinned GIL switch interval, as the reference's parity
tests do, so each burst reaches the queue before a worker runs.
"""
import importlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import embedder as jax_embedder  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.core.routing import Query  # noqa: E402
from repro_torch.models.embedder import params_from_numpy  # noqa: E402

PKGS = ("repro", "repro_torch")
T0, T1 = "T0", "T1"
BETAS = {T0: 0.05, T1: 0.07}
LEN = 16


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.core.{name}")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pinned(fn):
    """``fn()`` with the GIL switch interval pinned at 5 s."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(5.0)
    try:
        return fn()
    finally:
        sys.setswitchinterval(old)


def counters(t):
    return {"dispatched": dict(t.dispatched), "rejected": t.rejected,
            "completed": t.n_completed, "per_device": dict(t.per_device),
            "deadline_misses": dict(t.deadline_misses),
            "retries": dict(t.retries),
            "backend_errors": dict(t.backend_errors),
            "breaker_trips": dict(t.breaker_trips),
            "breaker_recoveries": dict(t.breaker_recoveries),
            "failed": t.failed}


# ------------------------------------------------- plans and schedules --
@pytest.mark.parametrize("kw", [
    dict(fail=[2, 3], stall={1}, corrupt=(0,), stall_s=0.5),
    dict(fail=range(3)), dict(), dict(stall_s=-0.1)], ids=str)
def test_fault_plan_matches_the_reference(kw):
    got = []
    for pkg in PKGS:
        try:
            p = mod(pkg, "faults").FaultPlan(**kw)
            got.append((p.fail, p.stall, p.corrupt, p.stall_s))
        except ValueError as e:
            got.append(("ValueError", str(e)))
    assert got[0] == got[1]
    assert all(isinstance(s, frozenset) for s in got[1][:3]) or \
        got[1][0] == "ValueError"


@pytest.mark.parametrize("args", [(6.0, 2.0, 20.0, 7), (0.5, 0.5, 30.0, 1),
                                  (100.0, 1.0, 10.0, 0), (1.0, 3.0, 50.0, 9),
                                  (0.0, 1.0, 5.0, 0)], ids=str)
def test_fault_schedules_match_the_reference(args):
    times = np.linspace(-1.0, args[2] + 1.0, 301)
    got = []
    for pkg in PKGS:
        try:
            s = mod(pkg, "faults").FaultSchedule.from_mttf(*args[:3],
                                                           seed=args[3])
        except ValueError as e:
            got.append(("ValueError", str(e)))
            continue
        got.append((s.windows, s.down_s,
                    [s.is_down(float(t)) for t in times],
                    [s.next_up(float(t)) for t in times]))
    assert got[0] == got[1]


def test_schedule_windows_are_validated_as_by_the_reference():
    for pkg in PKGS:
        FS = mod(pkg, "faults").FaultSchedule
        assert FS(((5.0, 6.0), (1.0, 2.0))).windows == ((1.0, 2.0),
                                                        (5.0, 6.0))
        with pytest.raises(ValueError, match="backwards"):
            FS(((2.0, 1.0),))


def test_fault_model_outcomes_match_the_reference():
    plan_kw = dict(fail={1, 4}, stall={0, 4}, stall_s=0.3)
    sched = ((1.0, 2.0), (3.5, 3.75))
    seqs = []
    for pkg in PKGS:
        F = mod(pkg, "faults")
        fm = F.FaultModel(plan=F.FaultPlan(**plan_kw),
                          schedule=F.FaultSchedule(sched), fail_latency_s=0.05)
        seq = [fm.outcome(now=0.25 * i) for i in range(20)]
        seqs.append((seq, fm.executions, fm.injected_failures,
                     fm.injected_stalls))
        fm.reset()
        assert (fm.executions, fm.injected_failures) == (0, 0)
        with pytest.raises(ValueError):
            F.FaultModel(fail_latency_s=-0.1)
    assert seqs[0] == seqs[1]


class Counting:
    """A backend with a distinct vector a query: qid, qid + 0.5, ..."""

    name = "counting"
    telemetry = None

    def __init__(self):
        self.calls = 0

    def embed_batch(self, queries):
        self.calls += 1
        return [np.arange(4, dtype=np.float32) * 0.5 + q.qid for q in queries]


def test_faulty_backend_matches_the_reference_execution_by_execution():
    """Ordinal fails, stalls and corruptions, then a wall-time window on a
    fake clock: the same outcome, vector and counter at every execution."""
    runs = []
    for pkg in PKGS:
        F, R = mod(pkg, "faults"), mod(pkg, "routing")
        t = [100.0]
        fb = F.FaultyBackend(Counting(),
                             plan=F.FaultPlan(fail={1, 5}, corrupt={2, 3},
                                              stall={4}, stall_s=0.0),
                             schedule=F.FaultSchedule(((6.0, 7.0),)),
                             clock=lambda: t[0])
        out = []
        for i in range(9):
            t[0] = 100.0 + i
            try:
                out.append([v.tolist() for v in fb.embed_batch(
                    [R.Query(qid=i, length=8), R.Query(qid=10 + i, length=8)])])
            except F.BackendError as e:
                out.append(str(e))
        runs.append((out, fb.executions, fb.injected_failures,
                     fb.injected_stalls, fb.injected_corruptions,
                     fb.inner.calls, fb.name, fb.async_dispatch))
    assert runs[0] == runs[1]
    assert runs[1][1:6] == (9, 3, 1, 2, 6)


# ------------------------------------------------------------ the DES --
def models(pkg):
    S = mod(pkg, "simulator")
    return {n: S.DeviceModel(n, beta=b, b=0.0, a=0.0)
            for n, b in BETAS.items()}


def breaker(pkg):
    # cooldown far beyond any run: a trip stays a trip on either clock
    return mod(pkg, "health").CircuitBreaker(failure_threshold=2,
                                             cooldown_s=1000.0)


# (T0 fail ordinals, max_retries, burst, max_batch); ([0, 1], 1, 4, 1) is
# where the reference's engine (T0 5 / T1 1) and DES (T0 4 / T1 2) disagree
PLANS = [([], 0, 6, 2), ([0], 1, 8, 2), ([0, 1], 1, 4, 1),
         ([1, 2, 3], 2, 10, 4), ([0, 2, 4], 3, 12, 1), ([0, 1, 2, 3], 0, 9, 2),
         ([4], 1, 12, 4)]


def des_run(pkg, fails, retries, n, max_batch, **fault_kw):
    F, R, S = mod(pkg, "faults"), mod(pkg, "routing"), mod(pkg, "simulator")
    m, depth = models(pkg), n + 4
    sim = S.ServingSimulator(
        tiers=[R.TierSpec(T0, depth, model=m[T0], max_batch=max_batch,
                          breaker=breaker(pkg)),
               R.TierSpec(T1, depth, model=m[T1], max_batch=max_batch,
                          breaker=breaker(pkg))],
        slo_s=100.0, retry=R.RetryPolicy(max_retries=retries, backoff_s=0.0),
        faults={T0: F.FaultModel(plan=F.FaultPlan(fail=frozenset(fails)),
                                 **fault_kw)})
    res = sim.run([(0.05 * (i % 3), LEN) for i in range(n)])
    return counters(res), res.max_ok_concurrency


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_des_fault_counters_match_the_reference_des(plan):
    assert des_run("repro_torch", *plan) == des_run("repro", *plan)


@pytest.mark.parametrize("args", [(6.0, 2.0, 20.0, 7), (0.4, 0.3, 10.0, 3)],
                         ids=str)
def test_des_under_an_mttf_schedule_matches_the_reference_des(args):
    """A wall-time (simulated) outage schedule with priced detection."""
    got = []
    for pkg in PKGS:
        F = mod(pkg, "faults")
        sched = F.FaultSchedule.from_mttf(*args[:3], seed=args[3])
        got.append(des_run(pkg, [], 2, 12, 2, schedule=sched,
                           fail_latency_s=0.05))
    assert got[0] == got[1]


# --------------------------------------------------------- the engine --
def engine_run(pkg, fails, retries, n, max_batch):
    F, R, W = mod(pkg, "faults"), mod(pkg, "routing"), mod(pkg, "windve")
    m, depth = models(pkg), n + 4
    ve = W.WindVE(
        tiers=[R.TierSpec(T0, depth,
                          backend=F.FaultyBackend(
                              W.ModeledBackend(m[T0], embed_dim=4),
                              plan=F.FaultPlan(fail=frozenset(fails))),
                          max_batch=max_batch, breaker=breaker(pkg)),
               R.TierSpec(T1, depth,
                          backend=W.ModeledBackend(m[T1], embed_dim=4),
                          max_batch=max_batch, breaker=breaker(pkg))],
        retry=R.RetryPolicy(max_retries=retries, backoff_s=0.0))
    try:
        futs = pinned(lambda: [ve.submit(length=LEN) for _ in range(n)])
        done = fail = 0
        for f in futs:
            try:
                f.result(timeout=30)
                done += 1
            except Exception:
                fail += 1
        out = counters(ve.stats)
        out["client"] = (done, fail)
        out["injected"] = ve.backends[T0].injected_failures
    finally:
        ve.shutdown()
    return out


@pytest.mark.parametrize("plan", PLANS, ids=str)
def test_engine_fault_counters_match_the_reference_engine(plan):
    got, want = engine_run("repro_torch", *plan), engine_run("repro", *plan)
    assert got == want
    assert sum(got["client"]) == plan[2]
    if plan == ([0, 1], 1, 4, 1):          # the reference's own numbers
        assert got["dispatched"] == {T0: 5, T1: 1}


# ------------------------------------- the real embedder behind the wrapper --
WAVES, WAVE = 4, 4
PLAN = dict(fail={1}, corrupt={3})       # wave 1's batch fails, wave 2's
MAX_TOKENS = 32                          # (execution 3) is corrupted


@pytest.fixture(scope="module")
def bge_smoke():
    """(jax cfg, port cfg, jax params, the same params as numpy)."""
    jc = jax_get_config("bge-large-zh-v1.5").smoke()
    tc = get_config("bge-large-zh-v1.5").smoke()
    params = jax_embedder.init_embedder(jax.random.PRNGKey(0), jc)
    return jc, tc, params, jax.tree.map(np.asarray, params)


def real_backend(pkg, bge):
    jc, tc, params, tree = bge
    W = mod(pkg, "windve")
    if pkg == "repro":
        return W.JaxEmbedderBackend(jc, params, max_tokens=MAX_TOKENS,
                                    dtype="fp32")
    return W.TorchEmbedderBackend(tc, params_from_numpy(tree, "cpu"),
                                  max_tokens=MAX_TOKENS, dtype="fp32",
                                  device="cpu")


def serve_waves(pkg, backend, plan=None):
    """WAVES waves of WAVE queries, each wave one burst waited for, through
    one tier (``backend`` behind a FaultyBackend when ``plan`` is given)
    with one retry.  Returns (vectors (n, d), counters, the wrapper)."""
    F, R, W = mod(pkg, "faults"), mod(pkg, "routing"), mod(pkg, "windve")
    from repro_torch.data.workload import make_queries

    tier = backend if plan is None else F.FaultyBackend(
        backend, plan=F.FaultPlan(**plan))
    ve = W.WindVE(tiers=[R.TierSpec("REAL", 2 * WAVE, backend=tier,
                                    max_batch=WAVE)],
                  retry=R.RetryPolicy(max_retries=1, backoff_s=0.0))
    payloads = make_queries(WAVES * WAVE, 512, length=24, seed=3)
    vecs = []
    try:
        for w in range(WAVES):
            wave = payloads[w * WAVE:(w + 1) * WAVE]
            futs = pinned(lambda: [ve.submit(payload=p, length=24)
                                   for p in wave])
            vecs += [f.result(timeout=120) for f in futs]
        stats = counters(ve.stats)
    finally:
        ve.shutdown()
    return np.stack(vecs), stats, tier


@pytest.fixture(scope="module")
def chaos(bge_smoke):
    """pkg -> (fault-free vectors, faulty vectors, faulty counters,
    wrapper)."""
    out = {}
    for pkg in PKGS:
        clean, _, _ = serve_waves(pkg, real_backend(pkg, bge_smoke))
        got, stats, fb = serve_waves(pkg, real_backend(pkg, bge_smoke), PLAN)
        out[pkg] = (clean, got, stats, fb)
    return out


def test_wrapped_embedder_answers_equal_a_fault_free_run_but_the_corrupted_batch(
        chaos):
    clean, got, stats, fb = chaos["repro_torch"]
    corrupted = slice(2 * WAVE, 3 * WAVE)      # wave 2 is execution 3
    keep = np.ones(len(got), bool)
    keep[corrupted] = False
    np.testing.assert_allclose(got[keep], clean[keep], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[corrupted], 1.0 - clean[corrupted],
                               atol=1e-6, rtol=0)
    assert np.abs(got[corrupted] - clean[corrupted]).max() > 0.1
    assert (fb.executions, fb.injected_failures, fb.injected_corruptions) \
        == (WAVES + 1, 1, 1)
    assert stats["retries"] == {"REAL": WAVE} and stats["failed"] == 0
    assert stats["per_device"] == {"REAL": WAVES * WAVE}
    # the wrapper turns the inner backend's counters into .inner's
    assert fb.inner.traces >= 1 and fb.async_dispatch is False


def test_wrapped_embedder_matches_the_reference_wrapped_embedder(chaos):
    (_, want, want_stats, ref_fb), (_, got, stats, fb) = (
        chaos["repro"], chaos["repro_torch"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert stats == want_stats
    assert (fb.executions, fb.injected_failures, fb.injected_corruptions) \
        == (ref_fb.executions, ref_fb.injected_failures,
            ref_fb.injected_corruptions)


def test_wrapper_forwards_telemetry_and_turns_off_async_dispatch(bge_smoke):
    from repro_torch.core.sharded_backend import ShardedEmbedderBackend
    from repro_torch.core.telemetry import Telemetry

    _, tc, _, tree = bge_smoke
    inner = ShardedEmbedderBackend(tc, params_from_numpy(tree, "cpu"),
                                   max_tokens=MAX_TOKENS, dtype="fp32",
                                   device="cpu", async_dispatch=True)
    fb = faults.FaultyBackend(inner)
    assert inner.async_dispatch and fb.async_dispatch is False
    t = Telemetry()
    fb.telemetry = t
    assert inner.telemetry is t and fb.telemetry is t
    assert fb.name == f"faulty({inner.name})"
    long = Query(qid=0, payload=np.arange(1, MAX_TOKENS + 9, dtype=np.int32),
                 length=MAX_TOKENS + 8)
    [v] = fb.embed_batch([long])          # truncated: counted through
    assert v.shape == (tc.d_model,) and inner.truncated == 1
    assert t.truncated == 1
