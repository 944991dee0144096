"""Seeded fault injection for both drivers of the scheduling core.

The fault-tolerance layer (deadlines, retry/failover, circuit breaking) is
only trustworthy if it is *exercised*: this module injects failures into the
engine (``FaultyBackend`` — a ``Backend`` wrapper) and the DES
(``FaultModel`` — consulted by ``ServingSimulator`` per batch execution)
from the SAME two schedule vocabularies, so an engine run and a DES run can
be subjected to the identical fault sequence and their telemetry compared:

* **ordinal plans** (:class:`FaultPlan`) — "batch executions #2 and #3 on
  this tier fail / stall / corrupt".  Batch ordinals are deterministic under
  both drivers whenever the batch sequences are (the parity property suite's
  pinned-GIL bursts), so this is the vocabulary of the engine-vs-DES
  fault-parity tests.
* **wall-time schedules** (:class:`FaultSchedule`) — down-time windows, or
  MTTF/MTTR exponential draws (``from_mttf``) over a horizon.  This is the
  vocabulary of the chaos microbench: a tier goes down mid-run and the
  serving layer must fail over, then recover when the window closes.

``BackendError`` is what an injected failure raises — a stand-in for the
device-pool exceptions (HBM OOM, collective timeout, RPC reset) a real
deployment throws.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.routing import Query


class BackendError(RuntimeError):
    """An injected (or real) device-pool failure for one batch execution."""


@dataclass(frozen=True)
class FaultPlan:
    """Per-tier *ordinal* fault plan: which batch executions (0-based, in
    tier execution order) fail, stall, or corrupt.  Deterministic by
    construction — the parity vocabulary."""

    fail: frozenset = frozenset()
    stall: frozenset = frozenset()
    corrupt: frozenset = frozenset()
    stall_s: float = 0.0

    def __post_init__(self):
        if self.stall_s < 0:
            raise ValueError("stall_s must be >= 0")
        # frozenset() accepts any iterable; normalize lists/sets passed in
        object.__setattr__(self, "fail", frozenset(self.fail))
        object.__setattr__(self, "stall", frozenset(self.stall))
        object.__setattr__(self, "corrupt", frozenset(self.corrupt))


@dataclass(frozen=True)
class FaultSchedule:
    """Wall-time down windows ``[(start_s, end_s), ...]`` on a tier-relative
    clock (engine: seconds since the wrapper saw its first batch; DES:
    simulated seconds).  ``from_mttf`` draws the windows from exponential
    MTTF/MTTR — the classic repairable-system availability model, so the
    expected up fraction is ``mttf / (mttf + mttr)``."""

    windows: Tuple[Tuple[float, float], ...] = ()

    def __post_init__(self):
        for s, e in self.windows:
            if e <= s:
                raise ValueError(f"empty/backwards down window ({s}, {e})")
        object.__setattr__(self, "windows",
                           tuple(sorted(tuple(map(float, w))
                                        for w in self.windows)))

    @classmethod
    def from_mttf(cls, mttf_s: float, mttr_s: float, horizon_s: float,
                  seed: int = 0) -> "FaultSchedule":
        if mttf_s <= 0 or mttr_s <= 0 or horizon_s <= 0:
            raise ValueError("mttf_s, mttr_s, horizon_s must be positive")
        rng = random.Random(seed)
        t, wins = 0.0, []
        while t < horizon_s:
            t += rng.expovariate(1.0 / mttf_s)          # time to failure
            if t >= horizon_s:
                break
            repair = rng.expovariate(1.0 / mttr_s)      # time to repair
            wins.append((t, min(t + repair, horizon_s)))
            t += repair
        return cls(tuple(wins))

    def is_down(self, t: float) -> bool:
        return any(s <= t < e for s, e in self.windows)

    def next_up(self, t: float) -> float:
        """The instant the tier is next up at-or-after ``t``."""
        for s, e in self.windows:
            if s <= t < e:
                return e
        return t

    @property
    def down_s(self) -> float:
        return sum(e - s for s, e in self.windows)


def _corrupted(embs: List[np.ndarray]) -> List[np.ndarray]:
    """A silently-wrong batch result: right shape/dtype, wrong values —
    the failure golden-parity checks exist to catch."""
    return [np.asarray(e) * -1.0 + 1.0 for e in embs]


class FaultyBackend:
    """Engine-side fault injector: wraps any ``Backend`` and subjects its
    batch executions to an ordinal :class:`FaultPlan` and/or a wall-time
    :class:`FaultSchedule` (clock starts at the first execution, so the
    schedule is phase-aligned with the run, not with process start).

    Duck-types ``Backend`` (name / telemetry / embed_batch); telemetry
    wiring is forwarded to the wrapped backend so truncation counting etc.
    keeps working through the wrapper.
    """

    async_dispatch = False

    def __init__(self, inner, plan: Optional[FaultPlan] = None,
                 schedule: Optional[FaultSchedule] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.inner = inner
        self.plan = plan or FaultPlan()
        self.schedule = schedule
        self._clock = clock
        self._t0: Optional[float] = None
        self.executions = 0
        self.injected_failures = 0
        self.injected_stalls = 0
        self.injected_corruptions = 0
        self.name = f"faulty({getattr(inner, 'name', 'backend')})"

    # WindVE wires its shared Telemetry into backends that left it None —
    # forward so the wrapped backend reports quality events as usual
    @property
    def telemetry(self):
        return getattr(self.inner, "telemetry", None)

    @telemetry.setter
    def telemetry(self, value):
        self.inner.telemetry = value

    def elapsed(self) -> float:
        """Tier-relative clock the wall-time schedule runs on."""
        if self._t0 is None:
            self._t0 = self._clock()
        return self._clock() - self._t0

    def embed_batch(self, queries: Sequence[Query]) -> List[np.ndarray]:
        i = self.executions
        self.executions += 1
        t = self.elapsed()
        if i in self.plan.stall:
            self.injected_stalls += 1
            time.sleep(self.plan.stall_s)
        if i in self.plan.fail or \
                (self.schedule is not None and self.schedule.is_down(t)):
            self.injected_failures += 1
            raise BackendError(f"injected fault (execution #{i}, t={t:.3f}s)")
        out = self.inner.embed_batch(queries)
        if i in self.plan.corrupt:
            self.injected_corruptions += 1
            out = _corrupted(out)
        return out


@dataclass
class FaultModel:
    """DES-side mirror of :class:`FaultyBackend` for a ``ModeledBackend``
    tier: the simulator consults it once per batch execution (same per-tier
    ordinal counter, same schedule vocabulary on simulated time).

    ``fail_latency_s`` prices failure *detection* — a raise is near-instant
    on the engine (default 0.0), but a collective timeout on real hardware
    is not, so the chaos bench can model slow failure discovery.
    """

    plan: FaultPlan = field(default_factory=FaultPlan)
    schedule: Optional[FaultSchedule] = None
    fail_latency_s: float = 0.0
    executions: int = 0
    injected_failures: int = 0
    injected_stalls: int = 0

    def __post_init__(self):
        if self.fail_latency_s < 0:
            raise ValueError("fail_latency_s must be >= 0")

    def reset(self) -> None:
        """Fresh ordinal counters — one DES run's fault state."""
        self.executions = 0
        self.injected_failures = 0
        self.injected_stalls = 0

    def outcome(self, now: float) -> Tuple[bool, float]:
        """One batch execution at simulated time ``now``.  Returns
        ``(failed, extra_s)``: ``failed`` batches cost ``fail_latency_s``
        *instead of* service time; surviving stalled batches cost
        ``extra_s`` *on top of* the modeled service time (what trips a
        latency-EWMA breaker)."""
        i = self.executions
        self.executions += 1
        extra = 0.0
        if i in self.plan.stall:
            self.injected_stalls += 1
            extra = self.plan.stall_s
        if i in self.plan.fail or \
                (self.schedule is not None and self.schedule.is_down(now)):
            self.injected_failures += 1
            return True, extra
        return False, extra
