"""Online queue-depth re-calibration — beyond-paper extension of §4.2.2.

The paper fits Eq. 12 once, offline, from dedicated profiling runs.  In
production the (alpha, beta) drift (thermal throttling, co-located load,
query-length mix — their §5.4 shows both knobs move the curve), so WindVE
here keeps a rolling window of REAL (batch_size, service_latency)
observations per device and periodically refits the line, shrinking or
growing the queue depths while the SLO contract holds.

The estimator stays the paper's exact linear model; only the data source
changes (live traffic instead of offline probes).  Observations can also be
kept per seq-length *bucket* (``observe(..., bucket=...)``), yielding one
fit per (device, bucket) — the granularity ``PredictivePolicy`` prices
candidate tiers at, and ``attach(..., policy=...)`` streams refreshed fits
into a live policy through the engine's batch-completion hook.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.estimator import LatencyFit, fit_latency


@dataclass
class Observation:
    concurrency: int
    latency_s: float


class OnlineCalibrator:
    """Rolling-window Eq. 12 refit per device (and per length bucket)."""

    def __init__(self, slo_s: float, window: int = 256,
                 min_points: int = 8, headroom: float = 0.95):
        self.slo = slo_s
        self.window = window
        self.min_points = min_points
        self.headroom = headroom          # aim below the SLO by this factor
        # keys: device name (tier-level window) or (device, bucket)
        self._obs: Dict[Any, Deque[Observation]] = {}
        self._lock = threading.Lock()

    def observe(self, device: str, concurrency: int, latency_s: float,
                bucket: Any = None) -> None:
        with self._lock:
            q = self._obs.setdefault(device, deque(maxlen=self.window))
            q.append(Observation(concurrency, latency_s))
            if bucket is not None:
                qb = self._obs.setdefault((device, bucket),
                                          deque(maxlen=self.window))
                qb.append(Observation(concurrency, latency_s))

    def n_observations(self, device: str, bucket: Any = None) -> int:
        key = device if bucket is None else (device, bucket)
        with self._lock:
            return len(self._obs.get(key, ()))

    def buckets_for(self, device: str) -> List[Any]:
        """Buckets this device has per-bucket observations for."""
        with self._lock:
            return [k[1] for k in self._obs
                    if isinstance(k, tuple) and k[0] == device]

    def fit(self, device: str, bucket: Any = None) -> Optional[LatencyFit]:
        key = device if bucket is None else (device, bucket)
        with self._lock:
            obs = list(self._obs.get(key, ()))
        # need at least two distinct concurrency levels for a line
        if len(obs) < self.min_points or \
                len({o.concurrency for o in obs}) < 2:
            return None
        return fit_latency([o.concurrency for o in obs],
                           [o.latency_s for o in obs])

    def suggest_depth(self, device: str,
                      current: int) -> Tuple[int, Optional[LatencyFit]]:
        """New depth for ``device`` (falls back to ``current`` if the window
        is not informative yet)."""
        f = self.fit(device)
        if f is None:
            return current, None
        return max(f.max_concurrency(self.slo * self.headroom), 0), f


def attach(engine, calibrator: OnlineCalibrator, refit_every: int = 64,
           policy: Any = None,
           bucket_fn: Optional[Callable[[Any], Any]] = None):
    """Wire a calibrator into a running WindVE engine: every completed batch
    feeds an observation; every ``refit_every`` completions the depths are
    re-estimated and applied atomically.

    Uses the engine's first-class batch-completion hook (the seed
    monkey-patched every backend's ``embed_batch``, which broke per-worker
    model ownership and was invisible to other instrumentation).  Returns
    the hook so callers can ``engine.remove_batch_hook(hook)`` to detach.

    ``policy`` (optional): a :class:`~repro_torch.core.routing.PredictivePolicy`
    (anything with ``update(tier, fit, bucket=None)``) to stream refreshed
    fits into on every refit — the latency-predictive dispatch then follows
    the LIVE service curve, not the offline calibration it was seeded with.
    ``bucket_fn`` (``Query -> bucket``) keys the per-bucket windows by the
    batch's LONGEST member — service latency follows the max length (one
    padded execution), so that is the length the observation belongs to.
    Under bucketed dispatch every popped batch is single-bucket and this is
    simply the batch's bucket; on tiers draining mixed-length batches it
    avoids filing a long batch's latency under a short query's bucket.
    """
    done = {"n": 0}

    def on_batch(tier: str, batch, service_latency_s: float) -> None:
        bucket = bucket_fn(max(batch, key=lambda q: q.length)) \
            if (bucket_fn and batch) else None
        calibrator.observe(tier, len(batch), service_latency_s, bucket=bucket)
        done["n"] += len(batch)
        if done["n"] >= refit_every:
            done["n"] = 0
            for dev, q in engine.qm.queues.items():
                new, fit = calibrator.suggest_depth(dev, q.depth)
                if new > 0 and new != q.depth:
                    engine.qm.set_depth(dev, new)
                if policy is not None:
                    if fit is not None:
                        policy.update(dev, fit)
                    for b in calibrator.buckets_for(dev):
                        fb = calibrator.fit(dev, bucket=b)
                        if fb is not None:
                            policy.update(dev, fb, bucket=b)

    return engine.add_batch_hook(on_batch)
