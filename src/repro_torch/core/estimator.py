"""Linear-regression queue-depth estimator — paper §4.2.2 (Eq. 12).

Observed (and assumed by SLSC and Mooncake, per the paper): processing
latency is linear in concurrency,

    t_proc(C) = alpha_d * C + beta_d ,   alpha_d, beta_d >= 0.

Fit (alpha, beta) from a handful of profiling points, then the queue depth
for SLO ``T`` is the largest C with t(C) <= T:

    C_max = floor((T - beta) / alpha).

Also provides the stress-test procedure (Eqs. 7-10) the paper compares
against, so Table 3 can be reproduced with both methods.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class LatencyFit:
    alpha: float      # s per concurrent query
    beta: float       # s fixed (model-load / dispatch) cost
    r2: float

    def latency(self, concurrency) -> np.ndarray:
        return self.alpha * np.asarray(concurrency, dtype=float) + self.beta

    def max_concurrency(self, slo_s: float) -> int:
        """C_max = floor((T - beta)/alpha); 0 when even C=1 misses the SLO
        (the paper's Eq. 11 'CPU cannot be used' case)."""
        if self.latency(1) > slo_s:
            return 0
        if self.alpha <= 0:
            return 10 ** 9  # degenerate flat fit: unbounded under this model
        # epsilon guards exact-boundary float error ((1-0.4)/0.1 -> 5.999...)
        return int(np.floor((slo_s - self.beta) / self.alpha + 1e-9))


def fit_latency(concurrency: Sequence[float], latency_s: Sequence[float],
                ) -> LatencyFit:
    """Non-negative least squares fit of Eq. 12 (alpha, beta >= 0)."""
    c = np.asarray(concurrency, dtype=float)
    t = np.asarray(latency_s, dtype=float)
    if c.size < 2:
        raise ValueError("need >= 2 profiling points")
    A = np.stack([c, np.ones_like(c)], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(A, t, rcond=None)
    # enforce the paper's alpha,beta >= 0 constraint by projected refit
    if alpha < 0:
        alpha, beta = 0.0, float(t.mean())
    elif beta < 0:
        beta = 0.0
        alpha = float((c @ t) / (c @ c))
    pred = alpha * c + beta
    ss_res = float(((t - pred) ** 2).sum())
    ss_tot = float(((t - t.mean()) ** 2).sum()) or 1e-12
    return LatencyFit(float(alpha), float(beta), 1.0 - ss_res / ss_tot)


def quantized_fit(fit: LatencyFit, slope_scale: float) -> LatencyFit:
    """Re-price an Eq. 12 fit for a quantized serving path.

    Quantization (weight-only int8, or the W8A8 int8 x int8 trunk) shrinks
    the per-query service slope ``beta_s`` (our ``alpha``) by the measured
    GEMM-level speedup while the fixed dispatch/load cost ``beta`` stays —
    exactly the transform the paper's deployment-cost argument cares about,
    since depth is ``(SLO - beta) / alpha``.  ``slope_scale`` is the
    measured quantized/fp32 service-time ratio (< 1 when quantization
    helps; the ``w8a8_slope_scale`` metric in ``BENCH_quant_embed.json`` is
    the live source).  A scaled fit lets ``estimate_depth_per_bucket`` /
    ``PredictivePolicy`` price the quantized tier without a second full
    profiling sweep; ``r2`` is inherited (the residuals scale with the
    curve).
    """
    if slope_scale <= 0:
        raise ValueError(f"slope_scale must be positive, got {slope_scale}")
    return LatencyFit(fit.alpha * slope_scale, fit.beta, fit.r2)


def cached_fit(fit: LatencyFit, hit_rate: float) -> LatencyFit:
    """Re-price an Eq. 12 fit for a device tier sitting BEHIND a cache tier.

    With an exact-match cache at the head of the topology serving hit
    fraction ``p`` at ~zero latency and zero FLOPs, only ``(1 - p)`` of the
    arrival stream ever reaches the device: at arrival-level concurrency C
    the device's resident load is ``(1 - p) * C``, so the service curve the
    ARRIVAL stream experiences is

        t(C) = beta + alpha * (1 - p) * C ,

    i.e. the per-query slope shrinks by ``(1 - p)`` while the fixed cost
    stays — the same transform shape as ``quantized_fit``, with the scale
    coming from traffic skew instead of GEMM precision.  The resulting
    ``max_concurrency`` is the ARRIVAL-level depth,
    ``floor((T - beta) / (alpha * (1 - p)))`` — the honest Eq. 12 depth
    when a fraction p of traffic never reaches the device (its closed form
    is ``cost_model.cached_depth``).  ``hit_rate`` must be < 1: an
    all-hits tier needs no device to price.
    """
    if not 0.0 <= hit_rate < 1.0:
        raise ValueError(f"hit_rate must be in [0, 1), got {hit_rate}")
    return LatencyFit(fit.alpha * (1.0 - hit_rate), fit.beta, fit.r2)


def fanout_probe_points(devices: int,
                        base: Sequence[int] = (1, 4, 16, 64),
                        ) -> Tuple[int, ...]:
    """Probe points for an N-device fan-out tier: multiples of the device
    count.  A mesh-floored backend pads every batch below ``devices`` up to
    one identical per-device row count, so probing raw (1, 4, ...) on an
    8-device tier measures the SAME execution several times, fits a flat
    line and trips the estimator's unbounded-depth sentinel — each probe
    must exercise a distinct per-device row count."""
    d = max(1, int(devices))
    return tuple(d * int(c) for c in base)


def fit_from_model(model, probe_points: Sequence[int] = (1, 4, 16, 64),
                   length: int = 75) -> LatencyFit:
    """Eq. 12 fit of any ``latency(concurrency, length)`` curve — a DES
    ``DeviceModel``/``FanOutModel`` probed noise-free.

    This is how the capacity planner (and its admission controllers) get
    service pricing that is *consistent with the simulator they run in*:
    the same object the DES samples batch latencies from yields the fit
    ``AdmissionController``/``PredictivePolicy`` price against, so a
    planner verdict never hinges on two divergent calibrations.
    """
    pts = [(int(c), float(model.latency(int(c), length)))
           for c in probe_points]
    return fit_latency([p[0] for p in pts], [p[1] for p in pts])


def replica_fits(models: Mapping[str, object],
                 probe_points: Sequence[int] = (1, 4, 16, 64),
                 length: int = 75) -> Dict[str, "LatencyFit"]:
    """One Eq. 12 fit PER replica tier, keyed by the replica's tier name.

    Cross-replica predictive routing prices each replica's backlog against
    its OWN service curve — replicas are independently-failing (and, after
    a partial outage, independently-*degraded*) capacity units, so a
    single shared fit would misprice a replica running on fewer devices or
    across more hosts.  ``models`` maps replica tier name (e.g.
    ``NPU@h0r1``, see ``routing.replica_name``) to its ``DeviceModel`` /
    ``FanOutModel``; the returned dict plugs directly into
    ``PredictivePolicy(fits=...)`` and ``AdmissionController(fits=...)``.
    Probe points should come from ``fanout_probe_points`` at each
    replica's own device count when the replicas are meshes.
    """
    return {name: fit_from_model(model, probe_points, length)
            for name, model in models.items()}


def estimate_depth(profile_fn: Callable[[int], float], slo_s: float,
                   probe_points: Sequence[int] = (1, 4, 16, 64),
                   ) -> Tuple[int, LatencyFit]:
    """The paper's fast estimator: profile a FEW concurrency points, fit
    Eq. 12, and read the depth off the line (no exhaustive sweep)."""
    pts = [(c, profile_fn(c)) for c in probe_points]
    fit = fit_latency([p[0] for p in pts], [p[1] for p in pts])
    return fit.max_concurrency(slo_s), fit


def estimate_depth_per_bucket(
        profile_fn: Callable[[int, int], float], slo_s: float,
        bucket_lengths: Sequence[int],
        probe_points: Sequence[int] = (1, 4, 16, 64),
) -> Dict[int, Tuple[int, LatencyFit]]:
    """One Eq. 12 fit PER seq-length bucket: ``{bucket: (depth, fit)}``.

    ``profile_fn(concurrency, length)`` measures one batch at one padded
    length.  A single global fit averages the paper's Fig. 5 structure
    away — a bucketed (and quantized) CPU tier serves a 16-token bucket
    several times faster than a 96-token one, so its SLO-safe depth is a
    per-bucket quantity.  Feed the result to
    ``repro_torch.core.routing.LengthAwarePolicy.from_bucket_depths`` so the
    dispatch threshold follows the measured service curve instead of a
    hand-picked constant.
    """
    return {int(b): estimate_depth(lambda c: profile_fn(c, int(b)), slo_s,
                                   probe_points)
            for b in bucket_lengths}


def stress_test_depth(profile_fn: Callable[[int], float], slo_s: float,
                      step: int = 8, c_max_bound: int = 4096) -> int:
    """The baseline the paper compares against (§4.2.2): increase
    concurrency by ``step`` until the SLO breaks; depth = last passing C.
    The paper notes the step-size trade-off — a large step can overshoot the
    true peak (their Table 3 Atlas/2s row) — which this reproduces."""
    last_ok = 0
    c = step
    while c <= c_max_bound:
        if profile_fn(c) <= slo_s:
            last_ok = c
        else:
            break
        c += step
    return last_ok


def fine_tune_depth(profile_fn: Callable[[int], float], slo_s: float,
                    start: int, radius: int = 8) -> int:
    """Refine an estimated depth (the paper's 'fine-tuned' Table 3 column):
    search downward from start+radius and return the largest passing C —
    robust to estimates that overshoot on noisy devices."""
    for c in range(start + radius, 0, -1):
        if profile_fn(c) <= slo_s:
            return c
    return 0
