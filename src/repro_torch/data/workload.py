"""Synthetic data pipeline: training token streams and serving query loads.

Training: an infinite deterministic stream of zipfian token batches with
next-token labels (no external corpus in this offline container).
Serving: query generators matching the paper's workload (§5.1.3 — default
length 75 tokens, the typical RAG text-segmentation setting; Fig. 5 sweeps
lengths; Fig. 2 diurnal rate curve lives in core.simulator.diurnal_trace).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class TrainBatchSpec:
    batch: int
    seq_len: int
    vocab_size: int


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-ish distribution over the vocab (natural-language-like ranks)."""
    ranks = rng.zipf(1.3, size=shape)
    return (np.minimum(ranks, vocab - 1)).astype(np.int32)


class TokenStream:
    """Deterministic, restartable training stream: batch dict per step."""

    def __init__(self, spec: TrainBatchSpec, seed: int = 0,
                 extra: Optional[Dict[str, tuple]] = None):
        self.spec = spec
        self.seed = seed
        self.extra = extra or {}
        self._step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self._step))
        self._step += 1
        s = self.spec
        toks = _zipf_tokens(rng, (s.batch, s.seq_len + 1), s.vocab_size)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for name, shape in self.extra.items():
            out[name] = rng.standard_normal((s.batch, *shape)).astype(np.float32)
        return out

    @property
    def step(self) -> int:
        return self._step

    def restore(self, step: int) -> None:
        self._step = step


def query_lengths(n: int, mean: int = 75, jitter: float = 0.0,
                  seed: int = 0) -> List[int]:
    """Paper workload: fixed 75-token queries by default; optional jitter.

    With ``jitter > 0`` lengths are ``Normal(mean, jitter * mean)`` draws
    rounded to the nearest integer and clamped SYMMETRICALLY into
    ``[1, 2 * mean - 1]``: the old path truncated toward zero (biasing every
    draw short) and clamped only the low side, so heavy jitter silently
    shifted the realized mean.  Rounding plus the symmetric window keeps
    the sample mean at ``mean`` no matter how large ``jitter`` gets."""
    if jitter <= 0:
        return [mean] * n
    rng = np.random.default_rng(seed)
    hi = max(1, 2 * mean - 1)
    return [int(np.clip(round(float(x)), 1, hi))
            for x in rng.normal(mean, jitter * mean, size=n)]


def make_queries(n: int, vocab: int, length: int = 75,
                 seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [_zipf_tokens(rng, (length,), vocab) for _ in range(n)]


def zipf_queries(n: int, vocab: int, alpha: float = 1.1, unique: int = 64,
                 seed: int = 0, length: int = 75) -> List[np.ndarray]:
    """Deterministic Zipf-skewed repeat-query trace (the cache workload).

    Draws ``n`` queries from a pool of ``unique`` distinct token payloads
    with rank-k probability proportional to ``k ** -alpha`` — the skew real
    query streams show (EdgeRAG's motivating observation): a handful of hot
    queries dominate, the tail is long.  Repeats are the IDENTICAL token
    content (same array object), so an exact-match cache keyed on token
    hashes sees them as hits.  ``alpha ~ 1.1`` with ``unique << n`` yields
    a >= 50% theoretical repeat rate (at most ``unique`` first occurrences
    in ``n`` draws); ``alpha = 0`` degrades to uniform sampling over the
    pool.  Fully deterministic in ``seed`` — reused by the cache microbench
    and the tier-1 suites, same trace every run."""
    if n < 0:
        raise ValueError("n must be >= 0")
    if unique < 1:
        raise ValueError("need at least one unique query")
    if alpha < 0:
        raise ValueError("alpha must be >= 0 (0 == uniform)")
    rng = np.random.default_rng(seed)
    pool = [_zipf_tokens(rng, (length,), vocab) for _ in range(unique)]
    p = np.arange(1, unique + 1, dtype=np.float64) ** -alpha
    p /= p.sum()
    idx = rng.choice(unique, size=n, p=p)
    return [pool[i] for i in idx]


def flash_crowd_trace(n_seconds: int, base_rate: float, burst_mult: float,
                      burst_start: float, burst_len: float,
                      length: int = 75, seed: int = 0
                      ) -> List[Tuple[float, int]]:
    """Flash-crowd arrival trace: baseline Poisson with a seeded
    multiplicative burst window — the overload scenario admission control
    and the capacity planner are sized against.

    Arrivals follow a Poisson process at ``base_rate`` queries/s, except
    inside ``[burst_start, burst_start + burst_len)`` where the rate is
    ``base_rate * burst_mult`` (a link on the front page, a retry storm, a
    failover from a sibling cluster).  Returns sorted ``(time, length)``
    pairs ready for ``ServingSimulator.run`` — same shape as
    ``simulator.diurnal_trace``, and fully deterministic in ``seed`` like
    ``zipf_queries`` so planner sweeps and CI replays see the same crowd.
    """
    if n_seconds < 0:
        raise ValueError("n_seconds must be >= 0")
    if base_rate < 0:
        raise ValueError("base_rate must be >= 0")
    if burst_mult < 1.0:
        raise ValueError("burst_mult must be >= 1 (1 == no burst)")
    if burst_len < 0:
        raise ValueError("burst_len must be >= 0")
    from repro_torch.core.simulator import poisson  # core stays import-light here
    rng = random.Random(seed)
    out: List[Tuple[float, int]] = []
    for s in range(int(n_seconds)):
        rate = base_rate
        if burst_start <= s < burst_start + burst_len:
            rate *= burst_mult
        for _ in range(poisson(rng, rate)):
            out.append((s + rng.random(), length))
    out.sort()
    return out
