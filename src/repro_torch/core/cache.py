"""Exact-match embedding cache — the zero-cost tier at the head of the topology.

Real query streams are heavily skewed (EdgeRAG builds its whole system
around online embedding caches; the RAG systems-trade-offs literature shows
retrieval recomputing the same hot queries over and over).  A cache hit is
a query served at ~zero latency and zero FLOPs, which raises effective
concurrency past anything a faster backend can buy: with hit fraction p,
only (1 - p) of the arrival stream ever reaches a device, so the paper's
deployment-cost lever (concurrency capacity, Eqs. 5-6) scales by 1/(1-p)
(see ``repro_torch.core.estimator.cached_fit`` for the Eq. 12 side).

The cache is surfaced as a first-class :class:`~repro_torch.core.routing.TierSpec`
with ``cache=`` set (see :func:`cache_tier`), placed at the head of the
topology list.  ``QueueManager.dispatch`` consults cache tiers BEFORE policy
dispatch: a hit fills ``Query.emb`` and returns the cache tier's name — the
threaded engine then resolves the future immediately and the DES completes
the query at +0 service time.  Misses fall through to the normal policy
cascade, and the drivers admit each computed embedding back through
``QueueManager.admit`` on batch completion (insert happens BEFORE the future
resolves, so a caller that has seen a result can rely on the key being
cached).

Keys are token-content hashes (:func:`cache_key`): two queries embed
identically iff their token payloads are identical, so exact-match hits are
bitwise-faithful by construction.  Payload-less queries hash to their
length — ``TorchEmbedderBackend._tokenize`` derives the same deterministic
synthetic stream for every payload-less query of one length, so this is the
exact-match key for them too (and what makes the DES, whose queries carry
no tokens, cache deterministically).

Thread-safe (one lock around the LRU) for the engine; fully deterministic
(ordered dict, no wall-clock reads — callers pass ``now``) for the DES.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Hashable, Optional, Tuple

import numpy as np

from repro_torch.core.routing import TierSpec

CACHE = "CACHE"


def cache_key(query) -> Hashable:
    """Exact-match key for a query: a digest of its token payload.

    * payload arrays/lists hash by canonical int64 token bytes (two payloads
      collide iff their token sequences are identical — dtype/container
      differences do not split the key);
    * payload-less queries key on their length alone, matching the
      deterministic synthetic stream ``_tokenize`` expands them into.
    """
    p = getattr(query, "payload", None)
    if p is None:
        return ("synthetic", int(getattr(query, "length", 0)))
    toks = np.asarray(p, dtype=np.int64).ravel()
    return ("tokens", toks.size,
            hashlib.blake2b(toks.tobytes(), digest_size=16).digest())


@dataclass
class CacheEntry:
    value: Any          # the served embedding (engine) or None (DES)
    nbytes: int
    t: float            # insert time (driver clock: monotonic or sim time)


def _value_nbytes(value: Any) -> int:
    if value is None:
        return 0
    nb = getattr(value, "nbytes", None)
    return int(nb) if nb is not None else 0


class EmbeddingCache:
    """Token-hash-keyed LRU over served embeddings.

    ``capacity`` bounds entries; ``capacity_bytes`` (optional) additionally
    bounds the summed ``value.nbytes``.  Values are stored as read-only
    copies so a caller mutating a served array cannot corrupt later hits —
    the bitwise-identical-serving contract holds for the cache's lifetime.

    ``get``/``put`` take ``now`` explicitly instead of reading a clock, so
    the DES drives the cache on simulated time and two seeded runs replay
    identical hit/miss/evict sequences.
    """

    def __init__(self, capacity: int = 1024,
                 capacity_bytes: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        if capacity_bytes is not None and capacity_bytes < 1:
            raise ValueError("capacity_bytes must be >= 1 when set")
        self.capacity = int(capacity)
        self.capacity_bytes = capacity_bytes
        self._lru: "OrderedDict[Hashable, CacheEntry]" = OrderedDict()
        self._nbytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def get(self, query, now: float = 0.0) -> Optional[CacheEntry]:
        """Exact-match lookup; a hit refreshes recency.  Returns the live
        entry (value + insert time, so the caller can derive staleness)."""
        k = cache_key(query)
        with self._lock:
            entry = self._lru.get(k)
            if entry is None:
                self.misses += 1
                return None
            self._lru.move_to_end(k)
            self.hits += 1
            return entry

    def put(self, query, value: Any, now: float = 0.0) -> int:
        """Admit one computed embedding; returns how many entries were
        evicted to make room (0 for a plain insert/refresh).  A value that
        alone exceeds ``capacity_bytes`` is not admitted (it would evict
        the whole cache and then itself)."""
        if isinstance(value, np.ndarray):
            value = value.copy()
            value.setflags(write=False)
        nb = _value_nbytes(value)
        if self.capacity_bytes is not None and nb > self.capacity_bytes:
            return 0
        k = cache_key(query)
        with self._lock:
            old = self._lru.pop(k, None)
            if old is not None:
                self._nbytes -= old.nbytes
            self._lru[k] = CacheEntry(value, nb, float(now))
            self._nbytes += nb
            self.inserts += 1
            evicted = 0
            while len(self._lru) > self.capacity or (
                    self.capacity_bytes is not None
                    and self._nbytes > self.capacity_bytes):
                _, victim = self._lru.popitem(last=False)
                self._nbytes -= victim.nbytes
                evicted += 1
            self.evictions += evicted
            return evicted

    def clear(self) -> None:
        """Drop every entry AND the counters — one DES run's cache state."""
        with self._lock:
            self._lru.clear()
            self._nbytes = 0
            self.hits = self.misses = self.inserts = self.evictions = 0


def cache_tier(entries: int, capacity_bytes: Optional[int] = None,
               name: str = CACHE) -> TierSpec:
    """A zero-latency cache TierSpec for the head of a topology list.

    ``depth=0``: the cache holds no queue and no in-flight work — a hit
    completes at dispatch, so it contributes no backlog for policies to
    price and no C^max to ``max_concurrency`` (its capacity contribution is
    the hit-rate uplift, see ``cost_model.cache_uplift``).  Both drivers
    accept the spec as-is: the engine needs no backend and the DES no
    latency model for it.
    """
    return TierSpec(name, 0,
                    cache=EmbeddingCache(entries, capacity_bytes))
