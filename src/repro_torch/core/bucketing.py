"""Shape-bucketed execution for the embedding hot path.

The paper's deployment-cost argument makes per-batch service time the lever
behind concurrency-per-device, and its Fig. 5 shows the query-length
distribution is structured — yet the fixed-shape backend pads every batch to
the global ``max_tokens`` window and meets a new shape for every distinct
batch size.  This module exploits the structure:

* ``next_pow2`` / ``bucket_length`` — round batch size and sequence length
  up to power-of-two buckets, so the set of executed shapes is SMALL and
  ENUMERABLE (O(log max_batch x log max_tokens) instead of one shape per
  raw batch size) and padding stops at the bucket boundary.
* ``length_bucket_fn`` — a ``TierSpec.bucket_fn``: the queue drains queries
  grouped by length bucket (FIFO within the bucket, see
  ``repro_torch.core.routing.BoundedQueue.pop_batch``), so one batch never pads
  its short queries to a long straggler's length.
* ``BucketedEmbedderBackend`` — a drop-in ``TorchEmbedderBackend`` that
  pads each batch only to its (B_bucket, S_bucket) bucket and supports
  eager pre-warming (``prewarm(default_buckets(...))``): every shape a
  serving process will run executes once at startup, so serving meets no
  new shape (``traces`` stays put).

Correctness relies on the embedder being padding-invariant: padded key
positions are masked out of every attention softmax (``kv_mask`` in
``repro_torch.models.embedder.embed``), so the same query embeds to the same
vector whether the batch is padded to 32 or 128 tokens.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.core.routing import Query
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.windve import TorchEmbedderBackend


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def bucket_length(length: int, min_bucket: int = 16,
                  max_bucket: int = 128) -> int:
    """Round a token count up to its power-of-two bucket in
    [min_bucket, max_bucket] (max_bucket also caps: longer payloads are
    truncated by the backend and counted in telemetry)."""
    return min(max(next_pow2(length), min_bucket), max_bucket)


def length_bucket_fn(min_bucket: int = 16, max_bucket: int = 128
                     ) -> Callable[[Query], int]:
    """A ``TierSpec.bucket_fn``: group queries by padded-length bucket."""

    def fn(q: Query) -> int:
        return bucket_length(q.length, min_bucket, max_bucket)

    return fn


def default_buckets(max_batch: int, max_tokens: int = 128,
                    min_seq_bucket: int = 16, min_batch_bucket: int = 1
                    ) -> List[Tuple[int, int]]:
    """The full (B_bucket, S_bucket) grid — the enumerable compile-cache
    key space, suitable for ``BucketedEmbedderBackend.prewarm``."""
    bs: List[int] = []
    b = max(1, min_batch_bucket)
    while b < max_batch:
        bs.append(b)
        b *= 2
    bs.append(next_pow2(max_batch))
    ss: List[int] = []
    s = max(1, min_seq_bucket)
    while s < max_tokens:
        ss.append(s)
        s *= 2
    ss.append(max_tokens)
    return [(b, s) for b in bs for s in ss]


class BucketedEmbedderBackend(TorchEmbedderBackend):
    """Length-aware PyTorch embedder: pad to the (B, S) bucket, not the max.

    The sequence dim rounds up to its power-of-two bucket (short batches
    stop paying full-window FLOPs).  The batch dim uses a *binary
    decomposition plan* (``_batch_plan``): a batch of 9 runs as pow2 chunks
    8 + 1 rather than padding up to 16, so batch-dim padding rows all but
    vanish while the compiled-shape space stays the pow2 grid.  Each chunk
    buckets its OWN sequence length, and any padding rows carry an all-zero
    mask and are dropped from the output.

    Counters (shared with the fixed backend, which tracks the same):
    ``traces`` (first executions of a new shape), ``bucket_hits`` (chunk
    launches served from an already-warm bucket), ``real_tokens`` / ``padded_tokens`` (padding
    waste; see ``padded_waste``), ``truncated``.
    """

    def __init__(self, cfg, params, max_tokens: int = 128, *,
                 min_seq_bucket: int = 16, min_batch_bucket: int = 1,
                 telemetry: Telemetry | None = None,
                 dtype: str | None = None, device="cuda",
                 prewarm_buckets: Sequence[Tuple[int, int]] = ()):
        super().__init__(cfg, params, max_tokens, telemetry=telemetry,
                         dtype=dtype, device=device)
        self.name = (f"torch-{self.device.type}-bucketed/{cfg.name}"
                     + (f"/{dtype}" if dtype else ""))
        self.min_seq_bucket = min_seq_bucket
        self.min_batch_bucket = min_batch_bucket
        self.bucket_hits = 0
        self._buckets: set = set()
        self._bucket_lock = threading.Lock()
        if prewarm_buckets:
            self.prewarm(prewarm_buckets)

    # ------------------------------------------------------------------
    def bucket_shape(self, batch: int, seq_len: int) -> Tuple[int, int]:
        """(B, S) -> the (B_bucket, S_bucket) a single-launch batch would
        execute at (the largest chunk of ``_batch_plan``)."""
        return (self._batch_plan(batch)[0],
                bucket_length(seq_len, self.min_seq_bucket, self.max_tokens))

    def _batch_plan(self, batch: int) -> List[int]:
        """Pow2 chunk sizes covering ``batch`` with minimal padding rows.

        Greedy binary decomposition (13 -> 8 + 4 + 1), with chunks below
        ``min_batch_bucket`` rounded up to it; when a single rounded-up
        launch pads no more rows than the decomposition, prefer the single
        launch (fewer per-batch fixed costs — the paper's Eq. 12 beta is
        per execution).
        """
        g = max(1, self.min_batch_bucket)
        greedy: List[int] = []
        rem = batch
        while rem > 0:
            c = max(1 << (rem.bit_length() - 1), g)   # largest pow2 <= rem
            greedy.append(c)
            rem -= min(c, rem)
        single = max(next_pow2(batch), g)
        return [single] if single <= sum(greedy) else greedy

    @property
    def warm_buckets(self) -> frozenset:
        """Buckets that have executed at least once."""
        return frozenset(self._buckets)

    def prewarm(self, buckets: Iterable[Tuple[int, int]]) -> int:
        """Eagerly run the given (B_bucket, S_bucket) shapes once so serving
        meets no new shape.  Returns how many were new."""
        new = 0
        for bb, sb in buckets:
            key = (int(bb), int(sb))
            with self._bucket_lock:
                if key in self._buckets:
                    continue
            self._warm(key)
            # mark warm only AFTER the run succeeds, so an interrupted
            # prewarm can be retried instead of silently no-op'ing
            with self._bucket_lock:
                self._buckets.add(key)
            new += 1
        return new

    def _warm(self, key: Tuple[int, int]) -> None:
        """Run one all-padding batch of shape ``key`` and wait for it."""
        torch = self._torch
        toks = torch.zeros(key, dtype=torch.int32, device=self.device)
        mask = torch.ones(key, dtype=torch.float32, device=self.device)
        self._embed(toks, mask).cpu()         # waits for the device

    @staticmethod
    def _qlen(q: Query) -> int:
        return len(q.payload) if q.payload is not None else q.length

    def _stage_chunk(self, chunk: Sequence[Query], bb: int, sb: int):
        """Tokenize one chunk into (bb, sb) device-ready inputs.

        Returns (tokens, mask, real_tokens, truncated).  The sharded backend
        overrides this with its pinned staging ring and stream-ordered
        copy; here fresh host arrays are copied to the device.  Padding rows
        beyond the chunk stay all-zero (dropped by pooling).
        """
        toks, mask, real, truncated = self._tokenize(
            chunk, sb, out=(np.zeros((bb, sb), np.int32),
                            np.zeros((bb, sb), np.float32)))
        return (self._to_device(toks), self._to_device(mask), real,
                truncated)

    def _enqueue_chunks(self, queries: Sequence[Query]
                        ) -> List[Tuple[int, object]]:
        """The single chunking/accounting path for every bucketed backend:
        decompose the batch (``_batch_plan``), bucket each chunk's own
        sequence length, stage (``_stage_chunk``), count, and run the
        embedder (on the card, enqueued on the current stream).  Returns [(chunk_len, device_result), ...] in query
        order; results are fetched by the caller (sync or deferred)."""
        handles: List[Tuple[int, object]] = []
        start = 0
        for bb in self._batch_plan(len(queries)):
            chunk = queries[start:start + bb]
            start += len(chunk)
            # pad only to this chunk's own bucket; truncation still happens
            # at the global max_tokens cap, exactly like the fixed backend
            longest = max(min(self._qlen(q), self.max_tokens) for q in chunk)
            sb = bucket_length(longest, self.min_seq_bucket, self.max_tokens)
            toks, mask, real, truncated = self._stage_chunk(chunk, bb, sb)
            self._record_truncations(truncated)
            with self._bucket_lock:
                if (bb, sb) in self._buckets:
                    self.bucket_hits += 1
                else:
                    self._buckets.add((bb, sb))
                self.real_tokens += real
                self.padded_tokens += bb * sb - real
            handles.append((len(chunk), self._embed(toks, mask)))
        return handles

    def embed_batch(self, queries: Sequence[Query]) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        for n, dev in self._enqueue_chunks(queries):
            emb = dev.cpu().numpy()
            out.extend(emb[i] for i in range(n))
        return out
