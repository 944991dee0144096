"""Single-card embedding serving backend: pinned staging ring and
stream-ordered async dispatch.

The port of the reference's mesh backend, on ONE CUDA device (fan-out over
several cards waits for the replica/mesh slice of the port):

* **resident serving weights** -- the ``dtype`` policy (fp32 oracle or
  bf16) is realised ONCE at load and the tree lives on the card; the
  ``pool_norm`` epilogue always accumulates fp32, so served vectors stay
  fp32 unit vectors.
* **staging ring** -- a small ring of pinned host (tokens, mask) buffers
  per (B, S) bucket.  A ``non_blocking`` copy from pinned memory reads the
  host buffer after the call has returned, so a slot must not be refilled
  while an enqueued copy may still read it: the ring rotates, and an
  overrun raises instead of silently rotating embeddings between batches.
* **async dispatch** -- ``embed_batch_async`` enqueues the host-to-device
  copy, the forward and a device-to-host copy into pinned memory on a CUDA
  stream the backend owns, records an event and returns; the fetch thunk
  waits on that event.  The engine worker double-buffers: batch N-1's fetch
  overlaps batch N's compute.

On ``device="cpu"`` the same code runs eagerly with plain host buffers (the
CPU tests' route).  Padding rows carry an all-zero mask and pool to zero
vectors that are dropped from the output.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bucketing import (BucketedEmbedderBackend,
                                        default_buckets, next_pow2)
from repro_torch.core.routing import Query
from repro_torch.core.telemetry import Telemetry


class ShardedEmbedderBackend(BucketedEmbedderBackend):
    """Bucketed embedder on one device with a pinned staging ring and
    stream-ordered async dispatch.

    ``dtype`` / ``async_dispatch`` default to the serving flags
    (``embed_dtype`` / ``embed_async``), so a default-constructed backend
    is the paper-faithful fp32 synchronous baseline.  ``devices`` (optional)
    names the device as a one-element list, as the reference's mesh
    argument did; more than one raises ``ValueError``.  Counters are
    inherited from the bucketed backend (``traces``, ``bucket_hits``,
    ``real_tokens``/``padded_tokens``, ``truncated``).
    """

    def __init__(self, cfg, params, max_tokens: int = 128, *,
                 device="cuda", devices: Optional[Sequence] = None,
                 dtype: Optional[str] = None,
                 async_dispatch: Optional[bool] = None,
                 min_seq_bucket: int = 16, min_batch_bucket: int = 1,
                 staging_slots: int = 4,
                 telemetry: Optional[Telemetry] = None,
                 prewarm_buckets: Sequence[Tuple[int, int]] = ()):
        import torch

        from repro_torch import perf_flags

        if devices is not None:
            devices = list(devices)
            if not devices:
                raise ValueError("need at least one device")
            if len(devices) > 1:
                raise ValueError(
                    f"ShardedEmbedderBackend serves on one device, got "
                    f"{len(devices)}; fan-out over several cards comes with "
                    f"the replica/mesh slice of the port")
            device = devices[0]
        flags = perf_flags.FLAGS
        dtype = flags.embed_dtype if dtype is None else dtype
        self.async_dispatch = (flags.embed_async if async_dispatch is None
                               else bool(async_dispatch))
        # the parent realises the dtype policy ONCE at load (serve_params
        # validates it) and moves the tree to the device
        super().__init__(cfg, params, max_tokens,
                         min_seq_bucket=min_seq_bucket,
                         min_batch_bucket=next_pow2(min_batch_bucket),
                         telemetry=telemetry, dtype=dtype, device=device)
        self.device_count = 1
        self.serve_dtype = self.compute_dtype
        self.name = (f"torch-sharded/{cfg.name}@{self.device}/{dtype}"
                     + ("+async" if self.async_dispatch else ""))

        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        if cuda:
            # the weights were written on the caller's stream; the serving
            # stream must not read them before those writes land
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

        # the staging ring: ``staging_slots`` pinned (tokens, mask) pairs
        # per (B, S) bucket.  The default depth covers the worker's
        # double-buffering discipline (at most 2 undelivered batches per
        # worker) for up to 2 workers; callers sharing one backend across
        # more workers, or holding more fetches back, must raise
        # ``staging_slots`` to 2 x workers.
        self._staging_slots = max(2, int(staging_slots))
        self._staging: dict = {}        # (bb, sb) -> list[(toks, mask)]
        self._staging_use: dict = {}    # (bb, sb) -> fills so far
        self._staging_lock = threading.Lock()
        # overrun guard: staged-but-unfetched executions per bucket.  A slot
        # is reused ``staging_slots`` stagings later; if that many are still
        # pending, refilling would overwrite host data an enqueued
        # non_blocking copy may still read -- the served embeddings would be
        # silently ROTATED between batches.  Raise loudly instead (the
        # documented fix: staging_slots >= 2 x worker threads).  Every
        # fetch thunk returned by ``embed_batch_async`` must be called
        # exactly once -- dropping one permanently occupies its slots.
        self._staging_pending: dict = {}   # (bb, sb) -> in-flight stagings
        self._staging_tl = threading.local()

        if prewarm_buckets:
            self.prewarm(prewarm_buckets)

    # ------------------------------------------------------------------
    def warm_grid(self, max_batch: int) -> List[Tuple[int, int]]:
        """The enumerable (B, S) grid this backend serves ``max_batch`` with
        -- feed to ``prewarm``."""
        return default_buckets(max(max_batch, self.min_batch_bucket),
                               self.max_tokens, self.min_seq_bucket,
                               self.min_batch_bucket)

    def _serving_stream(self):
        """Kernels launch on the calling thread's current stream: make it
        the backend's own for the work of one batch."""
        if self._stream is None:
            return contextlib.nullcontext()
        return self._torch.cuda.stream(self._stream)

    def _new_slot(self, bb: int, sb: int):
        torch = self._torch
        pin = self._stream is not None
        return (torch.zeros((bb, sb), dtype=torch.int32, pin_memory=pin),
                torch.zeros((bb, sb), dtype=torch.float32, pin_memory=pin))

    def _stage_chunk(self, chunk: Sequence[Query], bb: int, sb: int):
        """Tokenize into the (bb, sb) bucket's next staging slot and enqueue
        its copy to the device.  The slot rotates through the ring so a
        buffer is only refilled ``staging_slots`` batches later -- by which
        point the double-buffered worker has fetched (hence the device has
        consumed) the batch that read it.  The lock covers slot pick + fill
        + copy, so worker threads can share one backend (raise
        ``staging_slots`` beyond 2 workers)."""
        key = (bb, sb)
        with self._staging_lock:
            pending = self._staging_pending.get(key, 0)
            if pending >= self._staging_slots:
                raise RuntimeError(
                    f"staging ring overrun on bucket {key}: {pending} "
                    f"staged batches not yet fetched with staging_slots="
                    f"{self._staging_slots}.  Refilling now would overwrite "
                    f"host buffers an enqueued copy may still read "
                    f"(rotated embeddings).  More than 2 worker threads — "
                    f"or callers holding fetches back beyond the worker's "
                    f"double-buffering — share this backend: construct it "
                    f"with staging_slots >= 2 x workers.")
            self._staging_pending[key] = pending + 1
            try:
                ring = self._staging.setdefault(key, [])
                use = self._staging_use.get(key, 0)
                self._staging_use[key] = use + 1
                if len(ring) < self._staging_slots:
                    ring.append(self._new_slot(bb, sb))
                toks_t, mask_t = ring[use % len(ring)]
                _, _, real, truncated = self._tokenize(
                    chunk, sb, out=(toks_t.numpy(), mask_t.numpy()))
                td = toks_t.to(self.device, non_blocking=True)
                md = mask_t.to(self.device, non_blocking=True)
            except Exception:
                # failed BEFORE the caller could capture the key for its
                # own rollback: undo the pending count here or the bucket
                # is poisoned into spurious overrun errors forever
                n = self._staging_pending.get(key, 1) - 1
                if n > 0:
                    self._staging_pending[key] = n
                else:
                    self._staging_pending.pop(key, None)
                raise
        keys = getattr(self._staging_tl, "keys", None)
        if keys is not None:        # capture for the enclosing async call
            keys.append(key)
        return td, md, real, truncated

    def _release_staging(self, keys) -> None:
        with self._staging_lock:
            for k in keys:
                n = self._staging_pending.get(k, 0) - 1
                if n > 0:
                    self._staging_pending[k] = n
                else:
                    self._staging_pending.pop(k, None)

    def embed_batch_async(self, queries: Sequence[Query]
                          ) -> Callable[[], List[np.ndarray]]:
        """Enqueue every chunk of the batch; returns the deferred fetch.

        On the card this costs staging + launch only: the copies in, the
        forward and the copy of the results into pinned host memory are
        all enqueued on the backend's stream, followed by an event.  The
        fetch thunk waits on the event -- the engine worker calls it one
        batch late (double buffering) so the copy overlaps the next
        batch's compute.
        """
        torch = self._torch
        self._staging_tl.keys = []
        try:
            with self._serving_stream():
                outs = []
                for n, dev in self._enqueue_chunks(queries):
                    if self._stream is None:
                        outs.append(dev[:n])
                        continue
                    host = torch.empty((n, dev.shape[1]), dtype=dev.dtype,
                                       pin_memory=True)
                    host.copy_(dev[:n], non_blocking=True)
                    outs.append(host)
                done = None
                if self._stream is not None:
                    done = torch.cuda.Event()
                    done.record(self._stream)
        except Exception:
            # roll back this call's pending counts (e.g. the overrun guard
            # fired on a later chunk) so one failed batch cannot poison the
            # accounting for every batch after it
            self._release_staging(self._staging_tl.keys)
            raise
        finally:
            keys, self._staging_tl.keys = self._staging_tl.keys, None

        def fetch() -> List[np.ndarray]:
            try:
                if done is not None:
                    done.synchronize()
                out: List[np.ndarray] = []
                for host in outs:
                    arr = host.numpy().copy()
                    out.extend(arr[i] for i in range(len(arr)))
            finally:
                # results copied out: the batch consumed its staged
                # inputs, so the slots may rotate again
                self._release_staging(keys)
            return out

        return fetch

    def embed_batch(self, queries: Sequence[Query]) -> List[np.ndarray]:
        # route the sync path through the async one so staging-pending
        # accounting (stage -> fetch) stays balanced for every caller
        return self.embed_batch_async(queries)()
