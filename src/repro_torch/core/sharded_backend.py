"""Device-sharded embedding serving backend: the embed tier fanned out
over a ``(data, model)`` mesh, a pinned staging ring and stream-ordered
async dispatch.

The port of the reference's mesh backend:

* **mesh fan-out** -- one embedding tier runs over a ``('data', 'model')``
  mesh (``launch.mesh.make_serve_mesh`` over a pool clamped to a power of
  two, ``_serve_devices``, or a caller's mesh) whose data axes hold N
  positions.  Every padded batch is split into N equal row blocks under
  ``serve_embed_shardings``' batch spec and the rows come back in order.
  The batch bucket is floored at N so every block has rows.  With no
  ``model`` axis each block runs its forward on its own position's
  serving stream.  A device may appear several times in the pool (one
  card carrying several logical shards); one device is the single-card
  backend.
* **tensor parallel** -- with a ``model`` axis of M > 1 the serve-mode
  specs split the weights over it (``wq``/``wk``/``wv``/``w_in`` by
  columns, ``wo``/``w_out`` by rows, the vocab; an int8 tree's
  ``_scale`` leaves whole), and each data group's M positions run one
  forward together (``models.tp.embed``): each layer on the position's
  heads and weight blocks, the partial sums and gathers explicit
  collectives, the vectors gathered over the data axes to the first
  position.  A collective reads blocks that other positions wrote, so
  every position on one device runs on one serving stream (the stream
  of the device's first position) and the forward runs with each
  device's serving stream current; cross-device copies are ordered by
  PyTorch against the current streams of both devices.
* **resident serving weights** -- the ``dtype`` policy (fp32 oracle,
  bf16, int8 or int8_w8a8) is realised ONCE at load on the home device
  (the mesh's first), then placed on every device with
  ``parallel.sharding.shard`` under the serve-mode specs (replicated
  leaves: positions on one device share one copy).  The ``pool_norm``
  epilogue always accumulates fp32, so served vectors stay fp32 unit
  vectors.
* **staging ring** -- a small ring of pinned host (tokens, mask) buffers
  per (B, S) bucket.  A ``non_blocking`` copy from pinned memory reads the
  host buffer after the call has returned, so a slot must not be refilled
  while an enqueued copy may still read it: the ring rotates, and an
  overrun raises instead of silently rotating embeddings between batches.
  A batch counts once against the ring, whatever the fan-out.
* **async dispatch** -- ``embed_batch_async`` enqueues, on each device's
  stream, the copy of its rows in, the forward and a copy of its results
  into pinned memory, records an event on every stream and returns; the
  fetch thunk waits on the events.  The engine worker double-buffers:
  batch N-1's fetch overlaps batch N's compute.

On CPU devices the same code runs eagerly with plain host buffers (the
CPU tests' route, ``[torch.device("cpu")] * 8`` standing in for the
reference's forced 8-device host).  Padding rows carry an all-zero mask
and pool to zero vectors that are dropped from the output.
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
from repro_torch.core.windve import resolve_device


def _serve_devices(devices=None) -> list:
    """The devices the serve mesh fans out over (default: every visible
    card), clamped to a power of two so every pow2 batch bucket divides the
    data axis exactly."""
    from repro_torch.launch.mesh import visible_devices

    devices = list(visible_devices() if devices is None else devices)
    if not devices:
        raise ValueError("need at least one device")
    usable = 1 << (len(devices).bit_length() - 1)   # largest pow2 <= n
    return [resolve_device(d) for d in devices[:usable]]


class ShardedEmbedderBackend(BucketedEmbedderBackend):
    """Bucketed embedder fanned out over a data-parallel device mesh, with
    a pinned staging ring and stream-ordered async dispatch.

    The pool is ``mesh`` if given, else ``devices`` (clamped to a power of
    two), else the one ``device``.  ``dtype`` / ``async_dispatch`` default
    to the serving flags (``embed_dtype`` / ``embed_async``), so a
    default-constructed backend is the paper-faithful fp32 synchronous
    baseline.  ``device_count`` is the fan-out over the data axes; a
    ``model`` axis splits the weights (``tensor_parallel``).  Counters are
    inherited from the bucketed backend (``traces``, ``bucket_hits``,
    ``real_tokens``/``padded_tokens``, ``truncated``).
    """

    def __init__(self, cfg, params, max_tokens: int = 128, *,
                 mesh=None, devices: Optional[Sequence] = None,
                 device="cuda", dtype: Optional[str] = None,
                 async_dispatch: Optional[bool] = None,
                 min_seq_bucket: int = 16, min_batch_bucket: int = 1,
                 staging_slots: int = 4,
                 telemetry: Optional[Telemetry] = None,
                 prewarm_buckets: Sequence[Tuple[int, int]] = ()):
        import torch

        from repro_torch import perf_flags
        from repro_torch.launch.mesh import make_serve_mesh
        from repro_torch.parallel import sharding

        flags = perf_flags.FLAGS
        dtype = flags.embed_dtype if dtype is None else dtype
        self.async_dispatch = (flags.embed_async if async_dispatch is None
                               else bool(async_dispatch))
        if mesh is None:
            mesh = make_serve_mesh(_serve_devices(
                [device] if devices is None else devices))
        ndev = sharding._dp_size(mesh)
        if ndev != next_pow2(ndev):
            raise ValueError(f"data-parallel mesh size must be a power of "
                             f"two, got {ndev}")
        self.mesh = mesh
        self.device_count = ndev
        self.tensor_parallel = mesh.size != ndev
        # the parent realises the dtype policy ONCE at load (serve_params
        # validates it) on the home device; batch buckets must divide the
        # data axis: floor the bucket at the mesh size, a power of two
        super().__init__(cfg, params, max_tokens,
                         min_seq_bucket=min_seq_bucket,
                         min_batch_bucket=max(next_pow2(min_batch_bucket),
                                              ndev),
                         telemetry=telemetry, dtype=dtype,
                         device=mesh.device_list[0])
        self.serve_dtype = self.compute_dtype
        self.name = (f"torch-sharded/{cfg.name}@{ndev}dev"
                     + (f"x{mesh.size // ndev}tp" if self.tensor_parallel
                        else "")
                     + f"/{dtype}" + ("+async" if self.async_dispatch else ""))

        # the weights laid out over the mesh under the serve-mode specs
        # (replicated leaves: positions on the home device keep its tree)
        psh, (_, self._batch_spec) = sharding.serve_embed_shardings(
            mesh, self.params)
        self._placed = sharding.shard_tree(self.params, psh)
        self._devices = mesh.device_list
        # data parallel: each position's forward on its own tree of blocks
        self._replicas = (None if self.tensor_parallel else
                          [sharding.local_tree(self._placed, i)
                           for i in range(len(self._devices))])
        self._block_index = sharding.block_index

        cuda = self.device.type == "cuda"
        self._streams = None
        if cuda:
            # tensor parallel: one stream a device, shared by its positions
            own: dict = {}
            self._streams = [
                own.setdefault(d, torch.cuda.Stream(d))
                if self.tensor_parallel else torch.cuda.Stream(d)
                for d in self._devices]
            # the weights were written on the current streams of the home
            # device and of each position's device: a serving stream must
            # not read them before those writes land
            for st, d in zip(self._streams, self._devices):
                st.wait_stream(torch.cuda.current_stream(self.device))
                st.wait_stream(torch.cuda.current_stream(d))

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

    def _on(self, pos: int):
        """Kernels launch on the calling thread's current stream: make it
        position ``pos``'s serving stream (and its device current)."""
        if self._streams is None:
            return contextlib.nullcontext()
        return self._torch.cuda.stream(self._streams[pos])

    def _split(self, t):
        """The row blocks of a (B, ...) batch tensor, one a mesh position,
        each copied to its device on that position's stream."""
        out = []
        for pos, dev in enumerate(self._devices):
            idx = self._block_index(self.mesh, self._batch_spec, t.shape, pos)
            with self._on(pos):
                out.append(t[idx].to(dev, non_blocking=True))
        return out

    def _all_streams(self):
        """Every device's serving stream current at once (the tensor-
        parallel forward launches on all of them)."""
        stack = contextlib.ExitStack()
        for st in dict.fromkeys(self._streams or ()):
            stack.enter_context(self._torch.cuda.stream(st))
        return stack

    def _embed(self, toks, mask):
        """The forward of a batch split into row blocks (lists from
        ``_split``, one a position): each position's on its rows, on its
        own stream, or, tensor parallel, one forward over every position
        (``models.tp.embed``).  Returns the list of per-position outputs,
        or [the whole (B, D) output on the first position's device].
        Counts new (B, S) shapes of the whole batch."""
        if self.tensor_parallel:
            from repro_torch.models import tp

            self._count_shape((toks[0].shape[0] * self.device_count,
                               toks[0].shape[1]))
            with self._torch.inference_mode(), self._all_streams():
                return [tp.embed(self._placed, self.cfg, toks, mask,
                                 self.mesh, compute_dtype=self.compute_dtype,
                                 act_quant=self.act_quant)]
        self._count_shape((sum(t.shape[0] for t in toks), toks[0].shape[1]))
        outs = []
        with self._torch.inference_mode():
            for pos in range(len(self._devices)):
                with self._on(pos):
                    outs.append(self._embedder.embed(
                        self._replicas[pos], self.cfg, toks[pos], mask[pos],
                        compute_dtype=self.compute_dtype,
                        act_quant=self.act_quant))
        return outs

    def _warm(self, key) -> None:
        """One all-padding batch of shape ``key`` on every device; waits for
        each position's stream."""
        torch = self._torch
        outs = self._embed(self._split(torch.zeros(key, dtype=torch.int32)),
                           self._split(torch.ones(key, dtype=torch.float32)))
        for pos, out in enumerate(outs):
            with self._on(pos):
                out.cpu()

    def _new_slot(self, bb: int, sb: int):
        torch = self._torch
        pin = self._streams is not None
        return (torch.zeros((bb, sb), dtype=torch.int32, pin_memory=pin),
                torch.zeros((bb, sb), dtype=torch.float32, pin_memory=pin))

    def _stage_chunk(self, chunk: Sequence[Query], bb: int, sb: int):
        """Tokenize into the (bb, sb) bucket's next staging slot and enqueue
        the copy of each position's rows to its device.  The slot rotates
        through the ring so a buffer is only refilled ``staging_slots``
        batches later -- by which point the double-buffered worker has
        fetched (hence the devices have consumed) the batch that read it.
        The lock covers slot pick + fill + copies, so worker threads can
        share one backend (raise ``staging_slots`` beyond 2 workers)."""
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
                td, md = self._split(toks_t), self._split(mask_t)
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

    def _row_blocks(self, parts):
        """(position, output, the batch rows it holds) of each output of
        ``_embed``."""
        if self.tensor_parallel:
            return [(0, parts[0], slice(0, parts[0].shape[0]))]
        whole = (sum(p.shape[0] for p in parts), parts[0].shape[1])
        return [(pos, part, self._block_index(self.mesh, self._batch_spec,
                                              whole, pos)[0])
                for pos, part in enumerate(parts)]

    def embed_batch_async(self, queries: Sequence[Query]
                          ) -> Callable[[], List[np.ndarray]]:
        """Enqueue every chunk of the batch; returns the deferred fetch.

        On the card this costs staging + launch only: on each position's
        stream, the copy of its rows in, its forward and the copy of its
        real rows into pinned host memory, then an event on every stream.
        The fetch thunk waits on the events and puts the rows back in
        order -- the engine worker calls it one batch late (double
        buffering) so the copies overlap the next batch's compute.
        """
        torch = self._torch
        self._staging_tl.keys = []
        try:
            outs = []                 # per chunk: its real rows' blocks
            for n, parts in self._enqueue_chunks(queries):
                for pos, part, rows in self._row_blocks(parts):
                    lo, hi = min(rows.start, n), min(rows.stop, n)
                    if hi == lo:
                        continue            # padding rows only
                    if self._streams is None:
                        outs.append(part[:hi - lo])
                        continue
                    with self._on(pos):
                        host = torch.empty((hi - lo, part.shape[1]),
                                           dtype=part.dtype, pin_memory=True)
                        host.copy_(part[:hi - lo], non_blocking=True)
                    outs.append(host)
            done = []
            if self._streams is not None:
                for st in dict.fromkeys(self._streams):
                    ev = torch.cuda.Event()
                    ev.record(st)
                    done.append(ev)
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
                for ev in done:
                    ev.synchronize()
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
