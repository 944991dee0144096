"""WindVE engine — the paper's full system (Fig. 3B), runnable for real.

Pipeline: device detector -> queue depth calibration (linear-regression
estimator) -> policy-driven N-tier queue manager (Algorithm 1 core in
``repro_torch.core.routing``) -> per-tier worker threads draining their queue in
batches, each worker owning its own model instance (the paper: "each
instance employs its own model copy").

The engine is one of two *drivers* of the shared scheduling core (the other
is the DES in ``repro_torch.core.simulator``): every query goes through the same
``QueueManager.dispatch`` + ``DispatchPolicy``, so thread and simulation
semantics cannot diverge.

Backends:
* ``TorchEmbedderBackend`` — actually runs the bge/jina-style PyTorch
  embedder on its ``device`` (the card by default, or the host CPU).
* ``ModeledBackend``       — wall-clock sleeps per the calibrated DeviceModel
  (the paper's modeled NPU pool).

Observability: ``add_batch_hook(fn)`` registers a first-class batch
completion hook ``fn(tier_name, batch, service_latency_s)`` — the online
calibrator (``repro_torch.core.adaptive``) attaches through this instead of
monkey-patching ``embed_batch``.
"""
from __future__ import annotations

import threading
import time
import warnings
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import estimator
from repro_torch.core.routing import (ADMISSION, BUSY, CPU, EXPIRED, NPU,
                                DeadlineExceeded, DispatchPolicy, Query,
                                QueueManager, RetryPolicy, ServeError,
                                TierSpec)
from repro_torch.core.simulator import DeviceModel, sharded_model
from repro_torch.core.telemetry import EngineStats, Telemetry

BatchHook = Callable[[str, Sequence[Query], float], None]


class Backend:
    """A device pool able to embed a batch of queries.

    ``telemetry`` (optional): a :class:`~repro_torch.core.telemetry.Telemetry` the
    backend reports quality events (payload truncations) into.  ``WindVE``
    wires its shared stats object into any backend that left it None.
    """

    name = "backend"
    telemetry: Optional[Telemetry] = None
    # backends that can enqueue a batch and hand back a deferred fetch set
    # this True and implement ``embed_batch_async`` (see
    # ``repro_torch.core.sharded_backend``); the engine worker then double-buffers.
    async_dispatch = False

    def embed_batch(self, queries: Sequence[Query]) -> List[np.ndarray]:
        raise NotImplementedError

    def embed_batch_async(self, queries: Sequence[Query]
                          ) -> Callable[[], List[np.ndarray]]:
        """Enqueue the batch; the returned thunk blocks for the results."""
        out = self.embed_batch(queries)
        return lambda: out


class ModeledBackend(Backend):
    """Wall-clock stand-in for the accelerator pool.

    ``devices=N`` models the tier as an N-device mesh: the same fan-out
    service curve the DES uses (``repro_torch.core.simulator.FanOutModel`` —
    pow2 per-device chunks mirroring ``ShardedEmbedderBackend``'s
    mesh-floored buckets, chunk latency = the straggler device's, plus a
    ``fanout_beta_s * log2(N)`` scatter/gather term per execution).
    ``devices=1`` keeps the wrapped model untouched, exactly like a
    1-device mesh degrading to the single-device path.

    ``hosts=H`` (with ``interhost_beta_s``) marks the device group as
    spanning H machines: the fan-out curve gains the cross-host gather
    term (``interhost_beta_s * log2(H)``), so an engine replica carved
    across hosts prices its network fabric exactly like the DES does —
    depth calibration against this backend stays honest at cluster scale.
    """

    def __init__(self, model: DeviceModel, embed_dim: int = 1024, *,
                 devices: int = 1, fanout_beta_s: float = 0.0,
                 hosts: int = 1, interhost_beta_s: float = 0.0):
        self.model = sharded_model(model, devices, fanout_beta_s,
                                   hosts, interhost_beta_s)
        self.devices = max(1, devices)
        self.hosts = max(1, hosts)
        self.embed_dim = embed_dim
        self.name = self.model.name

    def embed_batch(self, queries: Sequence[Query]) -> List[np.ndarray]:
        # the batch is served as ONE padded execution, so its latency follows
        # the longest member — using queries[0] made the modeled tier blind
        # to length-aware batch formation
        dur = self.model.latency(len(queries),
                                 max(q.length for q in queries))
        time.sleep(dur)
        return [np.zeros(self.embed_dim, np.float32) for _ in queries]


def resolve_device(device) -> "torch.device":
    """``device`` as a ``torch.device`` with its index filled in.  Asking
    for CUDA on a machine without a card raises: nothing falls back to the
    CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               f"device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class TorchEmbedderBackend(Backend):
    """Real PyTorch embedder on ``device`` (the card by default).

    Every batch is padded to the fixed ``max_tokens`` window -- the baseline
    the shape-bucketed backend (``repro_torch.core.bucketing``) beats.
    ``traces`` counts the first execution of each new padded (B, S) shape:
    eager PyTorch has no jit to retrace, but "zero new shapes after
    prewarm" stays checkable.  Payloads longer than ``max_tokens`` are
    truncated; truncations are counted locally and into ``telemetry`` when
    attached.

    ``dtype`` (optional) selects a serving precision policy realised ONCE
    at load by ``repro_torch.models.quantize.serve_params``: ``"fp32"``
    (fp32 weights + fp32 trunk -- the precision oracle), ``"bf16"``
    (bf16-resident weights, bf16 trunk), ``"int8"`` (int8 projection
    weights, fp32 trunk) or ``"int8_w8a8"`` (the same tree, and int8
    activations at every projection: ``act_quant``).  None keeps the params
    as given with the model's default compute dtype; an fp32 forward on the
    card needs TF32 off, which ``serve_params`` sets for every fp32-compute
    policy.
    """

    def __init__(self, cfg, params, max_tokens: int = 128,
                 telemetry: Optional[Telemetry] = None, *,
                 dtype: Optional[str] = None, device="cuda"):
        import torch

        from repro_torch.models import embedder

        self.cfg = cfg
        self.dtype = dtype
        self.max_tokens = max_tokens
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self.name = (f"torch-{self.device.type}/{cfg.name}"
                     + (f"/{dtype}" if dtype else ""))
        self.traces = 0          # first executions of a new padded shape
        self.truncated = 0
        self.real_tokens = 0     # tokens the queries actually carried
        self.padded_tokens = 0   # tokens added by padding (wasted FLOPs)

        from repro_torch.models.quantize import serve_params, wants_act_quant
        if dtype is None:
            tree, cdt = params, None   # model default (layers.COMPUTE_DTYPE)
        else:
            tree, cdt = serve_params(params, dtype)
        self.act_quant = wants_act_quant(dtype)
        self.params = _tree_to(tree, self.device)
        self.compute_dtype = cdt
        self._torch = torch
        self._embedder = embedder
        self._shapes: set = set()
        self._shape_lock = threading.Lock()

    def _count_shape(self, key) -> None:
        """Count a first execution of the padded (B, S) shape ``key``."""
        with self._shape_lock:
            if key not in self._shapes:
                self._shapes.add(key)
                self.traces += 1

    def _embed(self, toks, mask):
        """Run the embedder on device tensors; counts new (B, S) shapes."""
        self._count_shape(tuple(toks.shape))
        with self._torch.inference_mode():
            return self._embedder.embed(self.params, self.cfg, toks, mask,
                                        compute_dtype=self.compute_dtype,
                                        act_quant=self.act_quant)

    def _to_device(self, arr: np.ndarray):
        return self._torch.from_numpy(arr).to(self.device)

    @property
    def params_nbytes(self) -> int:
        """Resident serving-weight footprint: bf16 about half of fp32, int8
        about a third at bge's width (int8 projections, one fp32 scale per
        output channel; the embedding table and norms stay fp32)."""
        return sum(t.numel() * t.element_size() for t in _leaves(self.params))

    def _tokenize(self, queries: Sequence[Query], seq_len: int, out=None):
        """Pad/truncate a batch into (tokens, mask) of width ``seq_len``.

        Returns (toks, mask, real_tokens, truncated).  Queries without a
        payload get the deterministic synthetic token stream, so modeled and
        real runs embed identical inputs.

        ``out``: optional reusable ``(toks, mask)`` staging arrays with at
        least ``len(queries)`` rows and exactly ``seq_len`` columns — the
        sharded backend keeps a ring of them per (B, S) bucket so
        steady-state serving stops allocating fresh host arrays per batch.
        Padding rows beyond the batch are zeroed (all-zero mask == dropped
        by pooling).  Padding is left-aligned: row i's real tokens fill
        columns [0, n_i), which is what makes ``kv_len = mask.sum(-1)``
        right.

        Vectorized: this runs inside the worker thread on EVERY batch, so
        the fill is two bulk numpy writes — the mask broadcast from a
        length vector, the token grid from one stacked payload flat-assign
        (synthetic rows share a single base pattern) — instead of a
        per-query row loop.
        """
        B = len(queries)
        if out is None:
            toks = np.zeros((B, seq_len), np.int32)
            mask = np.zeros((B, seq_len), np.float32)
        else:
            toks, mask = out
            toks[:] = 0
            mask[:] = 0.0
        if B == 0:
            return toks, mask, 0, 0
        lens = np.fromiter(
            (q.length if q.payload is None else len(q.payload)
             for q in queries), np.int64, count=B)
        n = np.minimum(lens, seq_len)
        truncated = int((lens > seq_len).sum())
        real = int(n.sum())
        valid = np.arange(seq_len)[None, :] < n[:, None]      # (B, seq_len)
        mask[:B] = valid
        synth = np.fromiter((q.payload is None for q in queries), bool,
                            count=B)
        tv = toks[:B]                   # basic-slice view: writes land in out
        if synth.any():
            # every synthetic stream is the same deterministic prefix
            base = ((np.arange(seq_len, dtype=np.int64)
                     % (self.cfg.vocab_size - 1)) + 1).astype(np.int32)
            sel = synth[:, None] & valid
            tv[sel] = np.broadcast_to(base, (B, seq_len))[sel]
        if not synth.all():
            # row-major boolean assignment consumes the concatenated
            # payloads in exactly batch order
            flat = np.concatenate(
                [np.asarray(q.payload[:seq_len]).ravel()
                 for q in queries if q.payload is not None])
            tv[~synth[:, None] & valid] = flat.astype(np.int32)
        return toks, mask, real, truncated

    def _record_truncations(self, n: int) -> None:
        if n:
            self.truncated += n
            if self.telemetry is not None:
                self.telemetry.record_truncations(n)

    @property
    def padded_waste(self) -> float:
        """Fraction of embedded tokens that were padding."""
        total = self.real_tokens + self.padded_tokens
        return self.padded_tokens / total if total else 0.0

    def embed_batch(self, queries: Sequence[Query]) -> List[np.ndarray]:
        toks, mask, real, truncated = self._tokenize(queries, self.max_tokens)
        self._record_truncations(truncated)
        self.real_tokens += real
        self.padded_tokens += len(queries) * self.max_tokens - real
        out = self._embed(self._to_device(toks),
                          self._to_device(mask)).cpu().numpy()
        return [out[i] for i in range(len(queries))]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}



class WindVE:
    """The serving engine: threaded driver of the shared scheduling core.

    New-style: ``WindVE(tiers=[TierSpec(name, depth, backend=...), ...],
    policy=...)`` for arbitrary topologies.  Legacy two-tier form
    ``WindVE(npu_backend, cpu_backend, npu_depth, cpu_depth, ...)`` still
    works and builds the paper's NPU/CPU cascade (including Algorithm 2's
    single-device fallback when only one backend exists).

    Fault tolerance: ``retry`` (a :class:`~repro_torch.core.routing.RetryPolicy`)
    re-dispatches failed batches through the policy path with bounded
    attempts and exponential backoff; ``default_deadline_s`` arms every
    submit with a relative deadline (per-call ``submit(deadline_s=...)``
    overrides); a ``TierSpec.breaker`` makes dispatch route around a tier
    that keeps failing or stalling.  Terminal failures surface on client
    futures as structured :class:`~repro_torch.core.routing.ServeError`.

    Overload control: ``admission`` (an
    :class:`~repro_torch.core.admission.AdmissionController`) sheds predictably
    late arrivals with ``ServeError(kind="admission")`` futures before they
    occupy a queue slot; ``brownout`` (a
    :class:`~repro_torch.core.health.BrownoutController`) degrades quality —
    quantized-tier preference, tightened deadlines — before anything is
    shed.  Both live in the shared ``QueueManager``, so the DES replays
    the identical decisions.
    """

    def __init__(self, npu_backend: Optional[Backend] = None,
                 cpu_backend: Optional[Backend] = None,
                 npu_depth: int = 0, cpu_depth: int = 0,
                 heter_enable: bool = True,
                 max_batch: Optional[Dict[str, int]] = None,
                 workers: Optional[Dict[str, int]] = None, *,
                 tiers: Optional[Sequence[TierSpec]] = None,
                 policy: Optional[DispatchPolicy] = None,
                 retry: Optional[RetryPolicy] = None,
                 default_deadline_s: Optional[float] = None,
                 admission: Any = None,
                 brownout: Any = None):
        if tiers is None:
            tiers = self._legacy_tiers(npu_backend, cpu_backend, npu_depth,
                                       cpu_depth, heter_enable,
                                       max_batch or {}, workers or {})
        tiers = list(tiers)
        if not tiers:
            raise ValueError("need at least one tier")
        # cache tiers (TierSpec.cache set) are zero-latency: no backend, no
        # queue, no worker thread — hits complete inside submit()
        device_tiers = [t for t in tiers if t.cache is None]
        for t in device_tiers:
            if t.backend is None:
                raise ValueError(f"tier {t.name!r} has no backend")
        # keep_queries=False: a long-running engine must not pin every
        # Query (and its payload) forever; all metrics read `latencies`
        self.qm = QueueManager(tiers, policy=policy,
                               stats=Telemetry(keep_queries=False),
                               admission=admission, brownout=brownout)
        self.stats: EngineStats = self.qm.stats   # one shared Telemetry
        self.backends: Dict[str, Backend] = {t.name: t.backend
                                             for t in device_tiers}
        for be in self.backends.values():
            # backends report quality events (truncations) into the engine's
            # shared telemetry unless the caller wired their own
            if getattr(be, "telemetry", False) is None:
                be.telemetry = self.stats
        self._batch_hooks: List[BatchHook] = []
        self._futures: Dict[int, Future] = {}
        self._qid = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # fault tolerance: 0 retries keeps the legacy single-attempt
        # semantics (one backend failure is terminal for its batch), but
        # failures now surface as structured ServeError, never raw
        # backend tracebacks
        self.retry = retry if retry is not None else RetryPolicy(max_retries=0)
        self.default_deadline_s = default_deadline_s
        # queued queries the deadline sweep expires get their future failed
        self.qm.on_expire = self._expire_query
        self._wake: Dict[str, threading.Event] = {
            t.name: threading.Event() for t in device_tiers}
        # Algorithm 2's worker counts: N instances may drain one tier's
        # queue (each instance owns its own model copy on real hardware).
        # Live counts detect tier death: when a tier's LAST worker dies of
        # a crash, its queued queries must be drained and failed over, not
        # stranded behind a queue nobody will ever pop again.
        self._live_workers: Dict[str, int] = {
            t.name: max(1, t.workers) for t in device_tiers}
        self._thread_tiers: List[str] = [
            t.name for t in device_tiers for _ in range(max(1, t.workers))]
        self._threads = [
            threading.Thread(target=self._worker, args=(name,), daemon=True)
            for name in self._thread_tiers]
        for t in self._threads:
            t.start()

    @staticmethod
    def _legacy_tiers(npu_backend, cpu_backend, npu_depth, cpu_depth,
                      heter_enable, max_batch, workers) -> List[TierSpec]:
        if npu_backend is None and cpu_backend is None:
            raise ValueError("need at least one backend")
        # single-device fallback: Algorithm 2 forces heter off and the sole
        # device becomes the main queue
        if npu_backend is None:
            npu_backend, cpu_backend = cpu_backend, None
            npu_depth, cpu_depth = cpu_depth or npu_depth, 0
            heter_enable = False
        tiers = [TierSpec(NPU, npu_depth, backend=npu_backend,
                          max_batch=max_batch.get(NPU),
                          workers=max(1, workers.get(NPU, 1)))]
        if cpu_backend is not None and heter_enable and cpu_depth > 0:
            tiers.append(TierSpec(CPU, cpu_depth, backend=cpu_backend,
                                  max_batch=max_batch.get(CPU),
                                  workers=max(1, workers.get(CPU, 1))))
        return tiers

    # ------------------------------------------------------------------
    def submit(self, payload=None, length: int = 75,
               deadline_s: Optional[float] = None) -> Optional[Future]:
        """Dispatch one query via the policy core.  None == BUSY (rejected).

        ``deadline_s`` (relative; falls back to the engine's
        ``default_deadline_s``) arms an absolute deadline on the monotonic
        clock: if the query is still *queued* when it passes, the sweep
        expires it and its future fails with :class:`DeadlineExceeded`
        (in-flight work completes late as an SLO violation instead — a
        batch on a device cannot be recalled).  A query already dead at
        dispatch never enters a queue: its future comes back with the
        exception pre-set.

        The future is registered BEFORE dispatch: a worker may complete the
        query before this thread returns from ``dispatch``, and must find
        the future to resolve.  On BUSY the registration is rolled back.
        """
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        with self._lock:
            self._qid += 1
            now = time.monotonic()
            q = Query(qid=self._qid, payload=payload, length=length,
                      arrival_t=now,
                      deadline=None if deadline_s is None
                      else now + deadline_s)
        fut: Future = Future()
        self._futures[q.qid] = fut
        verdict = self.qm.dispatch(q)
        if verdict == BUSY:
            self._futures.pop(q.qid, None)
            return None
        if verdict == EXPIRED:
            self._fail(q, DeadlineExceeded(qid=q.qid, attempts=q.attempts))
            return fut
        if verdict == ADMISSION:
            # admission shed at arrival is a REJECTION (rejections_admission
            # counts it), not a terminal serving failure — the future
            # carries the structured error but `failed` stays untouched,
            # mirroring how BUSY rejections never count as failed
            self._futures.pop(q.qid, None)
            fut.set_exception(ServeError("admission", qid=q.qid))
            return fut
        if self.qm.is_cache_tier(verdict):
            # zero-latency tier: the hit already filled q.emb at dispatch —
            # complete here, no queue slot, no worker, no batch
            q.done_t = time.monotonic()
            self.stats.record_completion(q, verdict)
            self._futures.pop(q.qid, None)
            fut.set_result(q.emb)
            return fut
        self._wake[verdict].set()
        return fut

    def add_batch_hook(self, hook: BatchHook) -> BatchHook:
        """Register ``hook(tier_name, batch, service_latency_s)``, called by
        the worker after every completed batch (calibration, metrics, ...)."""
        self._batch_hooks.append(hook)
        return hook

    def remove_batch_hook(self, hook: BatchHook) -> None:
        if hook in self._batch_hooks:
            self._batch_hooks.remove(hook)

    # -- fault tolerance ------------------------------------------------
    def _fail(self, q: Query, exc: ServeError) -> None:
        """Terminally fail one query: its future carries a structured
        ``ServeError`` (never a raw backend traceback) and the failure is
        counted.  No-op if the future already resolved."""
        fut = self._futures.pop(q.qid, None)
        if fut is None:
            return
        self.stats.record_failed()
        fut.set_exception(exc)

    def _expire_query(self, q: Query) -> None:
        """``QueueManager.on_expire`` hook: a queued query the deadline
        sweep removed — fail its future with the tier it was waiting on."""
        self._fail(q, DeadlineExceeded(tier=q.device, qid=q.qid,
                                       attempts=q.attempts))

    def _retry_or_fail(self, batch: Sequence[Query], tier_name: str,
                       cause: BaseException, now: float,
                       kind: str = "backend_error") -> None:
        """A batch failed on ``tier_name``: re-dispatch every query through
        the normal policy path (so survivors land on whatever healthy tier
        the policy picks — including this one, once its slots freed) with
        bounded attempts, or fail its future with a structured ServeError.

        The exponential backoff is slept HERE, in the failed tier's worker
        — the tier that just failed is the one that waits, healthy tiers
        keep draining — and is computed per batch from its first retryable
        query's attempt count (batch members share a history in the common
        case; the DES prices the identical delay).
        """
        retryable: List[Query] = []
        for q in batch:
            q.attempts += 1
            if q.attempts > self.retry.max_retries:
                self._fail(q, ServeError(kind, tier=tier_name, qid=q.qid,
                                         attempts=q.attempts, cause=cause))
            else:
                retryable.append(q)
        if not retryable:
            return
        pause = self.retry.backoff(retryable[0].attempts)
        if pause > 0:
            time.sleep(pause)
        for q in retryable:
            now = time.monotonic()
            if q.expired(now):
                # dispatch would refuse it anyway; fail with the tier it
                # burned its last attempt on rather than the ARRIVAL pseudo
                # tier so the miss is attributable
                self.qm.stats.record_deadline_miss(tier_name)
                self._fail(q, DeadlineExceeded(tier=tier_name, qid=q.qid,
                                               attempts=q.attempts))
                continue
            self.stats.record_retry(tier_name)
            verdict = self.qm.dispatch(q, now=now)
            if verdict == BUSY:
                self._fail(q, ServeError("no_capacity", tier=tier_name,
                                         qid=q.qid, attempts=q.attempts,
                                         cause=cause))
            elif verdict == ADMISSION:
                # on a retry re-dispatch the shed IS terminal: the query
                # already burned device time, so it ends as failed
                self._fail(q, ServeError("admission", tier=tier_name,
                                         qid=q.qid, attempts=q.attempts,
                                         cause=cause))
            elif verdict == EXPIRED:
                self._fail(q, DeadlineExceeded(qid=q.qid,
                                               attempts=q.attempts))
            elif self.qm.is_cache_tier(verdict):
                q.done_t = time.monotonic()
                self.stats.record_completion(q, verdict)
                fut = self._futures.pop(q.qid, None)
                if fut is not None:
                    fut.set_result(q.emb)
            else:
                self._wake[verdict].set()

    def _worker_died(self, tier_name: str, crash: BaseException) -> None:
        """The tier's LAST worker crashed: quarantine the tier (depth 0 —
        dispatch and retry can no longer land work on it) and drain its
        queue, failing over every stranded query so no client future hangs
        on a queue nobody will ever pop again."""
        warnings.warn(f"windve: tier {tier_name!r} lost its last worker "
                      f"({crash!r}); draining its queue", RuntimeWarning)
        self.qm.set_depth(tier_name, 0)
        queue = self.qm.queues[tier_name]
        while True:
            # raw queue drain (no bucket_fn: buckets don't matter to a
            # dead tier) — pop_batch marks in-flight, finish releases
            stranded = queue.pop_batch(1 << 30)
            if not stranded:
                return
            queue.finish(len(stranded))
            self._retry_or_fail(stranded, tier_name, crash,
                                time.monotonic(), kind="worker_death")

    def _worker(self, tier_name: str) -> None:
        backend = self.backends[tier_name]
        queue = self.qm.queues[tier_name]
        use_async = bool(getattr(backend, "async_dispatch", False)) and \
            callable(getattr(backend, "embed_batch_async", None))
        # double buffering (async backends): the previous batch's fetch is
        # deferred until the NEXT batch is enqueued, so device->host copy of
        # batch N-1 overlaps batch N's compute and the worker never idles on
        # ``device_get``.
        pending = None   # (batch, fetch_thunk, t0)

        def resolve(entry) -> None:
            batch, fetch, t0 = entry
            try:
                embs = fetch()
                err: Optional[BaseException] = None
            except BaseException as e:
                # BaseException on purpose: even a worker-killing crash
                # (SystemExit and friends) must not strand this batch's
                # futures — account for it, THEN let it propagate
                embs, err = None, e
            service = time.monotonic() - t0
            now = time.monotonic()
            queue.finish(len(batch))   # slots free before any re-dispatch
            if err is not None:
                self.qm.tier_failure(tier_name, now)
                self._retry_or_fail(batch, tier_name, err, now)
                if not isinstance(err, Exception):
                    raise err           # genuine worker death (accounted)
                return
            self.qm.tier_success(tier_name, service, now)
            self.stats.record_batch(tier_name, service)
            admit = bool(self.qm.cache_tiers)
            for q, emb in zip(batch, embs):
                q.done_t = now
                self.stats.record_completion(q, tier_name)
                if admit:
                    # admission hook: insert BEFORE the future resolves, so
                    # a client that saw this result re-submitting the same
                    # tokens is guaranteed the cache hit
                    self.qm.admit(q, emb)
                fut = self._futures.pop(q.qid, None)
                if fut is not None:
                    fut.set_result(emb)
            for hook in list(self._batch_hooks):
                try:
                    hook(tier_name, batch, service)
                except Exception:      # hooks must not kill the worker
                    self.stats.record_hook_error()

        crash: Optional[BaseException] = None
        try:
            while not self._stop.is_set():
                # live values: online re-calibration may resize the depth;
                # qm.pop_batch honours the tier's bucket_fn (length-aware
                # batches) and sweeps deadline-dead work out first
                batch = self.qm.pop_batch(tier_name, now=time.monotonic())
                if not batch:
                    if pending is not None:  # drain: nothing left to overlap
                        entry, pending = pending, None
                        resolve(entry)
                        continue
                    self._wake[tier_name].wait(timeout=0.01)
                    self._wake[tier_name].clear()
                    continue
                t0 = time.monotonic()
                if use_async:
                    try:
                        fetch = backend.embed_batch_async(batch)
                    except Exception as e:
                        def fetch(err=e):
                            raise err
                    prev, pending = pending, (batch, fetch, t0)
                    if prev is not None:
                        resolve(prev)
                else:
                    resolve((batch,
                             (lambda b=batch: backend.embed_batch(b)), t0))
            if pending is not None:  # pragma: no cover - shutdown mid-flight
                entry, pending = pending, None
                resolve(entry)
        except BaseException as e:   # worker death, not a batch failure
            crash = e
            if pending is not None:
                # a double-buffered batch this worker still owned: account
                # it (resolve never saw it, so no double-finish risk)
                b, pending = pending[0], None
                queue.finish(len(b))
                self._retry_or_fail(b, tier_name, e, time.monotonic(),
                                    kind="worker_death")
        finally:
            with self._lock:
                self._live_workers[tier_name] -= 1
                last = self._live_workers[tier_name] == 0
            if crash is not None and last and not self._stop.is_set():
                self._worker_died(tier_name, crash)

    def shutdown(self) -> None:
        """Stop the workers.  Threads that fail to join within the timeout
        are *leaked* (a worker wedged in a backend call): each is warned
        about with its tier name and ``Telemetry.summary()`` reports
        ``clean_shutdown`` 0.0 instead of silently returning."""
        self._stop.set()
        for e in self._wake.values():
            e.set()
        leaked: List[str] = []
        for t, tier in zip(self._threads, self._thread_tiers):
            t.join(timeout=2.0)
            if t.is_alive():
                leaked.append(tier)
        self.stats.clean_shutdown = not leaked
        for tier in sorted(set(leaked)):
            warnings.warn(f"windve: shutdown leaked a worker thread on tier "
                          f"{tier!r} (join timed out)", RuntimeWarning)

    @property
    def max_concurrency(self) -> int:
        return self.qm.max_concurrency


def calibrate_depths(profile_npu: Callable[[int], float],
                     profile_cpu: Optional[Callable[[int], float]],
                     slo_s: float,
                     probe_points: Sequence[int] = (1, 2, 4, 8, 16),
                     ) -> Dict[str, int]:
    """Paper §4.2.2 end-to-end: estimate both queue depths from a few
    profiling points via the linear-regression estimator."""
    d_npu, _ = estimator.estimate_depth(profile_npu, slo_s, probe_points)
    d_cpu = 0
    if profile_cpu is not None:
        d_cpu, _ = estimator.estimate_depth(profile_cpu, slo_s, probe_points)
    return {NPU: max(d_npu, 0), CPU: max(d_cpu, 0)}
