"""The async request front-end: ``submit`` one query, get a ``Future``
(the port's counterpart of the JAX package's ``repro.serve.frontend``).

``Frontend`` is the user-facing layer of the serving tier.  It owns

* a registry of **compiled paths** (``register(spec_key, spec)`` ->
  ``Engine.compile``),
* a ``CoalescingBatcher`` grouping in-flight queries by
  ``(spec_key, hypergraph)``,
* one **worker thread** that continuously drains due batches into
  ``CompiledAlgorithm.run_batch`` and fans the rows back out to
  per-request futures,
* ``ServeMetrics`` for the wait/execute latency split, bucket
  occupancy and flush accounting (``stats()``).

Correctness contract: a request's resolved value equals a sequential
``CompiledAlgorithm.run(query=...)`` of the same query under the
port's parity rule — bitwise for min/max programs (SSSP, components,
label propagation), within 1e-5 relative for float sums (PageRank, the
personalized walk), whose batched and sequential reductions may
associate differently.  Coalescing, batch padding and fan-out never
touch the numbers.

On the card a future resolves only once the card has finished its
rows: the flush's stream is synchronized before ``set_result``, and the
rows are slices of tensors the flush owns (``run_batch`` copies its
results out of the executable's buffers), never views of a buffer the
next replay overwrites.  Capture and execution hold the Engine's lock;
``warm`` captures every bucket before ``start`` so that the worker only
replays.  A caller that queues card work of its own while the worker
may capture does so on a stream of its own: work on the legacy default
stream from another thread can void an open capture.
A permanent fault on the card resolves its requests with the
typed error, after the batch bisect: no plain path answers in place of
the kernel.

Determinism for tests: the batcher is pure and the clock injectable;
an unstarted front-end can be driven synchronously with ``pump()``
(no thread, no sleeps), which the property tests use.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from repro_torch.core.api import tree_leaves, tree_map
from repro_torch.faults.errors import (
    CircuitOpen,
    DeadlineExceeded,
    FrontendClosed,
    PoisonQuery,
    is_transient,
)
from repro_torch.obs.trace import maybe_span
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import AdaptiveDelay, CoalescingBatcher, Flush

DEFAULT_MAX_BATCH = 32
DEFAULT_MAX_DELAY_MS = 5.0
# Worker-crash requeues per request before the supervisor gives up and
# resolves the future with the crash: bounds the restart loop under a
# deterministic (always-firing) worker fault.
MAX_REQUEUES = 3


class _Breaker:
    """Per-group circuit breaker.

    ``threshold`` consecutive flush failures open the circuit; while
    open, flushes fast-fail with ``CircuitOpen`` (no execute attempt —
    a hard-down path stops burning retries and batch executes).  After
    ``cooldown_s`` one probe batch is allowed through (half-open):
    success closes the circuit, failure re-opens it for another
    cooldown.  Touched only by the flush-executing thread (worker or
    ``pump`` caller), so no lock is needed.
    """

    __slots__ = ("threshold", "cooldown_s", "failures", "opened_at")

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self.failures = 0
        self.opened_at: float | None = None

    def allow(self, now: float) -> bool:
        if self.opened_at is None:
            return True
        return now - self.opened_at >= self.cooldown_s  # half-open probe

    def record_failure(self, now: float) -> bool:
        """Fold in one flush failure; True when this one trips it open."""
        self.failures += 1
        if self.opened_at is not None:   # failed half-open probe:
            self.opened_at = now         # restart the cooldown
            return False
        if self.failures >= self.threshold:
            self.opened_at = now
            return True
        return False

    def record_success(self) -> None:
        self.failures = 0
        self.opened_at = None


@dataclasses.dataclass
class ServedResult:
    """What a request's ``Future`` resolves to.

    ``value`` is the spec's extracted output for THIS query (leading
    batch axis already sliced off; leaves are rows of the flush's own
    tensors on the Engine's device, finished by the card, or numpy rows
    for a path that returns numpy).  The rest is
    per-request observability: how long the query waited for
    co-batchable traffic, how long its batch executed, why and how full
    the batch flushed.
    """

    value: Any
    queue_wait_s: float
    execute_s: float
    flush_reason: str
    batch_size: int
    batch_bucket: int
    group: Any
    supersteps_executed: int | None = None


class _Path:
    """One registered compiled algorithm (a ``spec_key``)."""

    __slots__ = ("key", "compiled", "max_batch")

    def __init__(self, key, compiled, max_batch):
        self.key = key
        self.compiled = compiled
        self.max_batch = max_batch


class Frontend:
    """Coalescing request front-end over one ``Engine``.

    >>> fe = Frontend(engine, max_batch=32, max_delay_ms=5)
    >>> fe.register("sssp", shortest_paths_spec(hg, 0, 32))
    >>> fe.register("ppr", random_walk_spec(hg, iters=20))
    >>> with fe:                      # starts the worker thread
    ...     futs = [fe.submit("sssp", query=s) for s in sources]
    ...     results = [f.result() for f in futs]
    >>> fe.stats()                    # latency split, occupancy, caches

    ``max_batch`` should be the batch bucket the executables were
    warmed at (a power of two): a full flush then runs at occupancy 1.0
    while partial (deadline) flushes pad up to the same bucket set.
    """

    def __init__(
        self,
        engine,
        *,
        max_batch: int = DEFAULT_MAX_BATCH,
        max_delay_ms: float = DEFAULT_MAX_DELAY_MS,
        log_every_s: float | None = None,
        clock=time.monotonic,
        adaptive_delay: bool = False,
        min_delay_ms: float = 0.5,
        resilience: bool = True,
        max_retries: int = 2,
        retry_backoff_ms: float = 10.0,
        breaker_threshold: int = 5,
        breaker_cooldown_ms: float = 1000.0,
        fault_injector=None,
    ):
        self.engine = engine
        # Fault-tolerance knobs.  ``resilience=False`` is the
        # measurement escape hatch: no retries, no bisect, no breaker,
        # no deadline checks — the fault-free overhead of the resilient
        # default is measured against it.
        self._resilience = bool(resilience)
        self._injector = (
            fault_injector if fault_injector is not None
            else getattr(engine, "fault_injector", None)
        )
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_ms) / 1e3
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_ms) / 1e3
        self._breakers: dict[Any, _Breaker] = {}
        self._sleep = time.sleep   # injectable: tests retry without waiting
        self._inflight: Flush | None = None
        self._worker_restarts = 0
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.clock = clock
        self.metrics = ServeMetrics(log_every_s=log_every_s)
        # Off by default: max_delay_ms stays a fixed deadline.  Opted
        # in, it becomes the UPPER bound of an AdaptiveDelay controller
        # fed by the observed flush reason / occupancy / execute time.
        self._adaptive = (
            AdaptiveDelay(
                self.max_delay_s,
                lo_s=float(min_delay_ms) / 1e3,
                hi_s=max(self.max_delay_s, float(min_delay_ms) / 1e3),
            )
            if adaptive_delay
            else None
        )
        self._paths: dict[Any, _Path] = {}
        self._batcher = CoalescingBatcher(
            capacity=lambda group: self._paths[group[0]].max_batch
        )
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._stop = False
        self._closed = False

    # -- registration ------------------------------------------------------

    def register(
        self, spec_key: Any, spec, *, max_batch: int | None = None,
        **overrides,
    ):
        """Register a servable path: an ``AlgorithmSpec`` (compiled via
        ``engine.compile(spec, **overrides)``) or anything already
        exposing ``run_batch`` (a ``CompiledAlgorithm``, or a test
        double).  Returns the compiled handle."""
        if hasattr(spec, "run_batch"):
            compiled = spec
        else:
            if getattr(spec, "bind_query", None) is None:
                raise ValueError(
                    f"spec {getattr(spec, 'name', spec)!r} has no "
                    "bind_query: the front-end batches per-request "
                    "queries; declare the query axis"
                )
            compiled = self.engine.compile(spec, **overrides)
        with self._lock:
            if self._closed:
                raise FrontendClosed("front-end is closed")
            if spec_key in self._paths:
                raise ValueError(f"spec_key {spec_key!r} already registered")
            self._paths[spec_key] = _Path(
                spec_key, compiled, int(max_batch or self.max_batch)
            )
        return compiled

    def compiled(self, spec_key: Any):
        return self._paths[spec_key].compiled

    # -- submission --------------------------------------------------------

    def submit(
        self,
        spec_key: Any,
        hg=None,
        query: Any = None,
        deadline_ms: float | None = None,
        timeout_ms: float | None = None,
    ) -> Future:
        """Enqueue one query; resolves to a ``ServedResult``.

        ``hg``: serve against this (same-shape-bucket) hypergraph
        instead of the spec's own; queries only coalesce within one
        hypergraph.  ``deadline_ms`` bounds this request's queue wait —
        when it expires the batch flushes with whatever co-arrived
        (default: the front-end's ``max_delay_ms``).  ``timeout_ms`` is
        the request's HARD deadline: a request the tier cannot dispatch
        by then (overload, retries, open circuit) resolves with
        ``DeadlineExceeded`` instead of hanging.  Raises
        ``FrontendClosed`` after ``close()``."""
        if spec_key not in self._paths:
            raise KeyError(
                f"unknown spec_key {spec_key!r}; register() it first"
            )
        if deadline_ms is not None:
            deadline_s = deadline_ms / 1e3
        elif self._adaptive is not None:
            deadline_s = self._adaptive.delay_s
        else:
            deadline_s = self.max_delay_s
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise FrontendClosed("front-end is closed")
            self._batcher.submit(
                (spec_key, id(hg) if hg is not None else 0),
                query,
                now=self.clock(),
                deadline_s=deadline_s,
                hg=hg,
                future=fut,
                expiry=(
                    self.clock() + timeout_ms / 1e3
                    if timeout_ms is not None else None
                ),
            )
            self._cond.notify()
        self.metrics.note_submit()
        return fut

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Frontend":
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(
                target=self._worker, name="repro-torch-serve-frontend",
                daemon=True,
            )
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop accepting and stop the worker; requests still queued at
        that point resolve exceptionally with ``FrontendClosed``.

        A closed front-end never leaves a caller hanging on a future —
        and never silently executes work after the owner said stop
        (callers that want a synchronous final drain call
        ``pump(drain=True)`` BEFORE closing)."""
        with self._cond:
            self._closed = True
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._lock:
            flushes = self._batcher.drain()
        n = 0
        err = FrontendClosed(
            "front-end closed with this request still queued"
        )
        for flush in flushes:
            for r in flush.requests:
                if r.future is not None and not r.future.done():
                    r.future.set_exception(err)
                    n += 1
        if n:
            self.metrics.note_error(n)
            self.metrics.registry.counter("faults.serve.closed_failed").inc(n)

    def __enter__(self) -> "Frontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- execution ---------------------------------------------------------

    def pump(self, *, drain: bool = False) -> int:
        """Synchronously execute every due flush on the caller's thread.

        The single-threaded serving mode: property tests (fake clock,
        no sleeps) and simple replay loops call ``pump`` instead of
        ``start``.  ``drain=True`` also flushes not-yet-due groups."""
        n = 0
        while True:
            with self._lock:
                flush = self._batcher.poll(self.clock())
                due = (
                    [flush] if flush is not None
                    else self._batcher.drain() if drain
                    else []
                )
            if not due:
                return n
            for f in due:
                self._run_flush(f)
                n += 1

    def _worker(self) -> None:
        # Supervisor loop: ``_serve_loop`` IS the worker; a crash
        # anywhere in its flush path (including an injected
        # ``serve.worker`` fault) lands here, where the in-flight batch
        # is requeued (unresolved futures only, bounded by
        # ``MAX_REQUEUES``) and the loop restarts — one poisoned control
        # path cannot take the serving tier down with it.
        while True:
            try:
                self._serve_loop()
                return
            except Exception as err:  # noqa: BLE001 - supervised restart
                self._worker_restarts += 1
                self.metrics.registry.counter(
                    "faults.serve.worker_restarts"
                ).inc()
                flush, self._inflight = self._inflight, None
                if flush is not None:
                    self._requeue_after_crash(flush, err)

    def _requeue_after_crash(self, flush: Flush, err: Exception) -> None:
        survivors = []
        for r in flush.requests:
            if r.future is not None and r.future.done():
                continue
            r.requeues += 1
            if r.requeues > MAX_REQUEUES:
                # A request that keeps killing the worker resolves with
                # the crash itself — never silently dropped, never an
                # unbounded restart loop.
                self._fail(r, err)
                self.metrics.note_error()
            else:
                survivors.append(r)
        if survivors:
            with self._cond:
                self._batcher.requeue(Flush(
                    group=flush.group, requests=survivors,
                    reason=flush.reason, hg=flush.hg,
                ))
                self.metrics.registry.counter(
                    "faults.serve.requeued"
                ).inc(len(survivors))
                self._cond.notify_all()

    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                flush = None
                while not self._stop:
                    flush = self._batcher.poll(self.clock())
                    if flush is not None:
                        break
                    horizon = self._batcher.next_deadline()
                    self._cond.wait(
                        timeout=None
                        if horizon is None
                        else max(horizon - self.clock(), 0.0)
                    )
                if flush is None and self._stop:
                    # close() resolves whatever is still queued with
                    # FrontendClosed; the worker just stops.
                    return
            self._inflight = flush
            if self._injector is not None:
                self._injector.maybe_raise(
                    "serve.worker", group=str(flush.group[0])
                )
            self._run_flush(flush)
            self._inflight = None
            self.metrics.maybe_log(self.clock())

    @staticmethod
    def _fail(req, err: Exception) -> None:
        if req.future is not None and not req.future.done():
            req.future.set_exception(err)

    def _run_flush(self, flush: Flush) -> None:
        path = self._paths[flush.group[0]]
        # Skip futures a crashed-and-requeued flush already resolved.
        reqs = [
            r for r in flush.requests
            if r.future is None or not r.future.done()
        ]
        if self._resilience and reqs:
            # Hard per-request deadline: a request the tier could not
            # dispatch in time resolves exceptionally, never hangs.
            now = self.clock()
            live = []
            expired = 0
            for r in reqs:
                if r.expiry is not None and now > r.expiry:
                    self._fail(r, DeadlineExceeded(
                        f"request for {flush.group[0]!r} expired "
                        f"{(now - r.expiry) * 1e3:.1f}ms past its deadline"
                    ))
                    expired += 1
                else:
                    live.append(r)
            if expired:
                self.metrics.note_error(expired)
                self.metrics.registry.counter(
                    "faults.serve.deadline_exceeded"
                ).inc(expired)
            reqs = live
            if reqs:
                breaker = self._breakers.get(flush.group)
                if breaker is not None and not breaker.allow(self.clock()):
                    err = CircuitOpen(
                        f"circuit open for group {flush.group[0]!r} "
                        f"after {breaker.failures} consecutive failures"
                    )
                    for r in reqs:
                        self._fail(r, err)
                    self.metrics.note_error(len(reqs))
                    self.metrics.registry.counter(
                        "faults.serve.breaker_fastfails"
                    ).inc(len(reqs))
                    return
        if reqs:
            self._execute_requests(path, flush, reqs, depth=0)

    def _execute_requests(
        self, path: _Path, flush: Flush, reqs: list, depth: int
    ) -> None:
        """Execute one (sub-)batch; on failure, bisect to isolate the
        poison request instead of failing every co-batched neighbor."""
        from repro_torch.core.serving import BATCH_FLOOR, bucket_dim

        b = len(reqs)
        bucket = bucket_dim(b, floor=BATCH_FLOOR)
        dispatch = self.clock()
        waits = [dispatch - r.arrival for r in reqs]
        try:
            res, value, execute_s = self._attempt(
                path, flush, reqs, b, bucket, waits
            )
        except Exception as err:  # noqa: BLE001 - isolated or fanned out
            if self._resilience and b > 1:
                # Batch bisect: halve and retry each side independently;
                # only the poison request(s) ultimately fail, everyone
                # else is served.  log2(b) extra executes, worst case.
                self.metrics.registry.counter("faults.serve.bisects").inc()
                mid = b // 2
                self._execute_requests(path, flush, reqs[:mid], depth + 1)
                self._execute_requests(path, flush, reqs[mid:], depth + 1)
                return
            self._record_outcome(flush.group, ok=False)
            self.metrics.note_flush(
                flush.group[0], flush.reason, b, bucket, waits,
                self.clock() - dispatch, error=True,
            )
            if depth and self._resilience:
                wrapped = PoisonQuery(
                    f"query poisoned its batch "
                    f"(group {flush.group[0]!r}): {err}"
                )
                wrapped.__cause__ = err
                err = wrapped
            for r in reqs:
                self._fail(r, err)
            return
        self._record_outcome(flush.group, ok=True)
        executed = getattr(res, "supersteps_executed", None)
        # analysis: ignore[host-sync] — a host int (the pairs run)
        executed = int(executed) if executed is not None else None
        self.metrics.note_flush(
            flush.group[0], flush.reason, b, bucket, waits, execute_s,
        )
        if self._adaptive is not None:
            # Error flushes (above) don't feed the controller: their
            # execute time measures the failure, not the batch.
            self._adaptive.observe(
                execute_s=execute_s,
                occupancy=b / max(path.max_batch, 1),
                reason=flush.reason,
            )
        rows = _unstack(value, b)
        for i, r in enumerate(reqs):
            if r.future is None:
                continue
            r.future.set_result(ServedResult(
                value=rows[i],
                queue_wait_s=waits[i],
                execute_s=execute_s,
                flush_reason=flush.reason,
                batch_size=b,
                batch_bucket=bucket,
                group=flush.group[0],
                supersteps_executed=executed,
            ))

    def _attempt(self, path, flush, reqs, b, bucket, waits):
        """One execute with transient-failure retries (exponential
        backoff via the injectable ``self._sleep``)."""
        tracer = getattr(self.engine, "tracer", None)
        queries = _stack([r.query for r in reqs])
        attempt = 0
        while True:
            dispatch = self.clock()
            try:
                with maybe_span(
                    tracer, "serve.flush", cat="serve",
                    group=str(flush.group[0]), reason=flush.reason,
                    batch=b, bucket=bucket, attempt=attempt,
                ) as sp:
                    if self._injector is not None:
                        self._injector.maybe_raise(
                            "serve.flush", group=str(flush.group[0]),
                            batch=b,
                        )
                    res = path.compiled.run_batch(queries, hg=flush.hg)
                    value = res.value
                    if sp is not None:
                        tracer.block(sp, value)
                        sp.args["max_wait_s"] = max(waits, default=0.0)
                    else:
                        _block(value)
                return res, value, self.clock() - dispatch
            except Exception as err:
                if (
                    not self._resilience
                    or attempt >= self.max_retries
                    or not is_transient(err)
                ):
                    raise
                attempt += 1
                self.metrics.registry.counter("faults.serve.retries").inc()
                self._sleep(self.retry_backoff_s * (2 ** (attempt - 1)))

    def _record_outcome(self, group, *, ok: bool) -> None:
        if not self._resilience:
            return
        if ok:
            breaker = self._breakers.get(group)
            if breaker is not None:
                breaker.record_success()
            return
        breaker = self._breakers.setdefault(
            group, _Breaker(self.breaker_threshold, self.breaker_cooldown_s)
        )
        if breaker.record_failure(self.clock()):
            self.metrics.registry.counter(
                "faults.serve.breaker_trips"
            ).inc()

    # -- observability -----------------------------------------------------

    @property
    def current_delay_ms(self) -> float:
        """The flush deadline new submits get (adaptive or fixed)."""
        delay_s = (
            self._adaptive.delay_s if self._adaptive is not None
            else self.max_delay_s
        )
        return delay_s * 1e3

    def stats(self) -> dict:
        """One snapshot across the layers: front-end latency /
        occupancy, the Engine's executable cache, the disk store
        (``None`` without one) — plus the unified
        metrics registry (every provider in one view)."""
        snap = self.metrics.snapshot()
        engine_stats = None
        if hasattr(self.engine, "cache_stats"):
            engine_stats = self.engine.cache_stats()
        snap["engine_cache"] = engine_stats
        disk = getattr(self.engine, "disk_cache", None)
        snap["disk_cache"] = disk.stats() if disk is not None else None
        snap["adaptive_delay"] = (
            self._adaptive.snapshot() if self._adaptive is not None else None
        )
        snap["registry"] = self.metrics.registry.snapshot()
        return snap


# -- batch helpers over the port's trees ----------------------------------

def _stack(queries: list[Any]):
    """Stack B host queries (trees of scalars or arrays) into one
    batched tree (leading axis B)."""
    return tree_map(
        # analysis: ignore[host-sync] — queries arrive as host values
        # (scalars, numpy): batching them is host work, no device read
        lambda *leaves: np.stack([np.asarray(x) for x in leaves]),
        *queries,
    )


def _unstack(value: Any, b: int) -> list[Any]:
    """Split a batched result tree into B per-request trees.  A row is
    a view of its flush's tensor, which the flush owns (``run_batch``
    results are copies, never an executable's buffers); a leaf that is
    no tensor becomes a numpy array."""
    # analysis: ignore[host-sync] — only leaves that are no tensor (host
    # values) go through numpy; tensors are sliced where they lie
    leaves = [leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
              for leaf in tree_leaves(value)]
    rows = []
    for i in range(b):
        it = iter([leaf[i] for leaf in leaves])
        rows.append(tree_map(lambda _: next(it), value))
    return rows


def _block(value: Any) -> None:
    """Wait until the card has finished ``value``'s tensors: a future
    resolves to finished rows.  The flush's stream (this thread's
    current stream on each device) is synchronized; host values wait
    for nothing."""
    devices = {leaf.device for leaf in tree_leaves(value)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        # analysis: ignore[host-sync] — futures resolve to finished
        # rows: one wait per flush, by design
        torch.cuda.current_stream(dev).synchronize()
