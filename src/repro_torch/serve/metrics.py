"""Latency observability for the serving tier (the port's copy of the
JAX package's ``repro.serve.metrics``).

Log-spaced histograms (p50/p99/p999 without storing samples) split into
the two halves a serving operator actually tunes against:

* **queue wait** — admission to dispatch: the price of coalescing.
  Grows with ``max_delay_ms`` and shrinks with traffic (fuller buckets
  flush sooner).
* **execute** — dispatch to results-ready: the price of the compiled
  batch itself.  Flat per bucket on the warm path; a spike here means a
  new capture or a cache miss.

Plus per-bucket occupancy (how full each flushed batch bucket ran —
low occupancy = paying padded execution for empty slots), flush-reason
counters, and the engine cache counters merged into one ``snapshot()``.
``maybe_log`` emits a one-line summary at a bounded rate for
long-running serve loops.

``LatencyHistogram`` lives in ``repro_torch.obs.metrics`` (one
histogram implementation for the serving tier and the registry) and is
re-exported here.  Every ``ServeMetrics`` also registers itself as a
``serve.frontend`` snapshot provider on the port's default
``MetricsRegistry``.
"""
from __future__ import annotations

import logging
import threading
from collections import Counter
from typing import Any

from repro_torch.obs.metrics import (  # noqa: F401 - _BOUNDS re-exported
    _BOUNDS,
    LatencyHistogram,
    default_registry,
    weak_provider,
)

log = logging.getLogger("repro_torch.serve")


class ServeMetrics:
    """The front-end's counters; thread-safe (worker + submitters)."""

    def __init__(self, log_every_s: float | None = None, registry=None):
        self._lock = threading.Lock()
        self.wait = LatencyHistogram()
        self.execute = LatencyHistogram()
        self.total = LatencyHistogram()
        self.flush_reasons: Counter = Counter()
        # (group key, batch bucket) -> occupancy accounting
        self.buckets: dict[Any, dict] = {}
        self.submitted = 0
        self.completed = 0
        self.errors = 0
        self.log_every_s = log_every_s
        self._last_log = None
        self.registry = registry if registry is not None else (
            default_registry()
        )
        self._provider_name = self.registry.register_provider(
            "serve.frontend", weak_provider(self.snapshot)
        )

    def note_submit(self, n: int = 1) -> None:
        with self._lock:
            self.submitted += n

    def note_error(self, n: int = 1) -> None:
        """Requests resolved exceptionally OUTSIDE an executed flush
        (deadline-expired, circuit-open fast-fail, front-end closed) —
        keeps the ``in_flight`` balance exact."""
        with self._lock:
            self.errors += n

    def note_flush(
        self,
        group: Any,
        reason: str,
        batch: int,
        bucket: int,
        wait_s: list[float],
        execute_s: float,
        error: bool = False,
    ) -> None:
        """One executed batch: per-request waits, one execute span."""
        with self._lock:
            self.flush_reasons[reason] += 1
            b = self.buckets.setdefault(
                (group, bucket),
                {"flushes": 0, "requests": 0, "occupancy_sum": 0.0},
            )
            b["flushes"] += 1
            b["requests"] += batch
            b["occupancy_sum"] += batch / bucket
            per_req_exec = execute_s
            for w in wait_s:
                self.wait.record(w)
                self.execute.record(per_req_exec)
                self.total.record(w + per_req_exec)
            if error:
                self.errors += batch
            else:
                self.completed += batch

    def snapshot(self) -> dict:
        with self._lock:
            buckets = {
                f"{group}/b{bucket}": {
                    **stats,
                    "mean_occupancy": (
                        stats["occupancy_sum"] / stats["flushes"]
                        if stats["flushes"]
                        else 0.0
                    ),
                }
                for (group, bucket), stats in sorted(
                    self.buckets.items(), key=lambda kv: repr(kv[0])
                )
            }
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "errors": self.errors,
                "in_flight": self.submitted - self.completed - self.errors,
                "queue_wait": self.wait.snapshot(),
                "execute": self.execute.snapshot(),
                "total_latency": self.total.snapshot(),
                "flush_reasons": dict(self.flush_reasons),
                "buckets": buckets,
            }

    def maybe_log(self, now: float) -> str | None:
        """Emit (and return) the periodic one-line summary when
        ``log_every_s`` has elapsed; None otherwise."""
        if self.log_every_s is None:
            return None
        with self._lock:
            if (
                self._last_log is not None
                and now - self._last_log < self.log_every_s
            ):
                return None
            self._last_log = now
        snap = self.snapshot()
        line = (
            f"serve: {snap['completed']} done / {snap['in_flight']} "
            f"in-flight | wait p50={snap['queue_wait']['p50_s'] * 1e3:.2f}ms "
            f"p99={snap['queue_wait']['p99_s'] * 1e3:.2f}ms | exec "
            f"p50={snap['execute']['p50_s'] * 1e3:.2f}ms "
            f"p99={snap['execute']['p99_s'] * 1e3:.2f}ms | flushes "
            f"{dict(snap['flush_reasons'])}"
        )
        log.info(line)
        return line
