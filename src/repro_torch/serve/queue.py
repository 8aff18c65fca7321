"""The coalescing batcher: heterogeneous requests -> homogeneous batches
(the port's copy of the JAX package's ``repro.serve.queue``).

``CompiledAlgorithm.run_batch`` wants B same-signature queries at once;
real traffic arrives one query at a time, interleaved across algorithms
and hypergraphs.  ``CoalescingBatcher`` bridges the two:

* requests group by an opaque **group key** — the front-end uses
  ``(spec_key, hypergraph identity)``, so only queries that share one
  compiled executable signature ever coalesce;
* each group **admits** up to its capacity (the batch bucket the
  executable was compiled for); an arrival that fills the group makes
  it immediately flushable (reason ``"full"``);
* a group whose **oldest deadline** has passed is flushable with
  whatever it holds (reason ``"deadline"`` — the partial-flush path
  that bounds tail latency);
* ``drain`` flushes everything regardless (reason ``"drain"`` —
  shutdown / test pump).

The batcher is intentionally pure plumbing: no threads, no torch, no
wall clock (callers inject ``now``) — so the coalescing invariants
(every request flushed exactly once, never above capacity, FIFO within
a group) are property-testable in microseconds.  Thread-safety and
execution live in ``repro_torch.serve.frontend``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

FLUSH_REASONS = ("full", "deadline", "drain")


@dataclasses.dataclass
class Request:
    """One in-flight query.

    ``deadline`` is absolute (same clock as ``submit``'s ``now``):
    the latest instant this request may keep waiting for co-batchable
    traffic.  ``expiry`` (also absolute, None = no limit) is the
    request's HARD deadline: past it the front-end resolves the future
    with ``DeadlineExceeded`` instead of serving.  ``future`` is
    whatever completion handle the caller attaches (the front-end uses
    ``concurrent.futures.Future``; the pure tests use plain lists).
    ``requeues`` counts worker-crash requeues (bounded by the
    supervisor so a deterministic crash cannot loop forever)."""

    group: Any
    query: Any
    arrival: float
    deadline: float
    future: Any = None
    seq: int = 0
    expiry: float | None = None
    requeues: int = 0


@dataclasses.dataclass
class Flush:
    """One batch handed to the executor: FIFO requests of one group."""

    group: Any
    requests: list[Request]
    reason: str
    hg: Any = None


class _Group:
    __slots__ = ("hg", "pending")

    def __init__(self, hg):
        self.hg = hg
        self.pending: list[Request] = []


class CoalescingBatcher:
    """Admission + flush policy over pending request groups.

    ``capacity``: max requests per flush (per group) — the batch bucket.
    May be an int or a ``key -> int`` callable for per-group buckets.
    """

    def __init__(self, capacity: Any = 64):
        self._capacity = capacity
        self._groups: dict[Any, _Group] = {}
        self._seq = itertools.count()

    def capacity(self, group_key: Any) -> int:
        cap = self._capacity
        cap = cap(group_key) if callable(cap) else cap
        if cap < 1:
            raise ValueError(f"capacity for {group_key!r} must be >= 1")
        return int(cap)

    # -- admission ---------------------------------------------------------

    def submit(
        self,
        group_key: Any,
        query: Any,
        *,
        now: float,
        deadline_s: float,
        hg: Any = None,
        future: Any = None,
        expiry: float | None = None,
    ) -> Request:
        """Admit one request; duplicates of an in-flight query are real
        requests (each gets its own slot and future)."""
        req = Request(
            group=group_key,
            query=query,
            arrival=now,
            deadline=now + deadline_s,
            future=future,
            seq=next(self._seq),
            expiry=expiry,
        )
        grp = self._groups.get(group_key)
        if grp is None:
            grp = self._groups[group_key] = _Group(hg)
        elif grp.hg is not hg and grp.pending:
            raise ValueError(
                f"group {group_key!r} has pending requests against a "
                "different hypergraph; use a distinct group key per "
                "hypergraph"
            )
        else:
            grp.hg = hg
        grp.pending.append(req)
        return req

    # -- flush policy ------------------------------------------------------

    def pending_count(self) -> int:
        return sum(len(g.pending) for g in self._groups.values())

    def next_deadline(self) -> float | None:
        """Earliest pending deadline, or None when idle — the worker's
        sleep horizon."""
        deadlines = [
            g.pending[0].deadline
            for g in self._groups.values()
            if g.pending
        ]
        return min(deadlines) if deadlines else None

    def poll(self, now: float) -> Flush | None:
        """The next due flush, or None.

        Full groups flush first (they can't improve by waiting); then
        the group with the OLDEST expired deadline (fairness under
        sustained overload).  A full group yields exactly ``capacity``
        requests and keeps the remainder queued with their original
        deadlines."""
        full_key = None
        expired_key, expired_deadline = None, None
        for key, grp in self._groups.items():
            if not grp.pending:
                continue
            if len(grp.pending) >= self.capacity(key):
                full_key = key
                break
            head = grp.pending[0].deadline
            if head <= now and (
                expired_deadline is None or head < expired_deadline
            ):
                expired_key, expired_deadline = key, head
        if full_key is not None:
            return self._take(full_key, "full")
        if expired_key is not None:
            return self._take(expired_key, "deadline")
        return None

    def drain(self) -> list[Flush]:
        """Flush every pending request (capacity-sized chunks), FIFO."""
        flushes = []
        for key in list(self._groups):
            while self._groups[key].pending:
                flushes.append(self._take(key, "drain"))
        return flushes

    def _take(self, key: Any, reason: str) -> Flush:
        grp = self._groups[key]
        cap = self.capacity(key)
        batch, grp.pending = grp.pending[:cap], grp.pending[cap:]
        return Flush(group=key, requests=batch, reason=reason, hg=grp.hg)

    def requeue(self, flush: Flush) -> None:
        """Put a crashed worker's in-flight requests back at the HEAD of
        their group, preserving FIFO order (their original deadlines
        make the group immediately due again)."""
        grp = self._groups.get(flush.group)
        if grp is None:
            grp = self._groups[flush.group] = _Group(flush.hg)
        grp.hg = flush.hg
        grp.pending[:0] = flush.requests


class AdaptiveDelay:
    """Bounded EWMA controller for the coalescing flush deadline.

    The fixed ``max_delay_ms`` is a guess; the right deadline depends
    on traffic, and the wait/execute split ``ServeMetrics`` already
    records says which way it's wrong.  Policy (one signal per flush):

    * reason ``"full"`` — buckets fill before any deadline: waiting
      buys nothing, pull the deadline toward ``lo_s``;
    * reason ``"deadline"`` at LOW occupancy — flushes go out mostly
      empty: waiting longer could coalesce more, pull toward
      ``exec_ratio x EWMA(execute)`` (a request should never wait much
      longer than the batch execute its waiting saves);
    * otherwise (deadline flush, decently full) — hold.

    Every update is one gain-bounded EWMA step clamped to
    ``[lo_s, hi_s]``, so the delay is ALWAYS in bounds and converges
    geometrically under a steady signal — both property-tested.  Pure
    and clock-free (callers pass observed durations), like the batcher;
    OFF by default (``Frontend(adaptive_delay=True)`` opts in).
    """

    def __init__(
        self,
        delay_s: float,
        *,
        lo_s: float = 5e-4,
        hi_s: float = 5e-2,
        gain: float = 0.3,
        exec_alpha: float = 0.3,
        exec_ratio: float = 1.0,
        low_occupancy: float = 0.5,
    ):
        if not 0.0 < lo_s <= hi_s:
            raise ValueError(f"need 0 < lo_s <= hi_s, got {lo_s}, {hi_s}")
        if not 0.0 < gain <= 1.0:
            raise ValueError(f"gain must be in (0, 1], got {gain}")
        self.lo_s, self.hi_s = float(lo_s), float(hi_s)
        self.gain = float(gain)
        self.exec_alpha = float(exec_alpha)
        self.exec_ratio = float(exec_ratio)
        self.low_occupancy = float(low_occupancy)
        self._exec_ewma: float | None = None
        self.delay_s = self._clamp(float(delay_s))
        self.observations = 0

    def _clamp(self, x: float) -> float:
        return min(max(x, self.lo_s), self.hi_s)

    def observe(
        self, *, execute_s: float, occupancy: float, reason: str
    ) -> float:
        """Fold in one flush; returns the updated delay (seconds)."""
        execute_s = max(float(execute_s), 0.0)
        self._exec_ewma = (
            execute_s
            if self._exec_ewma is None
            else (1.0 - self.exec_alpha) * self._exec_ewma
            + self.exec_alpha * execute_s
        )
        if reason == "full":
            target = self.lo_s
        elif occupancy <= self.low_occupancy:
            target = self._clamp(self.exec_ratio * self._exec_ewma)
        else:
            target = self.delay_s
        self.delay_s = self._clamp(
            self.delay_s + self.gain * (target - self.delay_s)
        )
        self.observations += 1
        return self.delay_s

    def snapshot(self) -> dict:
        return {
            "delay_s": self.delay_s,
            "exec_ewma_s": self._exec_ewma,
            "observations": self.observations,
            "lo_s": self.lo_s,
            "hi_s": self.hi_s,
        }
