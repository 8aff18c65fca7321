"""``Router``: the replica-pool front-end with heartbeat failover (the
port's copy of the JAX package's ``repro.serve.router``: host logic
only, on the port's ``faults.errors`` and ``obs.metrics``).

The in-process front-end (``repro_torch.serve.frontend``) keeps one
invariant inside a single process: every submitted request resolves —
value or typed error — no matter what the fault plan does.  This
module extends that invariant across process boundaries.  The router
owns N ``ProcessReplica`` handles (``repro_torch.serve.replica``), all
booted from one shared ``DiskExecutableCache``, and guarantees:

* **Routing** — signature-affinity first (a stable ``crc32`` of the
  spec key pins a key to a home replica, keeping that replica's
  executable LRU hot), falling back to least-loaded when the home
  replica is busier than the pool minimum by more than
  ``affinity_slack`` requests, dead, or still booting.
* **Death detection** — a replica is declared dead when its pipe
  breaks/EOFs, its process exits, or it misses heartbeats for
  ``heartbeat_timeout_ms`` (catches the wedged-but-alive case that pipe
  liveness can't).
* **Failover** — a dead replica's in-flight requests re-route to a
  peer.  Re-execution is safe (compiled paths are deterministic) and
  bounded: after ``MAX_FAILOVERS`` re-routes a request resolves with
  ``ReplicaLost`` instead of bouncing forever.
* **Respawn** — a dead slot respawns via the factory; the newcomer
  boots from the shared store's records and rejoins the ready set on
  its ``("ready", ...)`` message.
* **Load shedding** — admission fails fast with ``Overloaded`` once
  pending + in-flight hits ``max_queue_depth``; the pool keeps serving
  what it already accepted.

``submit`` ALWAYS returns a ``Future`` and every future resolves:
shed, route-fault, closed, and replica-lost requests resolve with their
typed error rather than raising at the call site, so a replay loop is
``wait(futures)`` + classify, never try/except around admission.

Testability mirrors the batcher: the clock is injected and ``pump(now)``
is the whole control loop as a pure-ish step — fake-clock unit tests
drive death detection, failover bounding and shedding with fake replica
handles and no processes, threads, or sleeps.  ``start()`` merely runs
``pump`` on a thread against the real clock, waking when a replica's
pipe has a message (the JAX package's thread sleeps a fixed interval).
"""
from __future__ import annotations

import itertools
import multiprocessing.connection
import threading
import time
import zlib
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable

from repro_torch.faults.errors import FrontendClosed, Overloaded, ReplicaLost
from repro_torch.obs.metrics import default_registry, weak_provider

# A request survives this many re-routes before resolving ReplicaLost.
MAX_FAILOVERS = 2

_BOOTING, _READY, _DEAD = "booting", "ready", "dead"


class _Pending:
    """One admitted request: what we need to (re)send it + its future."""

    __slots__ = ("req_id", "spec_key", "query", "hg_ref", "deadline_ms",
                 "future", "failovers")

    def __init__(self, req_id, spec_key, query, hg_ref, deadline_ms):
        self.req_id = req_id
        self.spec_key = spec_key
        self.query = query
        self.hg_ref = hg_ref
        self.deadline_ms = deadline_ms
        self.future: Future = Future()
        self.failovers = 0


class _Slot:
    """One replica position: the handle cycles through boot/ready/dead
    (and back, via respawn) while the slot identity — and its affinity
    hash target — stays fixed."""

    __slots__ = ("index", "handle", "state", "last_seen", "boot_started",
                 "in_flight", "served", "errors", "deaths", "respawns",
                 "boot_report", "hb", "fatal")

    def __init__(self, index: int, handle, now: float):
        self.index = index
        self.handle = handle
        self.state = _BOOTING
        self.last_seen = now
        self.boot_started = now
        self.in_flight: dict[int, _Pending] = {}
        self.served = 0
        self.errors = 0
        self.deaths = 0
        self.respawns = 0
        self.boot_report: dict | None = None
        self.hb: dict | None = None
        self.fatal: str | None = None


class Router:
    """Replica-pool front-end: route / detect / fail over / respawn.

    ``factory(index)`` returns a replica handle exposing the
    ``ProcessReplica`` interface (``poll_messages``/``send``/``alive``/
    ``stop``/``kill``); tests substitute in-memory fakes.
    """

    def __init__(
        self,
        factory: Callable[[int], Any],
        n_replicas: int,
        *,
        heartbeat_timeout_ms: float = 1000.0,
        boot_timeout_s: float = 180.0,
        max_queue_depth: int = 256,
        max_in_flight: int = 32,
        respawn: bool = True,
        max_respawns: int = 3,
        affinity_slack: int = 2,
        clock: Callable[[], float] = time.monotonic,
        poll_interval_s: float = 0.02,
        fault_injector=None,
        registry=None,
    ):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self._factory = factory
        self._hb_timeout_s = heartbeat_timeout_ms / 1000.0
        self._boot_timeout_s = boot_timeout_s
        self._max_queue_depth = max_queue_depth
        self._max_in_flight = max_in_flight
        self._respawn = respawn
        self._max_respawns = max_respawns
        self._affinity_slack = affinity_slack
        self._clock = clock
        self._poll_interval_s = poll_interval_s
        self.fault_injector = fault_injector
        self._lock = threading.RLock()
        self._ids = itertools.count(1)
        self._pending: deque[_Pending] = deque()
        self._closed = False
        self._thread: threading.Thread | None = None
        self._stop_thread = False
        now = self._clock()
        self.slots = [_Slot(i, factory(i), now) for i in range(n_replicas)]

        reg = registry if registry is not None else default_registry()
        self._m_deaths = reg.counter("faults.replica.deaths")
        self._m_respawns = reg.counter("faults.replica.respawns")
        self._m_failovers = reg.counter("faults.replica.failovers")
        self._m_lost = reg.counter("faults.replica.lost")
        self._m_shed = reg.counter("serve.router.shed")
        self._m_route_faults = reg.counter("serve.router.route_faults")
        self._m_closed_failed = reg.counter("serve.router.closed_failed")
        self._provider = reg.register_provider(
            "serve.router", weak_provider(self.stats)
        )

    # -- admission ---------------------------------------------------------

    def submit(
        self,
        spec_key: Any,
        hg_ref: Any = None,
        query: Any = None,
        deadline_ms: float | None = None,
    ) -> Future:
        """Admit one request; the returned future ALWAYS resolves — to a
        ``ServedResult`` or to a typed error (``Overloaded`` at the
        admission edge, ``FrontendClosed`` after ``close``,
        ``ReplicaLost`` past the failover budget, or whatever typed
        error the replica itself fanned back)."""
        req = _Pending(next(self._ids), spec_key, query, hg_ref, deadline_ms)
        resolutions: list = []
        with self._lock:
            if self._closed:
                self._m_closed_failed.inc()
                resolutions.append(
                    (req, FrontendClosed("router is closed"))
                )
            elif not self._admit(req, resolutions):
                pass           # _admit resolved it (shed / route fault)
            else:
                self._dispatch(resolutions)
        self._apply(resolutions)
        return req.future

    def _admit(self, req: _Pending, resolutions: list) -> bool:
        if self.fault_injector is not None:
            try:
                self.fault_injector.maybe_raise(
                    "router.route", spec_key=req.spec_key
                )
            except Exception as err:
                self._m_route_faults.inc()
                resolutions.append((req, err))
                return False
        depth = len(self._pending) + sum(
            len(s.in_flight) for s in self.slots
        )
        if depth >= self._max_queue_depth:
            self._m_shed.inc()
            resolutions.append((req, Overloaded(
                f"queue depth {depth} >= {self._max_queue_depth}; "
                f"back off and retry"
            )))
            return False
        self._pending.append(req)
        return True

    # -- routing -----------------------------------------------------------

    def _route(self, req: _Pending) -> _Slot | None:
        """Pick a ready slot: home-by-affinity unless it lags the
        least-loaded by more than ``affinity_slack``.

        Slots at ``max_in_flight`` don't take more: the surplus stays in
        the router's pending queue.  This bounds the blast radius of one
        crash — a dying replica burns at most ``max_in_flight`` requests'
        failover budget, not the whole backlog."""
        ready = [
            s for s in self.slots
            if s.state == _READY and len(s.in_flight) < self._max_in_flight
        ]
        if not ready:
            return None
        least = min(ready, key=lambda s: (len(s.in_flight), s.index))
        home_idx = zlib.crc32(repr(req.spec_key).encode()) % len(self.slots)
        home = self.slots[home_idx]
        if home.state == _READY and (
            len(home.in_flight) < self._max_in_flight
        ) and (
            len(home.in_flight) <= len(least.in_flight) + self._affinity_slack
        ):
            return home
        return least

    def _dispatch(self, resolutions: list) -> None:
        """Drain pending into ready slots; a send failure is a death
        declaration and its failover path requeues, so this loops until
        pending is empty or no slot is ready."""
        now = self._clock()
        while self._pending:
            slot = self._route(self._pending[0])
            if slot is None:
                break
            req = self._pending.popleft()
            slot.in_flight[req.req_id] = req
            try:
                slot.handle.send((
                    "req", req.req_id, req.spec_key, req.query,
                    req.hg_ref, req.deadline_ms,
                ))
            except Exception as err:
                # Broken pipe at send: the slot is dead; the request we
                # just attached fails over with the rest of its in-flight.
                self._mark_dead(slot, now, f"send failed: {err}",
                                resolutions)
        self._fail_pending_if_hopeless(resolutions)

    def _fail_pending_if_hopeless(self, resolutions: list) -> None:
        """With every slot permanently dead (no respawn budget left),
        queued requests can never execute — resolve them ``ReplicaLost``
        now rather than hang."""
        if self._pending and all(
            s.state == _DEAD for s in self.slots
        ):
            while self._pending:
                req = self._pending.popleft()
                self._m_lost.inc()
                resolutions.append((req, ReplicaLost(
                    f"request {req.req_id}: all {len(self.slots)} replicas "
                    f"dead with no respawn budget left"
                )))

    # -- the control step --------------------------------------------------

    def pump(self, now: float | None = None) -> None:
        """One control step: drain replica messages, detect deaths,
        fail over, respawn, dispatch.  The background thread calls this
        in a loop; fake-clock tests call it directly."""
        resolutions: list = []
        with self._lock:
            if now is None:
                now = self._clock()
            for slot in self.slots:
                if slot.state == _DEAD:
                    continue
                for msg in slot.handle.poll_messages():
                    slot.last_seen = now
                    self._on_message(slot, msg, resolutions)
            for slot in self.slots:
                if slot.state == _DEAD:
                    continue
                if not slot.handle.alive():
                    self._mark_dead(slot, now, "process exited",
                                    resolutions)
                elif slot.state == _READY and (
                    now - slot.last_seen > self._hb_timeout_s
                ):
                    self._mark_dead(slot, now, "missed heartbeats",
                                    resolutions)
                elif slot.state == _BOOTING and (
                    now - slot.boot_started > self._boot_timeout_s
                ):
                    self._mark_dead(slot, now, "boot timeout", resolutions)
            self._dispatch(resolutions)
        self._apply(resolutions)

    def _on_message(self, slot: _Slot, msg, resolutions: list) -> None:
        kind = msg[0]
        if kind == "ready":
            slot.state = _READY
            slot.boot_report = msg[1]
        elif kind == "hb":
            slot.hb = msg[1]
        elif kind == "res":
            req = slot.in_flight.pop(msg[1], None)
            if req is not None:        # None: already failed over, stale
                slot.served += 1
                resolutions.append((req, ("ok", msg[2])))
        elif kind == "err":
            req = slot.in_flight.pop(msg[1], None)
            if req is not None:
                slot.errors += 1
                resolutions.append((req, msg[2]))
        elif kind == "fatal":
            slot.fatal = msg[1]
        elif kind == "bye":
            slot.hb = msg[1]

    # -- death / failover / respawn ----------------------------------------

    def _mark_dead(self, slot: _Slot, now: float, why: str,
                   resolutions: list) -> None:
        slot.state = _DEAD
        slot.deaths += 1
        self._m_deaths.inc()
        slot.handle.stop(force=True)
        # Failover: the dead replica's in-flight requests go back to the
        # FRONT of the queue (they have waited longest), each burning one
        # unit of failover budget.
        for req in reversed(list(slot.in_flight.values())):
            slot.in_flight.pop(req.req_id, None)
            req.failovers += 1
            if req.failovers > MAX_FAILOVERS:
                self._m_lost.inc()
                resolutions.append((req, ReplicaLost(
                    f"request {req.req_id} lost replica {slot.index} "
                    f"({why}); failover budget ({MAX_FAILOVERS}) exhausted"
                )))
            else:
                self._m_failovers.inc()
                self._pending.appendleft(req)
        if self._respawn and slot.respawns < self._max_respawns \
                and not self._closed:
            slot.respawns += 1
            self._m_respawns.inc()
            slot.handle = self._factory(slot.index)
            slot.state = _BOOTING
            slot.boot_started = now
            slot.last_seen = now
            slot.boot_report = None
        self._fail_pending_if_hopeless(resolutions)

    # -- resolution (outside the lock) -------------------------------------

    @staticmethod
    def _apply(resolutions: list) -> None:
        """Resolve futures OUTSIDE the router lock: done-callbacks may
        re-enter ``submit``/``stats`` and must not deadlock."""
        for req, outcome in resolutions:
            if req.future.done():      # failover raced a late result
                continue
            if isinstance(outcome, tuple) and outcome[0] == "ok":
                req.future.set_result(outcome[1])
            else:
                req.future.set_exception(outcome)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Router":
        if self._thread is None:
            self._stop_thread = False
            self._thread = threading.Thread(
                target=self._loop, name="repro-torch-serve-router",
                daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_thread:
            self.pump()
            self._wait_for_messages()

    def _wait_for_messages(self) -> None:
        """Sleep until a live replica's pipe has a message, at most
        ``poll_interval_s``.  The JAX package's loop sleeps the whole
        interval: with a replica's answers of megabytes (a whole-graph
        vector per request on the card), that sleep between messages
        held the pool's throughput.  Handles without a ``connection``
        (test fakes) sleep."""
        with self._lock:
            conns = [getattr(s.handle, "connection", None)
                     for s in self.slots if s.state != _DEAD]
        conns = [c for c in conns if c is not None]
        if not conns:
            time.sleep(self._poll_interval_s)
            return
        try:
            multiprocessing.connection.wait(conns, self._poll_interval_s)
        except (OSError, ValueError):  # a pipe closed under us: pump
            pass

    def wait_ready(self, min_ready: int | None = None,
                   timeout_s: float = 180.0) -> int:
        """Block until ``min_ready`` replicas (default: all) answered
        ``ready``.  Raises on timeout, quoting any ``fatal`` boot
        errors the replicas reported."""
        want = len(self.slots) if min_ready is None else min_ready
        deadline = time.monotonic() + timeout_s
        while True:
            if self._thread is None:
                self.pump()
            with self._lock:
                n = sum(1 for s in self.slots if s.state == _READY)
                fatals = [s.fatal for s in self.slots if s.fatal]
            if n >= want:
                return n
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{n}/{want} replicas ready after {timeout_s}s; "
                    f"boot errors: {fatals or 'none'}"
                )
            time.sleep(0.02)

    def close(self) -> None:
        """Stop the pool.  A final pump collects results already on the
        wire; everything still unresolved — queued or in flight — fails
        typed with ``FrontendClosed``.  Idempotent; never hangs."""
        self.pump()
        resolutions: list = []
        with self._lock:
            if self._closed:
                return
            self._closed = True
            while self._pending:
                req = self._pending.popleft()
                self._m_closed_failed.inc()
                resolutions.append(
                    (req, FrontendClosed("router closed while queued"))
                )
            for slot in self.slots:
                for req in list(slot.in_flight.values()):
                    slot.in_flight.pop(req.req_id, None)
                    self._m_closed_failed.inc()
                    resolutions.append(
                        (req, FrontendClosed("router closed in flight"))
                    )
        self._apply(resolutions)
        self._stop_thread = True
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        for slot in self.slots:
            if slot.state != _DEAD:
                slot.handle.stop()
                slot.state = _DEAD

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- inspection --------------------------------------------------------

    def in_flight(self) -> int:
        with self._lock:
            return sum(len(s.in_flight) for s in self.slots)

    def stats(self) -> dict:
        """Pool totals + per-replica detail; also the registry's
        ``serve.router`` snapshot provider."""
        with self._lock:
            per = []
            for s in self.slots:
                per.append({
                    "index": s.index,
                    "state": s.state,
                    "in_flight": len(s.in_flight),
                    "served": s.served,
                    "errors": s.errors,
                    "deaths": s.deaths,
                    "respawns": s.respawns,
                    "boot": s.boot_report,
                    "replica_counts": s.hb,
                })
            return {
                "replicas": len(self.slots),
                "ready": sum(1 for s in self.slots if s.state == _READY),
                "pending": len(self._pending),
                "in_flight": sum(len(s.in_flight) for s in self.slots),
                "served": sum(s.served for s in self.slots),
                "errors": sum(s.errors for s in self.slots),
                "deaths": self._m_deaths.value,
                "respawns": self._m_respawns.value,
                "failovers": self._m_failovers.value,
                "lost": self._m_lost.value,
                "shed": self._m_shed.value,
                "per_replica": per,
            }
