"""The typed error taxonomy of the fault-tolerance layer (the port's
copy of the JAX package's ``repro.faults.errors``: the same classes,
bases, messages and transience).

Every failure the engine or serving tier can surface to a caller is one
of these classes — a submitted request either resolves with a result or
with a ``FaultError`` subclass; nothing hangs and nothing raises a bare
``Exception`` from the resilience paths.  ``FaultError`` subclasses
``RuntimeError`` so callers that catch ``RuntimeError`` keep working.

Transience is a property of the *class* (plus the ``transient`` flag on
``InjectedFault``): ``is_transient`` is the single predicate the serve
tier's retry loop consults, and the compiled path's delivery
degradation on the CPU (``CompiledAlgorithm._degraded_sibling``)
applies only to failures it calls permanent.  ``ReplicaLost`` and
``Overloaded`` are the multi-process tier's (``serve/router.py``).
"""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base of the taxonomy; every typed failure is one of these."""


class InjectedFault(FaultError):
    """Raised by the ``FaultInjector`` at a named failure point.

    ``transient=True`` marks the injection as retryable (the serve
    tier's backoff loop will re-execute); ``transient=False`` models a
    hard failure that must degrade or surface.
    """

    def __init__(self, message: str, *, point: str = "",
                 transient: bool = True):
        super().__init__(message)
        self.point = point
        self.transient = transient


class TransientExecuteError(FaultError):
    """An execute failure expected to succeed on retry (e.g. a device
    OOM under transient pressure, a preempted worker)."""


class DeadlineExceeded(FaultError):
    """The request's hard deadline passed before it could be served.

    The future RESOLVES with this error — an expired request never
    hangs, it fails typed."""


class FrontendClosed(FaultError):
    """The front-end was closed: ``submit`` after ``close()`` raises
    this immediately, and requests still queued at close time have
    their futures failed with it (never silently dropped)."""


class PoisonQuery(FaultError):
    """One query deterministically fails its batch.  Batch bisection
    isolated it: this error carries the original cause (``__cause__``)
    and fails only the poison request, not its flush-mates."""


class CircuitOpen(FaultError):
    """The per-signature circuit breaker is open: recent flushes for
    this compiled path failed repeatedly, so requests fail fast instead
    of burning execute retries until the cooldown elapses."""


class CorruptCacheEntry(FaultError):
    """A disk-cache entry failed its checksum / deserialize — the file
    is quarantined (renamed ``.corrupt``) and the executable recompiled."""


class CheckpointError(FaultError):
    """A superstep checkpoint could not be saved or restored."""


class ReplicaLost(FaultError):
    """A request exhausted its failover budget: every replica it was
    routed to died (missed heartbeats / broken pipe) before answering.
    The future RESOLVES with this error after ``MAX_FAILOVERS``
    re-routes — bounded, typed, never a hang."""


class Overloaded(FaultError):
    """The router shed this request at admission: total queue depth
    (pending + in-flight across the replica pool) hit the backpressure
    limit.  Fail-fast load shedding — the client should back off and
    retry; the pool keeps serving what it already accepted."""


def is_transient(err: BaseException) -> bool:
    """Should the serve tier retry after ``err``?  The one predicate the
    backoff loop consults."""
    if isinstance(err, TransientExecuteError):
        return True
    if isinstance(err, InjectedFault):
        return err.transient
    return False
