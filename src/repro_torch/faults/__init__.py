"""Fault tolerance: injection harness, typed errors, checkpoint/resume
(the port's counterpart of the JAX package's ``repro.faults``).

* ``errors``     — the typed taxonomy every degradation path speaks
  (``FaultError`` and friends); callers can catch one base class.
* ``plan``       — ``FaultPlan``: named failure points x deterministic
  trigger schedules (nth-call / every-nth / probabilistic-with-seed /
  always), JSON round-trippable for ``--fault-plan``; a plan's JSON
  loads in either package and fires on the same calls.
* ``inject``     — ``FaultInjector``: attaches to ``Engine`` /
  ``Frontend`` duck-typed like ``tracer``; hot paths branch on
  ``is None`` so an absent injector costs nothing.
* ``checkpoint`` — superstep checkpoint/resume
  (``ExecutionConfig.checkpoint_every``): resume mid-algorithm bitwise
  equal to an uninterrupted run, on the card too.

On the card a permanent fault reaches the request as its typed error:
the ``xla`` delivery twin serves CPU requests only
(``CompiledAlgorithm._degraded_sibling``).
"""
from repro_torch.faults.errors import (
    CheckpointError,
    CircuitOpen,
    CorruptCacheEntry,
    DeadlineExceeded,
    FaultError,
    FrontendClosed,
    InjectedFault,
    Overloaded,
    PoisonQuery,
    ReplicaLost,
    TransientExecuteError,
    is_transient,
)
from repro_torch.faults.inject import FaultInjector
from repro_torch.faults.plan import FAULT_POINTS, FaultPlan, FaultRule

__all__ = [
    "FAULT_POINTS",
    "CheckpointError",
    "CircuitOpen",
    "CorruptCacheEntry",
    "DeadlineExceeded",
    "FaultError",
    "FaultInjector",
    "FaultPlan",
    "FaultRule",
    "FrontendClosed",
    "InjectedFault",
    "Overloaded",
    "PoisonQuery",
    "ReplicaLost",
    "TransientExecuteError",
    "is_transient",
]
