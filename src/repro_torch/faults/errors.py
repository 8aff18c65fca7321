"""The typed errors of the fault-tolerance layer that serving consults
(the JAX package's ``repro.faults.errors``, the classes the port raises
or tests for).

``FaultError`` subclasses ``RuntimeError`` so callers that catch
``RuntimeError`` keep working.  Transience is a property of the class:
``is_transient`` is the one predicate a retry loop consults, and the
compiled path's delivery degradation on the CPU
(``CompiledAlgorithm._degraded_sibling``) applies only to failures it
calls permanent.
"""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base of the taxonomy; every typed failure is one of these."""


class TransientExecuteError(FaultError):
    """An execute failure expected to succeed on retry (e.g. a device
    OOM under transient pressure)."""


def is_transient(err: BaseException) -> bool:
    """Should a caller retry after ``err`` on the same design point?"""
    return isinstance(err, TransientExecuteError)
