"""Fault tolerance, as far as the port runs it: the typed errors that
the compile-once serving path consults (``errors``).  Injection,
checkpoint/resume and the serve tier's retries are ROADMAP.md queue 1,
item 8."""
from repro_torch.faults.errors import (
    FaultError,
    TransientExecuteError,
    is_transient,
)

__all__ = [
    "FaultError",
    "TransientExecuteError",
    "is_transient",
]
