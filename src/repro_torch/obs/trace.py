"""Structured trace spans: where a superstep's wall time actually goes
(the port's own copy of the JAX package's ``repro.obs.trace``).

``Tracer`` records phase spans — layout build, lowering/compile,
disk-cache load, execute, per-flush serve pump — into a bounded ring
buffer, and exports them as Chrome-trace JSON (``tracer.export(path)``)
loadable in Perfetto / ``chrome://tracing``.

Design constraints, in order:

* **zero overhead when absent** — hot paths branch on ``tracer is
  None`` (or call ``maybe_span``, which returns a no-op context);
  nothing is computed, allocated or locked without a tracer attached
  (benchmarked in ``benchmarks/bench_obs.py``);
* **clock-injected** — ``Tracer(clock=...)`` like the front-end, so
  span timing is deterministic under test;
* **bounded** — a ``deque(maxlen=capacity)`` ring; long serve loops
  keep the newest spans and count the ``dropped`` rest;
* **device-time aware** — a CUDA launch returns before the card
  finishes, so a span around the launches alone measures enqueue
  time.  ``tracer.block(span, value)`` runs ``torch.cuda.synchronize``
  on the value's device and records the wait as
  ``args["device_wait_s"]``: span duration = dispatch + device
  completion, the wall time a caller actually sees.

Attach with ``Engine(tracer=Tracer())`` — duck-typed like
``disk_cache``: anything with ``span``/``block`` works.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any

import torch


class Span:
    """One completed (or open) phase: name, category, [t0, t0+dur)."""

    __slots__ = ("name", "cat", "t0", "dur_s", "tid", "depth", "args")

    def __init__(self, name, cat, t0, tid, depth, args):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.dur_s = 0.0
        self.tid = tid
        self.depth = depth
        self.args = args

    def to_chrome(self) -> dict:
        """One Chrome-trace complete event ("ph": "X", microseconds)."""
        return {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": self.t0 * 1e6,
            "dur": self.dur_s * 1e6,
            "pid": os.getpid(),
            "tid": self.tid,
            "args": {"depth": self.depth, **self.args},
        }

    def __repr__(self):
        return (
            f"Span({self.name!r}, cat={self.cat!r}, "
            f"dur={self.dur_s * 1e3:.3f}ms, depth={self.depth})"
        )


class Tracer:
    """Ring-buffered span recorder; thread-safe, nesting per thread."""

    def __init__(self, capacity: int = 4096, clock=time.perf_counter):
        self.capacity = int(capacity)
        self.clock = clock
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=self.capacity)
        self._local = threading.local()
        self.total = 0  # spans ever recorded; dropped = total - len(ring)

    @property
    def dropped(self) -> int:
        return max(self.total - len(self._spans), 0)

    @contextmanager
    def span(self, name: str, cat: str = "engine", **args):
        """Record one phase; yields the ``Span`` so callers can attach
        measurements (``sp.args[...] = ...``) before it closes.  Spans
        nest per thread (``depth`` reflects the enclosing stack)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        sp = Span(
            name, cat, self.clock(), threading.get_ident(),
            len(stack), dict(args),
        )
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.dur_s = self.clock() - sp.t0
            stack.pop()
            with self._lock:
                self._spans.append(sp)
                self.total += 1

    def block(self, sp: Span, value: Any) -> Any:
        """Wait for the card to finish ``value``, recording the wait on
        the span as ``device_wait_s``; returns ``value``.  The
        dispatch/completion split is the one number a CUDA stream won't
        tell you from wall time alone.  ``torch.cuda.synchronize`` runs
        once per CUDA device among ``value``'s tensors (a tensor or a
        tree of them); CPU tensors, numpy arrays and other values wait for
        nothing."""
        t0 = self.clock()
        for dev in _cuda_devices(value):
            torch.cuda.synchronize(dev)
        sp.args["device_wait_s"] = self.clock() - t0
        return value

    # -- inspection / export -----------------------------------------------

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.total = 0

    def chrome_trace(self) -> dict:
        """The ``{"traceEvents": [...]}`` payload Perfetto loads."""
        return {
            "traceEvents": [sp.to_chrome() for sp in self.spans()],
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": self.dropped},
        }

    def export(self, path: str) -> str:
        """Write Chrome-trace JSON; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


def _cuda_devices(value: Any) -> set:
    """The CUDA devices of the tensors in a tree of tuples, lists and
    dicts."""
    from repro_torch.core.api import tree_leaves

    return {leaf.device for leaf in tree_leaves(value)
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}


def maybe_span(tracer, name: str, cat: str = "engine", **args):
    """``tracer.span(...)`` or a no-op context yielding ``None``."""
    if tracer is None:
        return nullcontext(None)
    return tracer.span(name, cat=cat, **args)
