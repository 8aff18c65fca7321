"""``FaultInjector``: fires a ``FaultPlan``'s scheduled failures (the
port's copy of the JAX package's ``repro.faults.inject``).

Attaches to ``Engine(fault_injector=...)`` / ``Frontend(...)`` exactly
like ``tracer`` — duck-typed, and every instrumented hot path branches
on ``fault_injector is None`` first, so the absent case costs one
attribute load and a predictable branch.  Where each point fires
(``faults.plan``'s table): the Engine (``layout.build``, ``execute``,
``checkpoint.chunk``) and its ``disk_cache``, which the Engine hands
its injector (``disk.read``, ``disk.deserialize``, ``disk.write``,
``compile.aot``); the ``Frontend`` (``serve.flush``, ``serve.worker``);
the ``Router`` (``router.route``); and inside each replica process,
whose ``ReplicaConfig.fault_plan`` arms an injector of its own
(``replica.crash``, ``replica.hang``, and the Engine's and front-end's
points there).  A pool's report sums the router's snapshot and each
replica's (``launch.serve_hypergraph.pool_faults``).

Determinism contract: firing is a pure function of the plan and the
per-point call sequence.  Counters are per-injector and lock-protected
(the serve worker thread and the caller thread both hit them); the
probabilistic trigger draws from a per-rule ``random.Random(seed)``
stream advanced once per call to its point, so replaying the same
traffic replays the same faults — in either package.
"""
from __future__ import annotations

import random
import threading
from collections import Counter

from repro_torch.faults.errors import (
    CorruptCacheEntry,
    InjectedFault,
    TransientExecuteError,
)
from repro_torch.faults.plan import FaultPlan


class FaultInjector:
    """Raise the plan's scheduled fault when an instrumented point is hit.

    ``maybe_raise(point)`` is the whole API surface the instrumented
    code uses; ``calls`` / ``fired`` / ``snapshot()`` are for tests and
    the CLI's chaos report.
    """

    def __init__(self, plan: FaultPlan | None = None):
        self.plan = plan if plan is not None else FaultPlan()
        self._lock = threading.Lock()
        self._calls: Counter[str] = Counter()
        self._fired: Counter[str] = Counter()
        self._rule_fired: Counter[int] = Counter()
        self._rng: dict[int, random.Random] = {
            i: random.Random(rule.seed)
            for i, rule in enumerate(self.plan.rules)
            if rule.trigger == "prob"
        }
        # point -> [(rule_index, rule)]; points with no rules never take
        # the lock's slow path beyond the counter bump.
        self._by_point: dict[str, list] = {}
        for i, rule in enumerate(self.plan.rules):
            self._by_point.setdefault(rule.point, []).append((i, rule))

    @classmethod
    def from_json(cls, obj) -> "FaultInjector":
        return cls(FaultPlan.from_json(obj))

    def maybe_raise(self, point: str, **ctx) -> None:
        """Advance the point's call counter; raise if a rule fires."""
        with self._lock:
            self._calls[point] += 1
            call_idx = self._calls[point]
            rules = self._by_point.get(point)
            if not rules:
                return
            for i, rule in rules:
                if rule.times is not None and self._rule_fired[i] >= rule.times:
                    continue
                if not self._triggers(i, rule, call_idx):
                    continue
                self._rule_fired[i] += 1
                self._fired[point] += 1
                err = self._make_error(rule, point, call_idx, ctx)
                break
            else:
                return
        raise err

    def _triggers(self, i: int, rule, call_idx: int) -> bool:
        if rule.trigger == "always":
            return True
        if rule.trigger == "nth":
            return call_idx == rule.n
        if rule.trigger == "every":
            return call_idx % rule.n == 0
        # prob: one draw per call, deterministic per rule seed.
        return self._rng[i].random() < rule.p

    @staticmethod
    def _make_error(rule, point, call_idx, ctx):
        detail = f" ({ctx})" if ctx else ""
        msg = (
            f"injected {rule.error} fault at {point!r} "
            f"(call #{call_idx}){detail}"
        )
        if rule.error == "corrupt":
            return CorruptCacheEntry(msg)
        if rule.error == "transient":
            return TransientExecuteError(msg)
        return InjectedFault(msg, point=point, transient=False)

    # -- inspection --------------------------------------------------------

    def calls(self, point: str) -> int:
        with self._lock:
            return self._calls[point]

    def fired(self, point: str | None = None) -> int:
        with self._lock:
            if point is None:
                return sum(self._fired.values())
            return self._fired[point]

    def snapshot(self) -> dict:
        """Per-point calls/fired, plus ``never_fired``: points the plan
        targets whose rules never triggered — a chaos run asserts this is
        empty to prove the plan actually exercised every scheduled
        failure (a plan that silently misses its points tests nothing)."""
        with self._lock:
            planned = {r.point for r in self.plan.rules}
            return {
                "calls": dict(self._calls),
                "fired": dict(self._fired),
                "never_fired": sorted(
                    p for p in planned if self._fired[p] == 0
                ),
            }
