"""``FaultPlan``: a deterministic schedule of injected failures (the
port's copy of the JAX package's ``repro.faults.plan``, so that one
plan's JSON loads in either package and fires on the same calls).

A plan is a list of ``FaultRule``s.  Each rule names a **failure
point** — a string the instrumented code passes to
``FaultInjector.maybe_raise`` — and a **trigger schedule** deciding on
which calls the fault fires:

* ``always``            — every call (bounded by ``times``);
* ``nth`` (``n=k``)     — exactly the k-th call to that point (1-based);
* ``every`` (``n=k``)   — every k-th call;
* ``prob`` (``p``, ``seed``) — each call independently with probability
  ``p`` from a per-rule ``random.Random(seed)`` stream, so a plan is a
  pure function of (seed, call sequence): same traffic, same faults.

Plans round-trip through JSON (``to_json`` / ``from_json``) so the
``--fault-plan`` CLI flag can take them as artifacts.

The failure points, and where the port instruments them:

==================  ======================================================
``layout.build``    fused-delivery layout build in ``_prepared``
``execute``         ``CompiledAlgorithm`` run / run_batch, before the
                    replay (never during a capture; warmup never fires)
``serve.flush``     ``Frontend._attempt`` (before the batch executes)
``serve.worker``    the front-end worker loop (models a thread crash)
``checkpoint.chunk``after each superstep checkpoint chunk is saved
``disk.read``       ``DiskExecutableCache.load``, before a record file
                    is read (a fault quarantines the entry: a miss)
``disk.deserialize``the same, before the record is parsed and checked
``disk.write``      ``DiskExecutableCache.store``, before a record is
                    published (a fault leaves the signature unrecorded)
``compile.aot``     ``_DiskBackedExecutable``, under the signature's
                    lock, before the capture (raises on the card; the
                    CPU's eager build stands, unrecorded)
``replica.crash``   the replica's pipe loop, per received request
                    (``os._exit``: the kill -9 model)
``replica.hang``    the same, after ``replica.crash`` (stops the
                    heartbeats; the router's detector must catch it)
``router.route``    ``Router.submit``'s admission (the request resolves
                    with the typed error)
==================  ======================================================

Every point the JAX package instruments is named here, and each fires
in the port, so a plan written for it loads and fires unchanged.
Unknown points are legal in a plan (they simply never fire) so plans
stay forward-compatible; ``FaultPlan.validate`` warns on typos.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

FAULT_POINTS = (
    "disk.read",
    "disk.write",
    "disk.deserialize",
    "compile.aot",
    "layout.build",
    "execute",
    "serve.flush",
    "serve.worker",
    "checkpoint.chunk",
    "replica.crash",
    "replica.hang",
    "router.route",
)

_TRIGGERS = ("always", "nth", "every", "prob")
_ERRORS = ("transient", "fatal", "corrupt")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One scheduled failure: *where* (point), *when* (trigger), *what*
    (error kind — ``transient``/``fatal`` map onto the taxonomy's
    retryability split; ``corrupt`` raises ``CorruptCacheEntry``)."""

    point: str
    trigger: str = "always"        # always | nth | every | prob
    n: int | None = None           # for nth / every
    p: float | None = None         # for prob
    seed: int = 0                  # for prob
    times: int | None = None       # max total fires (None = unbounded)
    error: str = "transient"       # transient | fatal | corrupt

    def __post_init__(self):
        if self.trigger not in _TRIGGERS:
            raise ValueError(
                f"unknown trigger {self.trigger!r}; one of {_TRIGGERS}"
            )
        if self.trigger in ("nth", "every") and (
            self.n is None or self.n < 1
        ):
            raise ValueError(f"trigger {self.trigger!r} needs n >= 1")
        if self.trigger == "prob" and not (
            self.p is not None and 0.0 <= self.p <= 1.0
        ):
            raise ValueError("trigger 'prob' needs p in [0, 1]")
        if self.error not in _ERRORS:
            raise ValueError(
                f"unknown error kind {self.error!r}; one of {_ERRORS}"
            )

    def to_dict(self) -> dict:
        out = {"point": self.point, "trigger": self.trigger,
               "error": self.error}
        if self.n is not None:
            out["n"] = self.n
        if self.p is not None:
            out["p"] = self.p
        if self.seed:
            out["seed"] = self.seed
        if self.times is not None:
            out["times"] = self.times
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown FaultRule fields: {sorted(extra)}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered tuple of rules; the unit the CLI / tests commit."""

    rules: tuple[FaultRule, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    def for_point(self, point: str) -> tuple[FaultRule, ...]:
        return tuple(r for r in self.rules if r.point == point)

    def validate(self) -> list[str]:
        """Non-fatal lint: rule points nothing instruments today.  Each
        warning lists the valid inventory so a typo'd plan is fixable
        from the warning alone."""
        inventory = ", ".join(FAULT_POINTS)
        return [
            f"rule targets unknown point {r.point!r}; "
            f"instrumented points: {inventory}"
            for r in self.rules
            if r.point not in FAULT_POINTS
        ]

    # -- JSON round trip ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {"rules": [r.to_dict() for r in self.rules]}, indent=1
        )

    @classmethod
    def from_json(cls, obj: Any) -> "FaultPlan":
        """Accept a JSON string, a parsed dict, or a list of rule dicts."""
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)
        if isinstance(obj, dict):
            obj = obj.get("rules", [])
        if not isinstance(obj, (list, tuple)):
            raise ValueError(
                "fault plan must be {'rules': [...]} or a rule list"
            )
        return cls(rules=tuple(FaultRule.from_dict(dict(r)) for r in obj))
