"""The finding model shared by every ``repro_torch.analysis`` pass (the
port's own copy of the JAX package's ``repro.analysis.findings``).

A **finding** is one violated invariant, anchored to a source location
when the pass is static (the AST lints) or to a synthetic location when
it is semantic (the digest audit, the shape and shared-memory budget
checks, the retrace smoke).  Every finding carries:

* a **rule id** (one of ``RULES``) — the invariant class;
* a one-line **message** — why THIS site violates it;
* a **classification** — ``finding`` (actionable), ``guarded`` (inside
  a ``tracer`` guard, by design), ``cold-path`` (outside the serve /
  superstep hot paths), or ``suppressed`` (an inline
  ``# analysis: ignore[rule]`` acknowledged it).

Only ``finding``-classified results count against the committed
baseline (``tools/torch_analysis_baseline.json``); the rest are
reported as summary counts so the hot-path host-sync inventory stays
visible.

Baseline keys are line-independent (``rule:path:scope``) so unrelated
edits shifting line numbers never invalidate the baseline; a scope
gaining MORE findings of a rule than the baseline records still fails.

The JAX package's ``traced-cond``, ``static-arg-array`` and
``vmem-budget`` have no counterpart here: eager torch has no traced
branch and nothing jitted with static arguments, and the card has no
VMEM.  ``capture-sync`` and ``smem-budget`` take their places.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from pathlib import Path

# rule id -> the one-line rationale the CLI prints next to every finding.
RULES = {
    "host-sync": (
        "host read of a tensor (`.item()`, `.tolist()`, `.cpu()`, "
        "`.numpy()`, `int()`/`float()`/`bool()`, `np.asarray`, "
        "`torch.equal`, a synchronize) on a serve/superstep hot path "
        "outside a tracer guard stalls dispatch on every request"
    ),
    "capture-sync": (
        "a host read, or a Python branch on a tensor, inside a region "
        "captured by `torch.cuda.graph` fails the capture or records "
        "one value for every replay: keep the step and the counts on "
        "the device (`torch.where`, in-place updates)"
    ),
    "tracer-gate": (
        "function takes a tracer but spans unconditionally: the "
        "zero-overhead-when-absent contract needs a `tracer is None` "
        "fast path (or `maybe_span`)"
    ),
    "swallowed-error": (
        "a bare/broad `except` on a serve or superstep hot path "
        "discards the error: route it through the faults taxonomy "
        "(re-raise, forward the bound exception, or resolve a future "
        "with it) or annotate the intentional swallow"
    ),
    "retrace": (
        "a warm-path serve recompiled: the compile-once contract "
        "(same bucket + same design point = one executable) is broken"
    ),
    "digest-unstable": (
        "stable_digest of this signature differs across processes: the "
        "disk store's records would never be found on replica boot"
    ),
    "digest-collision": (
        "two semantically distinct signatures share one stable_digest: "
        "the disk store would hand one signature's record to another "
        "(cache poisoning)"
    ),
    "digest-identity": (
        "rebuilding the same spec changed its stable_digest: object "
        "identity leaked into the digest, so a new process never hits"
    ),
    "shape-mismatch": (
        "the two delivery lowerings (xla, fused) disagree on output "
        "shape/dtype for this layout/monoid: the delivery axis is not "
        "a pure design choice anymore"
    ),
    "smem-budget": (
        "a kernel's shared memory (static + dynamic at its worst "
        "admitted geometry) exceeds what the card gives a block, or a "
        "Python mirror of a source constant drifted: the launch fails "
        "on the card only"
    ),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str                    # repo-relative, or "<pass>" for semantic
    line: int                    # 1-based; 0 for semantic findings
    scope: str                   # enclosing qualname ("<module>" at top)
    message: str                 # one-line site-specific rationale
    classification: str = "finding"

    @property
    def key(self) -> str:
        """Line-independent baseline key."""
        return f"{self.rule}:{self.path}:{self.scope}"

    def format(self, explain: bool = True) -> str:
        """``file:line: [rule] message`` — clickable in a terminal."""
        loc = f"{self.path}:{self.line}" if self.line else self.path
        head = f"{loc}: [{self.rule}] {self.message}"
        if explain and self.rule in RULES:
            head += f"\n    why: {RULES[self.rule]}"
        return head


def summarize(findings: list[Finding]) -> dict:
    """Per-rule / per-classification counts for the CLI summary."""
    by_rule: Counter = Counter()
    by_class: Counter = Counter()
    for f in findings:
        by_rule[f"{f.rule}:{f.classification}"] += 1
        by_class[f.classification] += 1
    return {"by_rule": dict(by_rule), "by_class": dict(by_class)}


# --------------------------------------------------------------------------
# baseline: pre-existing findings that don't block CI
# --------------------------------------------------------------------------

def baseline_counts(findings: list[Finding]) -> dict[str, int]:
    counts: Counter = Counter()
    for f in findings:
        if f.classification == "finding":
            counts[f.key] += 1
    return dict(sorted(counts.items()))


def load_baseline(path: str | Path) -> dict[str, int]:
    p = Path(path)
    if not p.exists():
        return {}
    doc = json.loads(p.read_text())
    return {str(k): int(v) for k, v in doc.get("findings", {}).items()}


def save_baseline(path: str | Path, findings: list[Finding]) -> None:
    Path(path).write_text(json.dumps(
        {"version": 1, "findings": baseline_counts(findings)}, indent=2,
    ) + "\n")


def diff_baseline(
    findings: list[Finding], baseline: dict[str, int]
) -> tuple[list[Finding], list[str]]:
    """(new findings not covered by the baseline, stale baseline keys).

    A key's findings are covered up to the baselined COUNT — a scope
    gaining more violations of a rule than the baseline records
    resurfaces the excess (newest-last within the scope).
    """
    budget = dict(baseline)
    fresh: list[Finding] = []
    for f in findings:
        if f.classification != "finding":
            continue
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
        else:
            fresh.append(f)
    seen = {f.key for f in findings if f.classification == "finding"}
    stale = sorted(k for k, n in baseline.items()
                   if k not in seen or budget.get(k, 0) > 0)
    return fresh, stale
