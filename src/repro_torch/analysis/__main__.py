"""CLI: ``python -m repro_torch.analysis [--passes lint,digest,shapes,retrace]
[--device cpu|cuda]``.

Exit 0 when every finding is covered by the committed baseline
(``tools/torch_analysis_baseline.json``); exit 1 on any new finding.
Each finding prints as ``file:line: [rule] message`` with the rule's
one-line rationale underneath (``--no-explain`` drops it).

``--update-baseline`` rewrites the baseline from the current findings
— the sanctioned way to accept a new intentional finding (prefer an
inline ``# analysis: ignore[rule]`` where the intent is site-local).

``--device`` is where the live passes run (``shapes``' fused lowering,
``retrace``'s compiles): the card unless the caller asks for the CPU,
as every entry point of the port.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.findings import (
    Finding,
    diff_baseline,
    load_baseline,
    save_baseline,
    summarize,
)

PASSES = ("lint", "digest", "shapes", "retrace")


def _run_pass(name: str, root: Path, device: str) -> list[Finding]:
    if name == "lint":
        from repro_torch.analysis.lint import lint_tree

        return lint_tree(root / "src" / "repro_torch")
    if name == "digest":
        from repro_torch.analysis.digest import audit

        return audit()
    if name == "shapes":
        from repro_torch.analysis.shapes import shape_budget_audit

        return shape_budget_audit(device=device)
    if name == "retrace":
        from repro_torch.analysis.retrace import retrace_smoke

        return retrace_smoke(device=device)
    raise SystemExit(f"unknown pass: {name} (choose from {PASSES})")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument(
        "--passes", default="lint,digest,shapes",
        help=f"comma-separated subset of {PASSES} (retrace is live "
             "compilation: opt in)",
    )
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the live passes run (default: the card)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: inferred from this package)")
    ap.add_argument("--baseline", default="tools/torch_analysis_baseline.json")
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--no-explain", action="store_true",
                    help="drop the per-rule rationale lines")
    ap.add_argument("--show", default="finding",
                    help="classifications to print, comma-separated "
                         "(finding,guarded,cold-path,suppressed,all)")
    args = ap.parse_args(argv)

    root = Path(args.root) if args.root else _infer_root()
    passes = [p.strip() for p in args.passes.split(",") if p.strip()]

    findings: list[Finding] = []
    for name in passes:
        found = _run_pass(name, root, args.device)
        findings.extend(found)
        print(f"[{name}] {len(found)} result(s)")

    baseline_path = root / args.baseline
    if args.update_baseline:
        save_baseline(baseline_path, findings)
        print(f"baseline updated: {baseline_path} "
              f"({sum(1 for f in findings if f.classification == 'finding')}"
              " finding(s))")
        return 0

    show = {s.strip() for s in args.show.split(",")}
    explain = not args.no_explain
    for f in findings:
        if "all" in show or f.classification in show:
            print(f.format(explain=explain and f.classification
                           == "finding"))

    counts = summarize(findings)
    print("summary:", " ".join(
        f"{k}={v}" for k, v in sorted(counts["by_class"].items())
    ) or "clean")

    fresh, stale = diff_baseline(findings, load_baseline(baseline_path))
    if stale:
        print(f"note: {len(stale)} stale baseline key(s) — rerun with "
              "--update-baseline to tighten:")
        for k in stale:
            print(f"  {k}")
    if fresh:
        print(f"\n{len(fresh)} NEW finding(s) vs baseline "
              f"({baseline_path}):")
        for f in fresh:
            print(f.format(explain=explain))
        return 1
    print("OK: no new findings vs baseline")
    return 0


def _infer_root() -> Path:
    here = Path(__file__).resolve()
    for cand in here.parents:
        if (cand / ".git").exists() or (cand / "pyproject.toml").exists():
            return cand
    return Path.cwd()


if __name__ == "__main__":
    sys.exit(main())
