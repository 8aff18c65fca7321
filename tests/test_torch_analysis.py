"""The port's static analysis (``repro_torch.analysis``) checks the
checkers, on the CPU at a small size.

Where the port and the JAX package's ``repro.analysis`` share semantics
the two are held equal: the finding model and its baseline, suppression
coverage, the ``swallowed-error`` and ``tracer-gate`` rules on one
snippet, and the shape grid's output shape and dtype.  Where they do
not (the torch host-sync forms, ``capture-sync``, the card's shared
memory), the tests plant a violation and require the pass that owns it
to report its rule, as ``tests/test_analysis.py`` does for the
reference.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.analysis.findings as ref_findings
import repro.analysis.lint as ref_lint
from repro_torch.analysis import findings as port_findings
from repro_torch.analysis import lint as port_lint
from repro_torch.analysis import shapes
from repro_torch.analysis.findings import RULES, diff_baseline, load_baseline
from repro_torch.analysis.lint import HOT_PATHS, lint_file, lint_tree

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
BASELINE = ROOT / "tools" / "torch_analysis_baseline.json"


def _write(tmp_path, source, rel):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return path


def _lint_source(tmp_path, source, rel="pkg/mod.py"):
    return lint_file(_write(tmp_path, source, rel), root=tmp_path)


# --------------------------------------------------------------------------
# the finding model and its baseline, against the reference
# --------------------------------------------------------------------------

FINDING_SETS = {
    "mixed": [
        ("host-sync", "a.py", 3, "f", "m", "finding"),
        ("host-sync", "a.py", 9, "f", "m2", "finding"),
        ("host-sync", "a.py", 12, "f", "m3", "guarded"),
        ("swallowed-error", "b.py", 1, "g", "m4", "finding"),
        ("tracer-gate", "b.py", 7, "h", "m5", "suppressed"),
        ("retrace", "<retrace-smoke>", 0, "q", "m6", "finding"),
    ],
    "empty": [],
    "cold": [("host-sync", "c.py", 2, "<module>", "m", "cold-path")] * 3,
}
BASELINES = {
    "mixed": {"host-sync:a.py:f": 1, "retrace:gone.py:h": 1},
    "empty": {"host-sync:a.py:f": 2},
    "cold": {},
}


@pytest.mark.parametrize("case", sorted(FINDING_SETS))
def test_finding_model_and_baseline_equal_the_reference(case, tmp_path):
    mine = [port_findings.Finding(*f) for f in FINDING_SETS[case]]
    theirs = [ref_findings.Finding(*f) for f in FINDING_SETS[case]]
    assert [f.key for f in mine] == [f.key for f in theirs]
    assert [f.format(explain=False) for f in mine] == [
        f.format(explain=False) for f in theirs]
    assert [f.format() for f in mine] == [
        f.format(explain=False) + "\n    why: " + RULES[f.rule]
        for f in mine]
    assert (port_findings.summarize(mine)
            == ref_findings.summarize(theirs))
    assert (port_findings.baseline_counts(mine)
            == ref_findings.baseline_counts(theirs))
    base = BASELINES[case]
    fresh_m, stale_m = port_findings.diff_baseline(mine, base)
    fresh_t, stale_t = ref_findings.diff_baseline(theirs, base)
    assert [f.key for f in fresh_m] == [f.key for f in fresh_t]
    assert [f.message for f in fresh_m] == [f.message for f in fresh_t]
    assert stale_m == stale_t
    port_findings.save_baseline(tmp_path / "m.json", mine)
    ref_findings.save_baseline(tmp_path / "t.json", theirs)
    assert (tmp_path / "m.json").read_text() == (
        tmp_path / "t.json").read_text()
    assert (port_findings.load_baseline(tmp_path / "m.json")
            == ref_findings.load_baseline(tmp_path / "t.json"))
    assert port_findings.load_baseline(tmp_path / "none.json") == {}


SUPPRESSION_SNIPPETS = {
    "same-line": "a = f(x)  # analysis: ignore[host-sync]\nb = 2\n",
    "block-above": (
        "# analysis: ignore[host-sync] — rationale text here,\n"
        "# continuing onto a second comment line\n"
        "b = f(x)\nc = 3\n"),
    "all-rules": "x = 1  # analysis: ignore\n",
    "two-rules": "y = 2  # analysis: ignore[host-sync, capture-sync]\n",
    "wrong-rule": "z = f(x)  # analysis: ignore[traced-cond] wrong rule\n",
    "none": "w = 4\n",
}


@pytest.mark.parametrize("name", sorted(SUPPRESSION_SNIPPETS))
def test_suppression_coverage_equals_the_reference(name):
    src = SUPPRESSION_SNIPPETS[name]
    mine = port_lint._Suppressions(src)
    theirs = ref_lint._Suppressions(src)
    assert mine.by_line == theirs.by_line
    for line in range(1, src.count("\n") + 3):
        for rule in ("host-sync", "capture-sync", "traced-cond"):
            assert mine.covers(line, rule) == theirs.covers(line, rule)


SHARED_RULE_SNIPPET = """
    class Frontend:
        def _run_flush(self, flush, tracer=None):
            with tracer.span("serve.flush"):
                pass
            try:
                work()
            except Exception:
                pass
            try:
                work()
            except Exception as err:
                flush.future.set_exception(err)

        def boot(self):
            try:
                work()
            except:
                pass
"""


def test_swallowed_error_and_tracer_gate_equal_the_reference(tmp_path):
    """One snippet at a path both inventories call hot gives the same
    ``(rule, line, scope, classification)`` from both linters."""
    path = _write(tmp_path, SHARED_RULE_SNIPPET, "serve/frontend.py")
    rules = ("swallowed-error", "tracer-gate")

    def key(found):
        return sorted((f.rule, f.line, f.scope, f.classification)
                      for f in found if f.rule in rules)

    mine = key(lint_file(path, root=tmp_path))
    theirs = key(ref_lint.lint_file(path, root=tmp_path))
    assert mine == theirs
    assert ("tracer-gate", 4, "Frontend._run_flush", "finding") in mine
    assert ("swallowed-error", 8, "Frontend._run_flush", "finding") in mine
    assert ("swallowed-error", 18, "Frontend.boot", "cold-path") in mine


def test_shape_grid_equals_the_reference_eval_shape():
    """Every point's output (shape, dtype) from the port's lowerings is
    the reference's ``jax.eval_shape`` result."""
    import jax

    from repro.analysis.shapes import _build_layouts as ref_layouts
    from repro.kernels.deliver import _pallas_leaf as ref_pallas_leaf
    from repro.sparse.segment import MONOIDS as REF_MONOIDS

    ref = {}
    for lname, layout in ref_layouts():
        for mname, dtypes in shapes.SHAPE_DTYPES.items():
            for d in (1, 8):
                for dt in dtypes:
                    out = jax.eval_shape(
                        lambda m, layout=layout, mname=mname:
                        ref_pallas_leaf(m, layout, REF_MONOIDS[mname], None,
                                        interpret=True),
                        jax.ShapeDtypeStruct((int(layout.n_src), d),
                                             np.dtype(dt)))
                    ref[f"{lname}/{mname}/D={d}/{dt}"] = (
                        tuple(out.shape), np.dtype(out.dtype).name)
    grid = shapes.shape_grid("cpu")
    assert len(grid) == len(ref) == 28
    for point, xla, fused in grid:
        for shape, dtype in (xla, fused):
            assert (shape, str(dtype).removeprefix("torch.")) == ref[point]


# --------------------------------------------------------------------------
# the port's own rules
# --------------------------------------------------------------------------

SYNC_FORMS = {
    "item": "y = x.item()",
    "tolist": "y = x.tolist()",
    "cpu": "y = x.cpu()",
    "numpy": "y = x.numpy()",
    "int": "y = int(x)",
    "float": "y = float(x)",
    "bool": "y = bool(x)",
    "cuda-synchronize": "torch.cuda.synchronize()",
    "event-synchronize": "ev.synchronize()",
    "np-asarray": "y = np.asarray(x)",
    "np-array": "y = np.array(x)",
    "torch-equal": "y = torch.equal(x, x)",
    "torch-any-as-bool": "if torch.any(x): pass",
    "any-as-bool": "if not (x > 0).any(): pass",
}


@pytest.mark.parametrize("form", sorted(SYNC_FORMS))
def test_host_sync_form_is_hot_guarded_and_cold(form, tmp_path):
    line = SYNC_FORMS[form]
    found = _lint_source(tmp_path, f"""
        import numpy as np
        import torch

        def deliver(x, ev, tracer=None):
            {line}
            if tracer is not None:
                {line}

        def build_layout(x, ev):
            {line}
    """, rel="core/engine.py")
    got = sorted((f.scope, f.classification) for f in found
                 if f.rule == "host-sync")
    assert got == [("build_layout", "cold-path"), ("deliver", "finding"),
                   ("deliver", "guarded")]


def test_host_sync_skips_static_casts(tmp_path):
    found = _lint_source(tmp_path, """
        import torch

        def deliver(x, n: int, m: int | None = None):
            a = int(x.shape[0])
            b = int(len(x))
            c = int(x.numel())
            d = float(x.size(1))
            e = int(n)
            rows = x.shape[0]
            f = int(rows)
            for i in range(3):
                g = int(i)
            return int(3)
    """, rel="core/engine.py")
    assert [f for f in found if f.rule == "host-sync"] == []


def test_host_sync_early_tracer_return_guards_rest_of_function(tmp_path):
    found = _lint_source(tmp_path, """
        def _block(value, tracer):
            if tracer is None:
                return value
            return value.cpu()    # only runs traced: guarded
    """, rel="serve/frontend.py")
    assert [f.classification for f in found if f.rule == "host-sync"] == [
        "guarded"]


def _copy_capture_tree(tmp_path, plant=None):
    """``core/serving.py`` (the capture) and ``core/engine.py`` (the pair
    it captures) under ``tmp_path``, ``plant(engine_source)`` applied."""
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "core").mkdir(parents=True)
    (tmp_path / "pyproject.toml").write_text("")
    shutil.copy(PKG / "core" / "serving.py", pkg / "core" / "serving.py")
    src = (PKG / "core" / "engine.py").read_text()
    (pkg / "core" / "engine.py").write_text(plant(src) if plant else src)
    return pkg


PAIR_ANCHOR = '    step = state["step"]\n    halted = state.get("halted")\n'


@pytest.mark.parametrize("plant, kind", [
    ("    _ = step.item()\n", ".item()"),
    ("    if step > 0:\n        pass\n", "`if` on a tensor"),
    ("    if torch.any(step > 0):\n        pass\n", "torch.any() as a bool"),
], ids=["item", "tensor-branch", "any-as-bool"])
def test_capture_sync_flags_a_host_read_in_the_captured_pair(
        tmp_path, plant, kind):
    """The static form of the card test of a host read of the step: a
    read planted in ``pair_in_place`` is reached from the capture in
    ``_Executable.capture`` (another module) and flagged."""
    def planted(src):
        assert PAIR_ANCHOR in src
        return src.replace(PAIR_ANCHOR, PAIR_ANCHOR + plant)

    found = lint_tree(_copy_capture_tree(tmp_path, planted))
    hits = [f for f in found if f.rule == "capture-sync"
            and f.classification == "finding"]
    assert [(f.scope, f.path.endswith("core/engine.py")) for f in hits] == [
        ("pair_in_place", True)]
    assert kind in hits[0].message
    assert "_Executable.capture -> _Executable.pair -> pair_in_place" in (
        hits[0].message)


def test_capture_sync_quiet_on_the_clean_pair_and_uncaptured_reads(tmp_path):
    def planted(src):
        # a host read in a function no capture reaches
        return src + "\n\ndef _report(x):\n    return x.item()\n"

    found = lint_tree(_copy_capture_tree(tmp_path, planted))
    assert [f for f in found if f.rule == "capture-sync"] == []


def test_capture_walk_reaches_the_whole_captured_pair():
    """The real tree: the capture in ``_Executable.capture`` reaches the
    local and distributed pairs, the fused delivery down to K1's launch,
    and stops at the leaf plan (built before any capture)."""
    reach = port_lint.capture_reach(PKG)
    ((where, funcs),) = reach.items()
    assert where.startswith("src/repro_torch/core/serving.py:")
    for name in ("repro_torch.core.engine:pair_in_place",
                 "repro_torch.core.engine:_pair",
                 "repro_torch.core.distributed:DistContext.count",
                 "repro_torch.core.distributed:_superstep_sharded.send",
                 "repro_torch.core.distributed:_cross_combine.one",
                 "repro_torch.kernels.deliver:fused_deliver.one",
                 "repro_torch.kernels.deliver.fused:_launch"):
        assert name in funcs
    assert "repro_torch.kernels.deliver.fused:_build_leaf_plan" not in funcs


def test_tracer_gate_requires_none_branch(tmp_path):
    found = _lint_source(tmp_path, """
        def bad(x, tracer=None):
            with tracer.span("a"):
                return x

        def good(x, tracer=None):
            if tracer is None:
                return x
            with tracer.span("a"):
                return x

        def also_good(x, tracer=None):
            from repro_torch.obs import maybe_span
            with maybe_span(tracer, "a"):
                return x
    """)
    assert [f.scope for f in found if f.rule == "tracer-gate"] == ["bad"]


def _qualnames(path: Path) -> set[str]:
    out = set()

    def walk(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out.add(prefix + node.name)
                walk(node.body, prefix + node.name + ".")

    walk(ast.parse(path.read_text()).body, "")
    return out


@pytest.mark.parametrize("suffix", sorted(HOT_PATHS))
def test_hot_path_inventory_names_functions_that_exist(suffix):
    names = _qualnames(PKG / suffix)
    missing = [q for q in HOT_PATHS[suffix] if q not in names]
    assert missing == []


def test_repo_lint_is_clean_against_the_port_baseline():
    found = lint_tree(PKG)
    baseline = load_baseline(BASELINE)
    assert baseline == {}
    fresh, stale = diff_baseline(found, baseline)
    assert fresh == [], [f.format(explain=False) for f in fresh]
    assert stale == []
    sync = [f for f in found if f.rule == "host-sync"]
    assert len(sync) > 100
    assert {f.classification for f in sync} <= {
        "cold-path", "guarded", "suppressed"}
    # the by-design syncs are acknowledged inline, each with its reason
    suppressed = {(f.path.split("repro_torch/")[-1], f.scope)
                  for f in found if f.classification == "suppressed"}
    for site in (("core/engine.py", "halting_loop"),
                 ("serve/replica.py", "_to_host"),
                 ("serve/frontend.py", "_block"),
                 ("core/serving.py", "CompiledAlgorithm._execute")):
        assert site in suppressed


@pytest.mark.parametrize("rule", [
    "host-sync", "capture-sync", "tracer-gate", "swallowed-error",
    "retrace", "digest-unstable", "digest-collision", "digest-identity",
    "shape-mismatch", "smem-budget"])
def test_rules_cover_every_ported_rule(rule):
    assert rule in RULES and RULES[rule]


@pytest.mark.parametrize("rule", ["traced-cond", "static-arg-array",
                                  "vmem-budget"])
def test_tpu_and_jit_rules_are_deliberately_absent(rule):
    """Eager torch has no traced branch and nothing jitted with static
    arguments, and the card has no VMEM: ``capture-sync`` and
    ``smem-budget`` take their places."""
    assert rule in ref_findings.RULES
    assert rule not in RULES


def test_no_port_module_imports_jax_or_the_reference():
    bad = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(PKG)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


# --------------------------------------------------------------------------
# digest audit
# --------------------------------------------------------------------------

def test_digest_audit_clean_in_process():
    from repro_torch.analysis.digest import audit, build_grid

    assert audit(cross_process=False) == []
    names = [name for name, _ in build_grid()]
    assert len(names) == len(set(names)) > 40
    for part in ("pagerank/", "sssp/", "labelprop/", "/b=8",
                 "delivery=pallas_fused", "query=int32", "eattr=",
                 "n_parts=2", "shard_len_pad=128", "sharded/"):
        assert any(part in n for n in names), part


def test_digest_audit_catches_injected_collision():
    from repro_torch.analysis.digest import audit

    found = audit(digest_fn=lambda key: "constant", cross_process=False)
    assert found and all(f.rule == "digest-collision" for f in found)


def test_digest_audit_catches_identity_leak():
    from repro_torch.analysis.digest import audit
    from repro_torch.serve.cache import stable_digest

    # id() varies between the two in-process grid builds: the exact
    # failure mode of hashing an object by repr/address
    found = audit(digest_fn=lambda key: stable_digest((id(key),)),
                  cross_process=False)
    assert any(f.rule == "digest-identity" for f in found)


@pytest.mark.slow
def test_digest_stable_across_process_boundary():
    """The cross-process half, against a real child interpreter with
    randomized hashing."""
    from repro_torch.analysis.digest import grid_digests

    here = grid_digests()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "PYTHONHASHSEED": "random"}
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; from repro_torch.analysis.digest import "
         "grid_digests; json.dump(grid_digests(), sys.stdout)"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-500:]
    assert json.loads(out.stdout) == here


# --------------------------------------------------------------------------
# shape agreement and the shared-memory budgets
# --------------------------------------------------------------------------

def test_shape_agreement_clean_on_the_cpu():
    assert shapes.check_shapes("cpu") == []


def test_shape_audit_catches_injected_lowering_disagreement():
    from repro_torch.kernels.deliver import _pallas_leaf

    def wrong_dtype(m, layout, monoid, active):
        out = _pallas_leaf(m, layout, monoid, active, lowering="plain")
        return out.to(torch.int8)          # dtype drift

    def wrong_shape(m, layout, monoid, active):
        out = _pallas_leaf(m, layout, monoid, active, lowering="plain")
        return out[:-1]                    # drops a destination row

    for leaf in (wrong_dtype, wrong_shape):
        found = shapes.check_shapes("cpu", fused_leaf=leaf, widths=(1,),
                                    monoids=("min",))
        assert found and all(f.rule == "shape-mismatch" for f in found)


def test_budget_model_is_clean_and_covers_six_kernels():
    rows = shapes.instantiations()
    assert {r.kernel for r in rows} == {"K1", "K2a", "K2b", "K3a", "K3b",
                                        "K4"}
    assert shapes.check_budgets(rows) == []
    assert shapes.check_mirrors() == []
    assert shapes.check_static_arrays() == []
    assert shapes.check_width_gate() == []
    assert shapes.shape_budget_audit(device="cpu") == []
    by = {(r.kernel, r.entry, r.opt_in): r for r in rows}
    # K1 and K2a never opt in, K4 always does.
    assert all(not r.opt_in for r in rows if r.kernel in ("K1", "K2a"))
    assert all(r.opt_in for r in rows if r.kernel == "K4")
    k1 = by[("K1", "deliver_fused_kernel<float, 0, 1, 0>", False)]
    assert k1.dynamic == (4096 + 1) * 8 + 2048 * 4
    assert by[("K4", "flash_wgmma_kernel<256, 64, 1>", True)].dynamic == (
        2 * 256 * (128 + 2 * 2 * 64) + 64 + 1024)


def test_budget_model_counts_both_backward_routes():
    """K4's backward: the tensor-core kernels at DP 64 and 128 beside the
    FMA tiles of both types, their plan's tiles mirrored from the
    source's constants."""
    rows = {r.entry: r for r in shapes.instantiations()
            if r.source == "flash_bwd.cu"}
    for entry, dynamic in (("flash_bwd_dkdv_wgmma<64>", 84_544),
                           ("flash_bwd_dq_wgmma<64>", 83_008),
                           ("flash_bwd_dkdv_wgmma<128>", 166_464),
                           ("flash_bwd_dq_wgmma<128>", 164_928)):
        assert (rows[entry].dynamic, rows[entry].static) == (dynamic, 0)
        assert rows[entry].opt_in
    assert {"flash_bwd_dkdv<float, 4, 8>", "flash_bwd_dq<float, 2, 16>",
            "flash_bwd_dkdv<__nv_bfloat16, 4, 1>",
            "flash_bwd_dq<__nv_bfloat16, 2, 16>"} <= set(rows)
    consts = {**shapes.source_constants("flash_bwd.cu"), "tc::kCols": 32}
    found = shapes.check_mirrors(constants={"flash_bwd.cu": consts})
    assert [f.scope for f in found] == ["flash_bwd_plan wgmma block_cols"]
    assert shapes.parse_entry(
        "_ZN45_GLOBAL__N__b7f7edad_12_flash_bwd_cu_5acdb5282tc20flash_bwd_"
        "dkdv_wgmmaILi64EEEvPKfS3_P13__nv_bfloat16S5_iiiiiiffi14CUtensorMap_"
        "stS6_S6_S6_") == ("flash_bwd_dkdv_wgmma", ("64",))


def test_source_constants_read_namespaces_and_expressions():
    c = shapes.source_constants("flash.cu")
    assert (c["f32::kBQ"], c["tc::kBQ"], c["tc::kStages"]) == (64, 128, 2)
    s = shapes.source_constants("segsum.cu")
    assert s["kK2bWarps"] == s["kK2bThreads"] // 32
    assert s["kBinIds"] == s["kBinThreads"] * s["kIdsPer"]
    text = "namespace {\nconstexpr int kA = 3;\nconstexpr int kB = kA << 2;"
    assert shapes.source_constants("x.cu", text + "\n}  // namespace\n") == {
        "kA": 3, "kB": 12}


@pytest.mark.parametrize("constant, value", [
    ("kMaxSpan", 2048), ("kThreads", 128)])
def test_budget_catches_a_planted_k1_constant_mismatch(constant, value):
    consts = {**shapes.source_constants("deliver_fused.cu"), constant: value}
    found = shapes.check_mirrors(constants={"deliver_fused.cu": consts})
    assert [f.rule for f in found] == ["smem-budget"]
    assert "Python mirror" in found[0].message


def test_budget_catches_a_planted_segsum_constant_mismatch():
    consts = {**shapes.source_constants("segsum.cu"), "kFan": 4,
              "kLgFan": 3}
    found = shapes.check_mirrors(constants={"segsum.cu": consts})
    assert sorted(f.scope for f in found) == ["segsum.K2A_FAN_IN",
                                              "segsum.K2B_FAN_IN"]


def test_budget_catches_a_planted_over_budget_plan(monkeypatch):
    over = shapes.LaunchBudget("K1", "deliver_fused_kernel<float, 0, 1, 0>",
                               "deliver_fused.cu", 16, 49_152, False, "x")
    found = shapes.check_budgets([over])
    assert [f.rule for f in found] == ["smem-budget"]
    assert "no cudaFuncSetAttribute" in found[0].message
    from repro_torch.kernels.flash import flash

    real = flash.flash_plan

    def wide_plan(d, dtype):
        plan = real(d, dtype)
        return plan._replace(smem_bytes=plan.smem_bytes + 40_000)

    monkeypatch.setattr(flash, "flash_plan", wide_plan)
    found = shapes.check_budgets()
    assert found and {f.scope.split()[0] for f in found} == {"K4"}


def test_budget_catches_an_unmodeled_shared_array():
    text = shapes._read("isect.cu").replace(
        "extern __shared__ int4 smem[];",
        "extern __shared__ int4 smem[];\n  __shared__ int spill[64];", 1)
    found = shapes.check_static_arrays({"isect.cu": text})
    assert [(f.rule, f.scope) for f in found] == [
        ("smem-budget", "isect_stream")]


def test_width_gate_catches_a_wider_auto_gate():
    assert shapes.check_width_gate(width_budget_bytes=4096.0) != []


@pytest.mark.parametrize("targs", sorted(shapes.K2B_CASES),
                         ids=lambda t: "-".join(t))
def test_k2b_geometry_fits_the_card_beside_its_static_arrays(targs):
    """The largest K2b geometry the wrapper admits, for every (dtype, d,
    aligned) of each template, plus that template's static arrays, fits
    the 227 KB a block may opt into.  Failed before the reserve was
    taken from the arrays: bfloat16 D = 8 (``s_wval`` 8 KB) needed 48
    bytes more than the 9 KB reserved."""
    from repro_torch.kernels.segsum.segsum import k2b_geometry

    static = shapes.static_bytes("segsum.cu", "k2b_kernel", targs)
    for itemsize, d, aligned in shapes.K2B_CASES[targs]:
        for n, e in ((1 << 20, 1 << 30), (1, 1)):
            def geo(be):
                return k2b_geometry(e, n, d, itemsize, be, aligned)
            be = shapes._largest_admitted(geo)
            assert be > 0
            assert geo(be).smem_bytes + static <= shapes.OPTIN_BYTES
            assert geo(be).vec == int(targs[1]) or geo(be).narrow


def test_k2b_old_reserve_admits_a_launch_the_card_refuses(monkeypatch):
    from repro_torch.kernels.segsum import segsum

    monkeypatch.setattr(segsum, "K2B_SMEM_LIMIT", 232448 - 9 * 1024)
    segsum.k2b_geometry.cache_clear()
    try:
        found = shapes.check_budgets()
    finally:
        monkeypatch.undo()
        segsum.k2b_geometry.cache_clear()
    assert [f.scope for f in found] == [
        "K2b k2b_kernel<__nv_bfloat16, 8, false>"]


def test_ptxas_log_parser_and_check():
    log = textwrap.dedent("""\
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110k2b_kernelI13__nv_bfloat16Li8ELb0EEEvPKT_PKiPS2_PiPfiiiii' for 'sm_90a'
        ptxas info    : Function properties for _ZN12_GLOBAL__N_110k2b_kernelI13__nv_bfloat16Li8ELb0EEEvPKT_PKiPS2_PiPfiiiii
            14 bytes stack frame, 14 bytes spill stores, 28 bytes spill loads
        ptxas info    : Used 64 registers, 9264 bytes smem, 420 bytes cmem[0]
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19k2a_countEPKixiiiPi' for 'sm_90a'
        ptxas info    : Used 34 registers, used 1 barriers, 32768 bytes smem
        ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_13f3212flash_kernelIfLi4EEEvPKT_S4_S4_PS2_iiiifii' for 'sm_90a'
        ptxas info    : Used 80 registers, 400 bytes cmem[0]
    """)
    got = shapes.ptxas_static_smem(log)
    assert got == {"k2b_kernel<__nv_bfloat16, 8, false>": 9264,
                   "k2a_count": 32768, "flash_kernel<float, 4>": 0}
    assert shapes.parse_entry(
        "_ZN12_GLOBAL__N_112isect_cachedILi2E4int4Li1EEEvPKiS3_S3_S3_S3_Pixl"
    ) == ("isect_cached", ("2", "int4", "1"))
    # a partial log: the entries it lacks are findings, the ones it has
    # agree with the model
    found = shapes.check_ptxas({"segsum.cu": log})
    scopes = {f.scope for f in found}
    assert "k2a_count" not in scopes
    assert "k2b_kernel<__nv_bfloat16, 8, false>" not in scopes
    assert "k2a_plan" in scopes
    bad = log.replace("9264 bytes smem", "9216 bytes smem")
    assert "k2b_kernel<__nv_bfloat16, 8, false>" in {
        f.scope for f in shapes.check_ptxas({"segsum.cu": bad})}


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_cli_exits_clean_on_the_tree(capsys):
    from repro_torch.analysis.__main__ import main

    rc = main(["--passes", "lint,shapes", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "OK: no new findings vs baseline" in out


def test_cli_reports_new_finding_with_rationale(tmp_path, capsys):
    """A repo-shaped tree with a planted hot-path read exits 1 and
    prints the ``file:line: [rule]`` + rationale format."""
    from repro_torch.analysis.__main__ import main

    _write(tmp_path, """
        def _stack(queries):
            return [q.item() for q in queries]
    """, "src/repro_torch/serve/frontend.py")
    (tmp_path / "pyproject.toml").write_text("")
    rc = main(["--passes", "lint", "--device", "cpu", "--root",
               str(tmp_path), "--baseline", "baseline.json"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "src/repro_torch/serve/frontend.py:3: [host-sync]" in out
    assert "why: " + RULES["host-sync"][:40] in out
    # accepted into the baseline, the same tree exits 0
    assert main(["--passes", "lint", "--device", "cpu", "--root",
                 str(tmp_path), "--baseline", "baseline.json",
                 "--update-baseline"]) == 0
    assert main(["--passes", "lint", "--device", "cpu", "--root",
                 str(tmp_path), "--baseline", "baseline.json"]) == 0
