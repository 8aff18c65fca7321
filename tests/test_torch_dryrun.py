"""``python -m repro_torch.launch.dryrun``, the port's dry-run CLI, with
the JAX package's smoke call (``tests/test_dryrun_smoke.py``): 3 cells x
2 meshes traced on fake tensors over a fake world of 512 ranks, the same
6 ``[ok`` labels as the reference's cells (reckoned from
``repro.configs``: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import
and is not imported here), no JAX in the child, the roofline columns
and ``--out``, and exit 1 when a cell fails.  The dense LM's rows
(llama3.2-1b, gemma3-12b, command-r-plus-104b) are partitioned: one
device's own program, its temp and its collectives, and so are the MoE
LM's (qwen3-moe-235b-a22b, llama4-maverick-400b-a17b), BERT4Rec's and
the GNN ``pjit`` rows (gat-cora, PNA, NequIP, MACE).  Every call runs
in a subprocess (the fake world is a process group)."""
import json
import os
import subprocess
import sys

from repro import configs as ref_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("llama3.2-1b", "gat-cora", "bert4rec")
SHAPES = ("train_4k", "molecule", "serve_p99")
SMOKE_ARGS = [a for arch in ARCHS for a in ("--arch", arch)] + [
    a for shape in SHAPES for a in ("--shape", shape)]


def _run(args, timeout=300):
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True,
        timeout=timeout, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})


def _labels(stdout, status="ok"):
    return [ln[10:].split()[0] for ln in stdout.splitlines()
            if ln.startswith(f"[{status}")]


def _reference_labels():
    out = []
    for arch in ARCHS:
        spec = ref_configs.get_config(arch, smoke=True)
        for shape, s in spec.shapes.items():
            if shape in SHAPES and not s.skip:
                out += [f"{arch}:{shape}@{m}" for m in ("single", "multi")]
    return out


def test_dryrun_smoke_single_and_multi_without_jax():
    # -X importtime lists every module the child imports, on stderr.
    proc = _run(["-X", "importtime", "-m", "repro_torch.launch.dryrun",
                 *SMOKE_ARGS, "--mesh", "both", "--smoke", "--no-roofline"])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert _labels(proc.stdout) == _reference_labels()
    assert len(_labels(proc.stdout)) == 6
    modules = {ln.rsplit("|", 1)[-1].strip() for ln in
               proc.stderr.splitlines() if ln.startswith("import time:")}
    assert {"repro_torch.launch.tasks",
            "repro_torch.roofline.analysis"} <= modules
    assert not {m for m in modules if m.split(".")[0] in ("jax", "repro")}
    for ln in proc.stdout.splitlines():
        if ln.startswith("[ok"):
            assert "compile=" in ln and "args=" in ln
            # every row is partitioned: it knows its temp
            assert "temp=n/a" not in ln, ln
            assert "dom=" not in ln


def test_dryrun_roofline_and_out(tmp_path):
    out = tmp_path / "rows" / "dryrun.json"
    proc = _run(["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b",
                 "--arch", "gat-cora", "--shape", "train_4k", "--shape",
                 "molecule", "--mesh", "both", "--smoke", "--out", str(out)])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[ok")]
    assert len(lines) == 4
    for ln in lines:
        assert ("dom=" in ln and "frac=" in ln) == ("@single" in ln), ln
    rows = json.loads(out.read_text())
    assert [f"{r['cell']}@{r['mesh']}" for r in rows] == [
        ln[10:].split()[0] for ln in lines]
    keys = {"cell", "mesh", "status", "devices", "partitioned", "lower_s",
            "compile_s", "memory", "cost_flops_per_dev",
            "cost_bytes_per_dev", "collective_counts",
            "collective_bytes_per_dev_static", "notes"}
    for r in rows:
        assert keys <= set(r), r
        assert r["status"] == "ok"
        assert r["devices"] == (256 if r["mesh"] == "single" else 512)
        assert r["cost_flops_per_dev"] > 0 and r["memory"]["argument_gb"] > 0
        # the dense LM's train step and gat-cora's molecule batch alike
        _hold_partitioned_row(r)
        if r["mesh"] == "single":
            roof = r["roofline"]
            assert roof["partitioned"] is True
            assert roof["coll_bytes_dev"] is not None
            assert roof["dominant"] in ("compute", "memory", "collective")
            assert roof["hlo_flops"] == r["cost_flops_per_dev"] * 256
            assert 0 < roof["roofline_fraction"] <= 1
        else:
            assert "roofline" not in r


def _hold_partitioned_row(r, collectives=True):
    """A partitioned row: one device's own program, its temp, collectives
    of the JAX partitioner's kinds only (none where ``collectives`` is
    false), and no global-trace note."""
    assert r["partitioned"] is True
    assert r["memory"]["temp_gb"] is not None and r["memory"]["temp_gb"] > 0
    counts = r["collective_counts"]
    assert counts is not None
    if not collectives:
        assert sum(counts.values()) == 0
        assert r["collective_bytes_per_dev_static"] == 0
        assert "not partitioned" not in r["notes"]
        return
    assert sum(counts.values()) > 0
    assert {k for k, n in counts.items() if n} <= {
        "all-reduce", "all-gather", "reduce-scatter"}
    assert r["collective_bytes_per_dev_static"] > 0
    assert "not partitioned" not in r["notes"]


def test_dryrun_dense_lm_rows_are_partitioned(tmp_path):
    """The three dense LMs' serving cells on both meshes (their train
    cells: ``test_torch_tasks.py`` and ``test_torch_roofline.py``)."""
    out = tmp_path / "dense.json"
    proc = _run(["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b",
                 "--arch", "gemma3-12b", "--arch", "command-r-plus-104b",
                 "--shape", "prefill_32k", "--shape", "decode_32k",
                 "--shape", "long_500k", "--mesh", "both", "--smoke",
                 "--no-roofline", "--out", str(out)])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    rows = [r for r in json.loads(out.read_text()) if r["status"] == "ok"]
    # long_500k runs on gemma3-12b only (the others skip it at smoke)
    assert len(rows) == 2 * (3 * 2 + 1)
    for r in rows:
        _hold_partitioned_row(r)


def test_dryrun_moe_lm_rows_are_partitioned(tmp_path):
    """Every MoE LM cell on both meshes: one device's own program, with
    its temp and its collectives."""
    out = tmp_path / "moe.json"
    proc = _run(["-m", "repro_torch.launch.dryrun", "--arch",
                 "qwen3-moe-235b-a22b", "--arch",
                 "llama4-maverick-400b-a17b", "--mesh", "both", "--smoke",
                 "--no-roofline", "--out", str(out)])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    rows = [r for r in json.loads(out.read_text()) if r["status"] == "ok"]
    # long_500k runs on llama4-maverick only (qwen3-moe skips it)
    assert len(rows) == 2 * (3 + 4)
    for r in rows:
        _hold_partitioned_row(r)


def test_dryrun_bert4rec_rows_are_partitioned(tmp_path):
    """BERT4Rec's four cells at full size on both meshes: one device's
    own program, with its temp; the train step and retrieval with their
    collectives (the looked-up rows summed over ``model``, the
    gradients over the data axes; retrieval's candidate ids gathered
    over ``model`` and its scores over every axis), serving with none
    (each device scores its own rows against the replicated table), and
    no all-gather of the item table: none at all in the train step and
    serving, and retrieval's collectives move less than the table."""
    out = tmp_path / "bert4rec.json"
    proc = _run(["-m", "repro_torch.launch.dryrun", "--arch", "bert4rec",
                 "--mesh", "both", "--no-roofline", "--out", str(out)])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    rows = json.loads(out.read_text())
    assert len(rows) == 2 * 4 and {r["status"] for r in rows} == {"ok"}
    cfg = ref_configs.get_config("bert4rec").model
    table_bytes = cfg.vocab * cfg.embed_dim * 4
    for r in rows:
        serve = "serve" in r["cell"]
        _hold_partitioned_row(r, collectives=not serve)
        if r["cell"].endswith("retrieval_cand"):
            assert r["collective_bytes_per_dev_static"] < table_bytes
        else:
            assert r["collective_counts"]["all-gather"] == 0, r


FAILING = """
import sys
import repro_torch.launch.tasks as tasks
import repro_torch.launch.dryrun as dryrun

real = tasks.build_task

def build_task(spec, shape, mesh, **kw):
    if shape.name == "molecule":
        raise RuntimeError("planted failure")
    return real(spec, shape, mesh, **kw)

tasks.build_task = build_task
sys.argv = ["dryrun", "--arch", "gat-cora", "--shape", "molecule",
            "--shape", "full_graph_sm", "--smoke", "--no-roofline"]
dryrun.main()
"""


def test_dryrun_exits_1_on_a_failed_cell():
    proc = _run(["-c", FAILING])
    assert proc.returncode == 1, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert _labels(proc.stdout, "FAILED") == ["gat-cora:molecule@single"]
    assert _labels(proc.stdout) == ["gat-cora:full_graph_sm@single"]
    assert "planted failure" in proc.stderr
