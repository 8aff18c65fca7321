"""``repro_torch.roofline`` against the JAX package's ``repro.roofline``:
the report's row key for key on the same inputs and hardware, the H100
defaults, the deliberate divergences (``roofline_fraction`` on the
report's own ``HW``; ``collective_stats`` over recorded collectives in
place of ``parse_collectives`` over HLO text; no ``extrapolate``), and
the trace counter's FLOPs, bytes and peak live bytes by hand.

The collectives are recorded on a fake world (``launch.mesh.
init_fake_world``), which runs in a subprocess: a process group in the
pytest process would outlive the test on its worker."""
import inspect
import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.roofline import analysis as ref
from repro_torch.roofline import analysis as port

REF_HW = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (n_devices, hlo_flops, hlo_bytes, collective bytes a device, model
# flops, peak memory a device): one cell led by each term.
CASES = {
    "compute": (256, 9.97e16, 2.0e14, 1.2e9, 7.4e16, 3.1e10),
    "memory": (256, 6.3e12, 2.5e13, 4.0e8, 3.0e12, 7.7e10),
    "collective": (512, 1.1e16, 5.0e13, 9.9e11, 7.8e15, 1.4e10),
}


def _reports(case, port_hw):
    n, flops, nbytes, coll, model, peak = CASES[case]
    counts = {k: 3 for k in ref._COLLECTIVES}
    by_kind = {k: coll / len(ref._COLLECTIVES) for k in ref._COLLECTIVES}
    args = dict(name=f"cell:{case}", n_devices=n, hlo_flops=flops,
                hlo_bytes=nbytes, collective_bytes_per_dev=coll,
                collective_counts=counts, collective_bytes_by_kind=by_kind,
                model_flops=model, peak_memory_per_dev=peak)
    return (ref.RooflineReport(**args).finish(),
            port.RooflineReport(**args).finish(port_hw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_equals_reference_on_its_hardware(case):
    want, got = _reports(case, port.HW(**REF_HW))
    want_row, got_row = want.row(), got.row()
    assert got_row.pop("partitioned") is True
    assert got_row.keys() == want_row.keys()
    assert got_row["dominant"] == want_row["dominant"] == case
    for key, w in want_row.items():
        g = got_row[key]
        if isinstance(w, str):
            assert g == w, key
        else:
            assert math.isclose(g, w, rel_tol=1e-12), (key, g, w)


def test_default_hw_is_the_h100():
    hw = port.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (989.4e12, 3.35e12, 50e9)
    _, got = _reports("compute", hw)
    n, flops, nbytes, coll, model, _ = CASES["compute"]
    assert got.compute_s == flops / (n * 989.4e12)
    assert got.memory_s == nbytes / (n * 3.35e12)
    assert got.collective_s == coll / 50e9


def test_roofline_fraction_prices_with_the_report_hw():
    """Divergence: the reference's ``roofline_fraction`` always takes its
    default ``HW()`` (a TPU v5e's 197 TFLOP/s), whatever the report was
    finished with; the port's takes the ``HW`` of ``finish``."""
    h100 = dict(peak_flops=989.4e12, hbm_bw=3.35e12, ici_bw=50e9)
    n, flops, nbytes, coll, model, peak = CASES["compute"]
    args = dict(name="c", n_devices=n, hlo_flops=flops, hlo_bytes=nbytes,
                collective_bytes_per_dev=coll, collective_counts={},
                collective_bytes_by_kind={}, model_flops=model,
                peak_memory_per_dev=peak)
    want = ref.RooflineReport(**args).finish(ref.HW(**h100))
    got = port.RooflineReport(**args).finish(port.HW(**h100))
    assert got.step_time_s == want.step_time_s
    t = got.step_time_s
    assert math.isclose(got.roofline_fraction,
                        model / (n * 989.4e12 * t), rel_tol=1e-12)
    assert math.isclose(want.roofline_fraction,
                        model / (n * 197e12 * t), rel_tol=1e-12)
    assert math.isclose(want.roofline_fraction / got.roofline_fraction,
                        989.4 / 197, rel_tol=1e-12)


def test_unpartitioned_report_reads_compute_and_memory_only():
    """A cell the port does not partition: collectives None (never 0),
    ``partitioned`` false, the dominant term and step time from the
    compute and memory terms."""
    trace = port.Trace(flops=4e15, bytes=9e13, peak_bytes=1e11,
                       argument_bytes=5e10, output_bytes=1e9,
                       alias_bytes=0.0, collectives=[], kernel_calls={},
                       n_ops=1, seconds=0.0)
    rep = port.analyze_trace("c", trace, 256, 3e15, per_device=False)
    row = rep.row()
    assert row["partitioned"] is False
    assert row["coll_bytes_dev"] is None and row["collective_s"] is None
    assert row["peak_mem_gb"] is None
    assert rep.compute_s == 4e15 / (256 * 989.4e12)
    assert rep.memory_s == 9e13 / (256 * 3.35e12)
    assert rep.step_time_s == max(rep.compute_s, rep.memory_s)
    assert rep.dominant == "memory"
    # One device's own program: counts scale by the devices, collectives
    # are the device's.
    trace.collectives = [port.CollectiveRecord("all-reduce", 1000)]
    rep = port.analyze_trace("c", trace, 16, 3e15, per_device=True)
    assert rep.partitioned and rep.hlo_flops == 16 * 4e15
    assert rep.collective_bytes_per_dev == 2000.0
    assert rep.peak_memory_per_dev == 1e11


def test_analyze_task_has_no_extrapolate():
    """Divergence: the reference corrects XLA's once-counted while body
    by 1- and 2-period variants (``extrapolate``); the port's eager
    trace runs every layer, so it takes no such option (its counts grow
    by the same amount with each layer, see
    ``test_trace_counts_every_layer``)."""
    assert "extrapolate" in inspect.signature(ref.analyze_task).parameters
    assert "extrapolate" not in inspect.signature(
        port.analyze_task).parameters


def test_trace_counts_every_layer():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.tasks import build_task

    spec = get_config("llama3.2-1b", smoke=True)
    shape = dataclasses.replace(spec.shape("train_4k"),
                                dims={"seq_len": 64, "global_batch": 2})
    flops = []
    for n_layers in (1, 2, 3):
        cfg = dataclasses.replace(spec.model, n_layers=n_layers)
        task = build_task(dataclasses.replace(spec, model=cfg), shape,
                          _OneDevice())
        flops.append(task.trace().flops)
    assert flops[0] > 0
    assert flops[2] - flops[1] == flops[1] - flops[0] > 0


class _OneDevice:
    """A 1 x 1 ``(data, model)`` mesh stand-in."""

    mesh_dim_names = ("data", "model")

    def size(self, dim=None):
        return 1


HLO = """\
HloModule cell
ENTRY %main {
  %p = f32[8,4]{1,0} parameter(0)
  %ar = f32[8,4]{1,0} all-reduce(f32[8,4]{1,0} %p), replica_groups={}
  %ag = bf16[32,4]{1,0} all-gather(bf16[2,4]{1,0} %q), dimensions={0}
  %rs = f32[2,4]{1,0} reduce-scatter(f32[32,4]{1,0} %r), dimensions={0}
  %a2a = s32[16,3]{1,0} all-to-all(s32[16,3]{1,0} %s), dimensions={0}
  %ar2 = f32[8,4]{1,0} all-reduce(f32[8,4]{1,0} %ar), replica_groups={}
}
"""

RECORD = """
import json, sys
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.mesh import init_fake_world
from repro_torch.roofline.analysis import TraceCounter

init_fake_world(16)
mode = FakeTensorMode()
with mode:
    a = torch.empty(8, 4)
    b = torch.empty(2, 4, dtype=torch.bfloat16)
    c = torch.empty(32, 4)
    d = torch.empty(16, 3, dtype=torch.int32)

def fn(a, b, c, d):
    dist.all_reduce(a)
    ag = torch.empty(32, 4, dtype=torch.bfloat16)
    dist.all_gather_into_tensor(ag, b)
    rs = torch.empty(2, 4)
    dist.reduce_scatter_tensor(rs, c)
    o = torch.empty_like(d)
    dist.all_to_all_single(o, d)
    dist.all_reduce(a)
    return ag, rs, o

try:
    _, trace = TraceCounter().run(fn, (a, b, c, d), mode)
finally:
    dist.destroy_process_group()
print(json.dumps([[r.kind, r.nbytes] for r in trace.collectives]))
"""


def test_collective_stats_equal_parse_collectives():
    proc = subprocess.run(
        [sys.executable, "-c", RECORD], capture_output=True, text=True,
        timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    records = [port.CollectiveRecord(kind, n) for kind, n in
               json.loads(proc.stdout.strip().splitlines()[-1])]
    got = port.collective_stats(records)
    want = ref.parse_collectives(HLO)
    assert got.counts == want.counts
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.total_bytes == want.total_bytes == 2 * 2 * 128 + 256 + 32 + 192
    merged = got.merged(got, scale=2.0)
    want_merged = want.merged(want, scale=2.0)
    assert merged.counts == want_merged.counts
    assert merged.bytes_by_kind == want_merged.bytes_by_kind


def test_counter_bytes_and_peak_by_hand():
    mode = FakeTensorMode()
    with mode:
        x = torch.empty(64, 32)
        w = torch.empty(32, 16)

    def fn(x, w):
        y = x @ w              # reads 8192 + 2048, writes 4096
        z = torch.relu(y)      # reads 4096, writes 4096
        del y
        s = z * 2              # reads 4096, writes 4096
        del z
        return s.view(-1).sum()  # a view (no traffic), then 4096 -> 4

    result, trace = port.TraceCounter().run(fn, (x, w), mode)
    assert trace.flops == 2 * 64 * 32 * 16
    assert trace.bytes == (8192 + 2048 + 4096) + 2 * 4096 + 2 * 4096 + (
        4096 + 4)
    assert trace.argument_bytes == 8192 + 2048
    # x, w, then y and z live together, then z and s: two 4096-byte
    # tensors beside the arguments at most.
    assert trace.peak_bytes == 8192 + 2048 + 2 * 4096
    assert trace.output_bytes == 4 and trace.alias_bytes == 0
    assert trace.temp_bytes == 2 * 4096 - 4

    def update(x, w):
        w.mul_(0.5)            # in place: reads and writes w
        return w

    _, trace = port.TraceCounter().run(update, (x, w), mode)
    assert trace.bytes == 2048 + 2048
    assert trace.alias_bytes == trace.output_bytes == 2048
    assert trace.peak_bytes == trace.argument_bytes


def test_kernel_work_formulas():
    # causal Sq = Sk keeps S (S + 1) / 2 pairs; Sq > Sk keeps Sk a late row
    assert port.flash_pairs(True, 2, 3, 5, 5) == 2 * 3 * 15
    assert port.flash_pairs(True, 1, 1, 6, 4) == 1 + 2 + 3 + 4 + 4 + 4
    assert port.flash_pairs(False, 2, 3, 5, 7) == 2 * 3 * 35
    flops, nbytes = port.flash_work(1, 8, 2, 64, 64, 32, 2, True, lse=True)
    assert flops == 4 * 32 * 8 * 64 * 65 // 2
    assert nbytes == 2 * 32 * (2 * 8 * 64 + 2 * 2 * 64) + 4 * 8 * 64
    flops, nbytes = port.flash_bwd_work(1, 8, 2, 64, 64, 32, 2, True)
    assert flops == 10 * 32 * 8 * 64 * 65 // 2
    assert nbytes == 2 * 32 * (4 * 8 * 64 + 4 * 2 * 64) + 4 * 8 * 64
    assert port.segsum_work(100, 7, 16, 4) == (1600.0, 6400 + 400 + 448)


# --------------------------------------------------------------------------
# the partitioned dense LM's report on the multi-pod mesh
# --------------------------------------------------------------------------

sys.path.insert(0, os.path.dirname(__file__))
from torch_fake_world_cells import (DENSE_CELLS,  # noqa: E402
                                    GNN_FLOPS_RATIO, GNN_MULTI_CELLS,
                                    MOE_CELLS,
                                    RECSYS_CELLS, fake_world_cells,
                                    hold_partitioned, recsys_flops_ratio)


@pytest.fixture(scope="module")
def multi_cells():
    return fake_world_cells("multi")


@pytest.mark.parametrize("cell", DENSE_CELLS)
def test_dense_lm_report_is_partitioned_on_the_multi_pod_mesh(multi_cells,
                                                              cell):
    """Each dense-LM cell on the 2 x 16 x 16 mesh: one device's program
    (``hold_partitioned``), collectives over the pod
    axis (2) and the 16-way ones, and a report with its collective term:
    ``partitioned``, the device's wire bytes, FLOPs scaled by the 512
    devices, the device's peak."""
    r = multi_cells[cell]
    hold_partitioned(r)
    assert set(r["groups"]) <= {2, 16}
    rep = r["report"]
    assert rep["partitioned"] is True and rep["coll_bytes_dev"] > 0
    assert rep["hlo_flops"] == r["flops"] * 512
    assert rep["peak_mem_gb"] > 0


@pytest.mark.parametrize("cell", MOE_CELLS)
def test_moe_lm_report_is_partitioned_on_the_multi_pod_mesh(multi_cells,
                                                            cell):
    """Each MoE cell on the 2 x 16 x 16 mesh: one device's program (no
    device doing more than the whole step), the partitioner's
    collectives over the pod axis and the 16-way ones, and a report
    with its collective term and the device's peak."""
    r = multi_cells[cell]
    hold_partitioned(r, most=r["devices"])
    assert set(r["groups"]) <= {2, 16}
    rep = r["report"]
    assert rep["partitioned"] is True and rep["coll_bytes_dev"] > 0
    assert rep["hlo_flops"] == r["flops"] * 512
    assert rep["peak_mem_gb"] > 0


@pytest.mark.parametrize("cell", RECSYS_CELLS)
def test_recsys_report_is_partitioned_on_the_multi_pod_mesh(multi_cells,
                                                            cell):
    """BERT4Rec's cells at full size on the 2 x 16 x 16 mesh: one
    device's program, its FLOPs times 512 within 1e-6 of
    ``recsys_flops_ratio`` over the global trace's, collectives over the
    pod axis and the 16-way ones (none in serving), and a report with
    its collective term and the device's peak."""
    r = multi_cells[cell]
    serve = "serve" in cell
    hold_partitioned(r, most=r["devices"], collectives=not serve)
    ratio = r["flops"] * 512 / r["global_flops"]
    want = recsys_flops_ratio(cell, 512, 16)
    assert abs(ratio - want) <= 1e-6 * want, (ratio, want)
    assert set(r["groups"]) <= {2, 16}
    rep = r["report"]
    assert rep["partitioned"] is True
    assert (rep["coll_bytes_dev"] > 0) is not serve
    assert rep["hlo_flops"] == r["flops"] * 512
    assert rep["peak_mem_gb"] > 0


@pytest.mark.parametrize("cell", GNN_MULTI_CELLS)
def test_gnn_report_is_partitioned_on_the_multi_pod_mesh(multi_cells, cell):
    """Each GNN's ``molecule`` cell on the 2 x 16 x 16 mesh: one device's
    program, its FLOPs times 512 the reckoning's (``GNN_FLOPS_RATIO``)
    within 1e-6, every collective over the 512 ranks of the flattened
    axes, every all-gather a node array's, and a report with its
    collective term and the device's peak."""
    r = multi_cells[cell]
    hold_partitioned(r, most=1 + 1e-6)
    ratio = r["flops"] * 512 / r["global_flops"]
    assert abs(ratio - GNN_FLOPS_RATIO) <= 1e-6 * GNN_FLOPS_RATIO, ratio
    assert r["groups"] == [512]
    assert r["all_gather_rows"] == [r["graph"][0]]
    rep = r["report"]
    assert rep["partitioned"] is True and rep["coll_bytes_dev"] > 0
    assert rep["hlo_flops"] == r["flops"] * 512
    assert rep["peak_mem_gb"] > 0
