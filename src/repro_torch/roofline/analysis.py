"""Three-term roofline of one traced step, the counterpart of the JAX
package's ``repro.roofline.analysis``, priced on the H100's own peaks.

The JAX package lowers each cell with ``jax.jit``, reads XLA's
``cost_analysis`` / ``memory_analysis`` and parses the partitioned HLO's
collectives.  Eager torch has no compiler, no HLO and no SPMD
partitioner, so the port traces the step itself:

* ``TraceCounter`` runs the step on fake tensors (``FakeTensorMode``:
  full shapes, no memory) under its own dispatch mode, which records
  - FLOPs: the matrix products by ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``; the same count as
    ``FlopCounterMode`` on every unpartitioned cell), plus the work the
    kernels' fake routes charge (``kernel_work``: K4 forward and
    backward, K2a), which no aten op carries;
  - bytes: every non-view aten op's input and output bytes, the eager
    program's memory traffic with no fusion at all (a compiler that
    fused the elementwise chains would move fewer), plus the kernels'
    own bytes;
  - peak live bytes: each storage tallied when an op first makes it and
    released by ``weakref.finalize`` when it dies, over the step's
    arguments, which are live throughout;
  - the outputs, and the ones that alias an argument (the train step
    updates its state in place);
  - each ``c10d`` collective's kind and result bytes.
* A partitioned step (DTensor arguments, ``launch.tasks``) is one
  device's own program.  A dispatch mode sees an op on DTensors at its
  global shapes, and DTensor then runs the local op on the device's
  shard (which a mode may or may not see, by torch version): the
  counter counts each DTensor op once, as its local work (the
  matrix-product FLOPs at the global shapes over the mesh extent that
  cuts its output, as ``Shard`` or ``Partial``; the bytes and storages
  of the local shards), skips any op it sees inside a DTensor op's
  dispatch (that op's local op), and counts the plain ops outside one
  (the ``local_map`` bodies: the kernels, the vocab-parallel loss, a
  MoE layer's routing, dispatch gathers, expert products and combine
  at the rank's own groups and experts) as they are (``FlopCounterMode`` itself would count a DTensor op at its
  global shape, and its local op again where it sees it).  DTensor's
  redistributions and the model's own all-reduces are
  functional collectives, recorded with their process group.
* Eager tracing runs every layer, so the while-body undercount the JAX
  package corrects by compiling 1- and 2-period variants
  (``extrapolate``) does not arise: ``analyze_task`` has no such option.
* ``collective_stats`` takes the recorded collectives where the JAX
  package parses HLO text, with its kinds and its convention:
  all-reduce counts 2x (ring = reduce-scatter + all-gather), the others
  their result bytes.
* A trace of the whole global step (a cell built on a stand-in of a
  mesh) gives no collectives: its report takes
  ``collective_bytes_per_dev = None`` (never 0) and ``partitioned:
  false``, and its ``dominant`` and ``step_time_s`` read the compute and
  memory terms only.  A trace of one device's own program (a
  partitioned cell, a 1 x 1 mesh, or the edge-sharded GNN
  step on rank 0 of a fake world) is partitioned: its FLOPs and bytes
  scale by the device count, as the JAX package scales its per-device
  cost analysis.

Hardware: an NVIDIA H100 SXM5 80GB at 700 W (``HW``).  Collectives are
charged per device against one link's lane, as the JAX package charges
one ICI link.

``flash_work`` / ``flash_bwd_work`` / ``segsum_work`` hold the kernels'
work (operations and bytes) in one place: the fake routes charge them
to the trace, and ``chip_smoke.py``'s bounds read them.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass(frozen=True)
class HW:
    # Dense bf16 on the tensor cores, H100 SXM5 datasheet (989.4 TFLOP/s
    # without sparsity; chip_smoke.py's TENSOR_FLOPS_PER_CLOCK_PER_SM:
    # 4,096 a clock an SM at 1,830 MHz on 132 SMs).
    peak_flops: float = 989.4e12
    # HBM3, H100 SXM5 datasheet: 3.35 TB/s.
    hbm_bw: float = 3.35e12
    # One link a device's collectives are charged against: one NDR
    # InfiniBand NIC a GPU, 400 Gb/s = 50 GB/s.  Both production meshes
    # span nodes of 8 GPUs, so a collective over them crosses the NICs;
    # NVLink (450 GB/s a direction) would be the lane inside one node.
    ici_bw: float = 50e9


_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# c10d ops (what ``torch.distributed``'s calls dispatch to) and the
# functional collectives, by kind.  ``broadcast``, ``gather``,
# ``scatter`` and ``reduce`` have no kind in the JAX package's table;
# the port's paths issue none of them.
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# Ops that make a tensor without touching memory, or only name one.
_NO_TRAFFIC = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "detach", "alias",
    "_local_scalar_dense",
}


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective the traced program issued: its kind (one of the
    JAX package's five), the bytes of its result on this device, the
    ranks of its process group (0 where not known), and the leading
    extent of its (first) result tensor (0 for a scalar: an all-gather's
    rows tell a node array from an edge array)."""

    kind: str
    nbytes: int
    group_size: int = 0
    rows: int = 0


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a c10d or functional collective
    ran over (its ``ProcessGroup`` or ``group_name`` argument; 0 where
    none resolves)."""
    import torch.distributed as dist

    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    for key, a in named.items():
        if isinstance(a, dist.ProcessGroup):
            return int(a.size())
        if key == "process_group" and isinstance(a, torch.ScriptObject):
            # a c10d op's group, boxed
            return int(dist.ProcessGroup.unbox(a).size())
    name = named.get("group_name", named.get("tag"))
    if isinstance(name, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        try:
            return int(_resolve_process_group(name).size())
        except (RuntimeError, ValueError, KeyError):
            return 0
    return 0


def local_tensor(t):
    """A DTensor's local shard, any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _op_flops(func, args, kwargs, out) -> float:
    """``FlopCounterMode``'s formula for ``func`` (0 where it has none),
    at the shapes of ``args`` as given."""
    from torch.utils.flop_counter import flop_registry

    fn = flop_registry.get(func._overloadpacket)
    return float(fn(*args, **kwargs, out_val=out)) if fn is not None else 0.0


def _has_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in _tensors(x))


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int]
    bytes_by_kind: dict[str, float]

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def merged(self, other: "CollectiveStats", scale: float = 1.0):
        counts = dict(self.counts)
        by = dict(self.bytes_by_kind)
        for k, v in other.counts.items():
            counts[k] = counts.get(k, 0) + int(v * scale)
        for k, v in other.bytes_by_kind.items():
            by[k] = by.get(k, 0.0) + v * scale
        return CollectiveStats(counts, by)


def collective_stats(records) -> CollectiveStats:
    """Counts and per-device wire bytes by kind of the recorded
    collectives (``Trace.collectives``): all-reduce counted 2x (ring =
    reduce-scatter + all-gather over the same payload), the others
    their result bytes; the JAX package's ``parse_collectives`` over
    partitioned HLO text."""
    counts: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    bytes_by: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    for rec in records:
        mult = 2.0 if rec.kind == "all-reduce" else 1.0
        counts[rec.kind] += 1
        bytes_by[rec.kind] += rec.nbytes * mult
    return CollectiveStats(counts, bytes_by)


# --------------------------------------------------------------------------
# the kernels' work
# --------------------------------------------------------------------------

def flash_pairs(causal: bool, b: int, h: int, sq: int, sk: int) -> int:
    """(query, key) pairs one K4 call keeps: every one bidirectional;
    causal, query ``i`` keeps keys ``0 .. min(i, Sk - 1)`` (S (S + 1) / 2
    of the S^2 when ``Sq = Sk``)."""
    if not causal:
        return b * h * sq * sk
    m = min(sq, sk)
    return b * h * (m * (m + 1) // 2 + (sq - m) * sk)


def flash_work(b: int, h: int, kvh: int, sq: int, sk: int, d: int,
               itemsize: int, causal: bool,
               lse: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one K4 forward call: 4 D operations a kept
    pair (its two products); q and out with ``h`` heads and k and v with
    ``kvh`` read or written once, and each row's float32 log-sum-exp when
    ``lse``."""
    flops = 4.0 * d * flash_pairs(causal, b, h, sq, sk)
    nbytes = itemsize * d * b * (2 * h * sq + 2 * kvh * sk)
    if lse:
        nbytes += 4 * b * h * sq
    return flops, float(nbytes)


def flash_bwd_work(b: int, h: int, kvh: int, sq: int, sk: int, d: int,
                   itemsize: int, causal: bool) -> tuple[float, float]:
    """(operations, bytes) of one K4 backward call: 2.5 x the forward's
    4 D a kept pair (five products against its two); q, out, dO and dQ
    with ``h`` heads and k, v, dK and dV with ``kvh`` once each, and the
    row lse."""
    flops = 2.5 * 4.0 * d * flash_pairs(causal, b, h, sq, sk)
    nbytes = itemsize * d * b * (4 * h * sq + 4 * kvh * sk) + 4 * b * h * sq
    return flops, float(nbytes)


def segsum_work(e: int, n: int, d: int, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of one K2a call: one add a message element;
    the messages and their int32 ids read once, the output written
    once."""
    return float(e * d), float(e * d * itemsize + 4 * e + n * d * itemsize)


# --------------------------------------------------------------------------
# the trace counter
# --------------------------------------------------------------------------

_ACTIVE: list["TraceCounter"] = []


def kernel_work(name: str, flops: float, nbytes: float) -> None:
    """Charge one kernel call's work to every active ``TraceCounter``
    (a kernel's fake route calls this in place of its launch)."""
    for counter in _ACTIVE:
        counter.kernel_flops += flops
        counter.kernel_bytes += nbytes
        counter.kernel_calls[name] = counter.kernel_calls.get(name, 0) + 1


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in _tensors(item)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(tensors) -> dict[int, int]:
    """``{storage id: bytes}`` of the distinct storages under
    ``tensors``."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


@dataclasses.dataclass
class Trace:
    """What ``TraceCounter`` recorded of one step."""

    flops: float              # the matrix products' + the kernels'
    bytes: float              # non-view ops' inputs + outputs, + kernels'
    peak_bytes: float         # most bytes live at once, arguments included
    argument_bytes: float
    output_bytes: float
    alias_bytes: float        # outputs that are argument storages
    collectives: list         # [CollectiveRecord]
    kernel_calls: dict        # {kernel name: fake-route calls}
    n_ops: int
    seconds: float

    @property
    def temp_bytes(self) -> float:
        """Peak less the arguments and the fresh outputs: the JAX
        package's ``temp_size`` (peak = args + outputs - alias + temp)."""
        return max(0.0, self.peak_bytes - self.argument_bytes
                   - (self.output_bytes - self.alias_bytes))


class TraceCounter(TorchDispatchMode):
    """Counts the aten ops of a step (see the module docstring).  Use as
    ``TraceCounter().run(fn, args, fake_mode)``; it enters itself inside
    ``fake_mode``."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernel_calls: dict[str, int] = {}
        self.collectives: list[CollectiveRecord] = []
        self.n_ops = 0
        self.flops = 0.0
        self._dt_depth = 0     # > 0 inside a DTensor op's dispatch
        self._live = 0
        self._peak = 0
        self._seen: set[int] = set()
        self._open = False

    def _track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            self._seen.add(key)
            n = st.nbytes()
            self._live += n
            self._peak = max(self._peak, self._live)
            weakref.finalize(st, self._release, key, n)

    def _release(self, key: int, n: int) -> None:
        if self._open and key in self._seen:
            self._seen.discard(key)
            self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor((args, kwargs)):
            self._dt_depth += 1
            try:
                out = func(*args, **kwargs)
            finally:
                self._dt_depth -= 1
            self._count_dtensor_op(func, args, kwargs, out)
            return out
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional"):
            self.n_ops += 1
            kind = _C10D_KINDS.get(name)
            if kind is not None:
                res = _tensors(out if ns == "_c10d_functional"
                               else args[0])
                self.collectives.append(CollectiveRecord(
                    kind, sum(_nbytes(t) for t in res),
                    _group_size(func, args, kwargs),
                    int(res[0].shape[0]) if res and res[0].dim() else 0))
            return out
        if self._dt_depth:
            return out  # a DTensor op's local op: counted with it
        self.n_ops += 1
        outs = _tensors(out)
        if not outs:
            return out
        self.flops += _op_flops(func, args, kwargs, out)
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in _tensors(args))
            self.bytes += sum(_nbytes(t) for t in _tensors(kwargs))
            self.bytes += sum(_nbytes(t) for t in outs)
        self._track(outs)
        return out

    def _count_dtensor_op(self, func, args, kwargs, out) -> None:
        """One op on DTensors as its local work (module docstring)."""
        self.n_ops += 1
        outs = _tensors(out)
        if not outs:
            return
        flops = _op_flops(func, args, kwargs, out)
        if flops:
            from torch.distributed.tensor import DTensor

            first = next((t for t in outs if isinstance(t, DTensor)), None)
            if first is not None:
                mesh = first.device_mesh
                flops /= math.prod(mesh.size(i) for i, p in enumerate(
                    first.placements) if not p.is_replicate())
            self.flops += flops
        local = [local_tensor(t) for t in outs]
        if not func.is_view and func._schema.name.split("::")[-1] \
                not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(local_tensor(t))
                              for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in local)
        self._track(local)

    def run(self, fn, args: tuple, fake_mode) -> tuple[Any, Trace]:
        """``fn(*args)`` under ``fake_mode`` and this counter: ``(its
        result, the Trace)``."""
        arg_tensors = [local_tensor(t) for _, t in named_tensors(args)]
        arg_storages = _storage_bytes(arg_tensors)
        t0 = time.perf_counter()
        self._open = True
        _ACTIVE.append(self)
        try:
            # The arguments are live throughout.
            self._track(arg_tensors)
            with fake_mode, self:
                result = fn(*args)
            out_storages = _storage_bytes(
                [local_tensor(t) for _, t in named_tensors(result)])
        finally:
            _ACTIVE.remove(self)
            self._open = False
        alias = sum(n for k, n in out_storages.items() if k in arg_storages)
        return result, Trace(
            flops=self.flops + self.kernel_flops,
            bytes=self.bytes + self.kernel_bytes,
            peak_bytes=float(self._peak),
            argument_bytes=float(sum(arg_storages.values())),
            output_bytes=float(sum(out_storages.values())),
            alias_bytes=float(alias),
            collectives=list(self.collectives),
            kernel_calls=dict(self.kernel_calls),
            n_ops=self.n_ops,
            seconds=time.perf_counter() - t0,
        )


def _path_str(name: str) -> str:
    """``train.tree``'s leaf name as ``'a/b/0/c'`` (the JAX package's
    ``_path_str``)."""
    from repro_torch.train.tree import path_str

    return path_str(name)


def named_tensors(tree) -> list[tuple[str, torch.Tensor]]:
    """``[(name 'a/b/0/c', tensor)]`` of every tensor under a step's
    arguments or result (``train.tree``'s nodes; a dataclass leaf, such
    as a ``GraphBatch``, by its fields)."""
    from repro_torch.train.tree import named_leaves

    out = []
    for name, leaf in named_leaves(tree):
        name = _path_str(name)
        if isinstance(leaf, torch.Tensor):
            out.append((name, leaf))
        elif dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            for f in dataclasses.fields(leaf):
                v = getattr(leaf, f.name)
                if isinstance(v, torch.Tensor):
                    out.append(((name + "/" if name else "") + f.name, v))
    return out


# --------------------------------------------------------------------------
# the report
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineReport:
    name: str
    n_devices: int
    hlo_flops: float                  # global (all devices)
    hlo_bytes: float                  # global memory traffic
    collective_bytes_per_dev: float | None  # per-device wire bytes;
                                            # None: not partitioned
    collective_counts: dict[str, int] | None
    collective_bytes_by_kind: dict[str, float] | None
    model_flops: float
    peak_memory_per_dev: float | None  # bytes; None where unknown
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float | None = 0.0
    hw: HW = dataclasses.field(default_factory=HW)

    @property
    def partitioned(self) -> bool:
        return self.collective_bytes_per_dev is not None

    def finish(self, hw: HW = HW()):
        self.hw = hw
        self.compute_s = self.hlo_flops / (self.n_devices * hw.peak_flops)
        self.memory_s = self.hlo_bytes / (self.n_devices * hw.hbm_bw)
        self.collective_s = (None if self.collective_bytes_per_dev is None
                             else self.collective_bytes_per_dev / hw.ici_bw)
        return self

    def _terms(self) -> dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s}
        if self.collective_s is not None:
            terms["collective"] = self.collective_s
        return terms

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-model step time: dominant term (perfect overlap)."""
        return max(self._terms().values())

    @property
    def useful_ratio(self) -> float:
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS / (devices x peak x step_time), at the peak of the
        ``HW`` the report was finished with (the JAX package's always
        takes its default ``HW()``)."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        denom = self.n_devices * self.hw.peak_flops * t
        return self.model_flops / denom

    def row(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "devices": self.n_devices,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes_dev": self.collective_bytes_per_dev,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_mem_gb": (None if self.peak_memory_per_dev is None
                            else self.peak_memory_per_dev / 1e9),
            "partitioned": self.partitioned,
        }


def analyze_trace(name: str, trace: Trace, n_devices: int,
                  model_flops: float = 0.0, *, per_device: bool,
                  hw: HW = HW()) -> RooflineReport:
    """The report of one ``Trace``, the counterpart of
    ``analyze_compiled``.  ``per_device``: the trace is one device's own
    program (its FLOPs and bytes times ``n_devices`` are the global
    ones, its collectives and peak are the device's); otherwise it is
    the whole global step, and the per-device collectives and peak are
    unknown (None)."""
    if per_device:
        coll = collective_stats(trace.collectives)
        return RooflineReport(
            name=name, n_devices=n_devices,
            hlo_flops=trace.flops * n_devices,
            hlo_bytes=trace.bytes * n_devices,
            collective_bytes_per_dev=coll.total_bytes,
            collective_counts=coll.counts,
            collective_bytes_by_kind=coll.bytes_by_kind,
            model_flops=model_flops,
            peak_memory_per_dev=trace.peak_bytes,
        ).finish(hw)
    return RooflineReport(
        name=name, n_devices=n_devices, hlo_flops=trace.flops,
        hlo_bytes=trace.bytes, collective_bytes_per_dev=None,
        collective_counts=None, collective_bytes_by_kind=None,
        model_flops=model_flops, peak_memory_per_dev=None,
    ).finish(hw)


def analyze_task(task, hw: HW = HW()) -> RooflineReport:
    """Trace ``task`` (``Task.trace``, cached on the task) and derive the
    three roofline terms.  No ``extrapolate``: the eager trace runs
    every layer, so nothing is under-counted."""
    return analyze_trace(task.name, task.trace(), task.n_devices,
                         task.model_flops_per_step,
                         per_device=task.per_device, hw=hw)
