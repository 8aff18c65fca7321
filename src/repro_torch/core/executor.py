"""One API, many design points: the ``Engine`` facade, in PyTorch.

``Engine(...).run(spec)`` takes an ``AlgorithmSpec``: it resolves the
representation (the bipartite incidence, or the clique expansion's
constant folding for specs that never touch hyperedge state,
``select_representation``), on the bipartite representation the backend
(``local``, or with ``Engine(mesh=)`` the ``replicated`` / ``sharded``
backends over a partition plan: ``select_partition``,
``select_backend``; ``repro_torch.core.distributed``) and the
``delivery`` axis (reference gather/mask/segment path vs the fused
degree-class layout, which on the card runs the hand-written CUDA
kernel, ``select_delivery``), then executes the superstep loop of
``repro_torch.core.engine`` (every rank of the mesh calls ``run`` with
the same spec) or the spec's ``clique_program`` over ``to_graph``.  The chosen design point
and the measured wall, dispatch and device-wait times come back on the
``Result``; ``explain`` reports every axis's candidates and their
predicted costs without executing.  ``Engine(tracer=, metrics=)``
records spans (``repro_torch.obs``) and surfaces the executable cache in
the metrics registry.

``Engine(...).compile(spec)`` resolves the design point once and returns
a ``CompiledAlgorithm`` (``repro_torch.core.serving``): ``run`` /
``run_batch`` / ``warmup`` over shape-bucketed executables kept in this
Engine's LRU cache (``cache_stats``); on the card each executable
replays a CUDA graph of one superstep pair.

``Engine(...).analyze(spec)`` takes an ``AnalyticsSpec`` (batch
analytics: the h-motif census, exact or sampled, and pair
intersections).  It resolves the representation (bipartite, or
``clique``: the materialized pair-size table of the dual hypergraph),
the intersection kernel (``bitset``, which on the card runs the
hand-written CUDA kernel, or ``merge``) and the census mode with the
JAX package's cost models, and returns an ``AnalyticsResult``; with a
mesh, the ``sharded`` backend tiles the pair batches over the ranks.
``submit`` dispatches on the spec's type.
"""
from __future__ import annotations

import dataclasses
import functools
import statistics
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.api import constant_initial_msg, tree_leaves, tree_map
from repro_torch.core.clique import clique_expansion_size, to_graph
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import compute, deliver
from repro_torch.core.hypergraph import HyperGraph
from repro_torch.kernels.deliver import (
    DELIVERY_MODES,
    layout_pair,
    plan_degree_classes,
    plan_ell_width,
    select_lowering,
)
from repro_torch.kernels.deliver.layout import RESIDUAL_WEIGHT
from repro_torch.obs.calibrate import delivery_traffic_pair, reference_traffic
from repro_torch.obs.metrics import default_registry, weak_provider
from repro_torch.obs.trace import maybe_span

REPRESENTATIONS = ("auto", "bipartite", "clique")
BACKENDS = ("auto", "local", "replicated", "sharded")
INTERSECT_KERNELS = ("auto", "bitset", "merge")
ANALYTICS_TASKS = ("hmotif_census", "pair_intersections")
ANALYTICS_MODES = ("auto", "exact", "sample")

Pytree = Any


def _serialized(method):
    """Run an ``Engine`` method under the Engine's lock: whatever it
    queues on the card (layout builds, host reads, pairs) never overlaps
    a CUDA graph capture of this Engine on another thread."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)

    return call


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Every design choice from the paper, in one place (the JAX
    package's fields; see ``repro.core.executor.ExecutionConfig``).

    ``backend``: ``local``, ``replicated`` or ``sharded`` (the last two
    need ``Engine(mesh=)``) or ``auto``.  ``checkpoint_every`` snapshots the loop state every N superstep
    pairs into ``checkpoint_dir`` (``repro_torch.faults.checkpoint``)
    and resumes from its latest snapshot, bitwise equal to an
    uninterrupted run; the clique representation ignores it, as in the
    JAX package.  ``representation='clique'`` constant-folds
    an ``AlgorithmSpec`` onto ``to_graph`` (legal only for specs that
    never touch hyperedge state and ship a ``clique_program``); for
    ``Engine.analyze`` it means the dual hypergraph's materialized
    pair-size table.  ``jit`` is accepted and has no effect: PyTorch
    runs eagerly.
    ``delivery``: ``xla`` (reference gather -> mask -> segment reduce),
    ``pallas_fused`` (the fused layout path: the CUDA kernel on the card,
    its sliced-ELL lowering on the CPU) or ``auto``.
    """

    representation: str = "auto"
    backend: str = "auto"
    partition_strategy: str = "auto"
    n_parts: int | None = None
    axis: str = "data"
    jit: bool = False
    max_iters: int | None = None
    collect_stats: bool = False
    clique_edge_budget: float = 4.0
    replicated_bias: float = 0.5
    intersect_kernel: str = "auto"
    delivery: str = "auto"
    checkpoint_every: int | None = None
    checkpoint_dir: str | None = None

    def __post_init__(self):
        if self.checkpoint_every is not None and self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {self.checkpoint_every}"
            )
        if self.checkpoint_every is not None and self.checkpoint_dir is None:
            raise ValueError(
                "checkpoint_every needs checkpoint_dir (where snapshots go)"
            )
        if self.representation not in REPRESENTATIONS:
            raise ValueError(
                f"representation must be one of {REPRESENTATIONS}, "
                f"got {self.representation!r}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}"
            )
        if self.intersect_kernel not in INTERSECT_KERNELS:
            raise ValueError(
                f"intersect_kernel must be one of {INTERSECT_KERNELS}, "
                f"got {self.intersect_kernel!r}"
            )
        if self.delivery not in DELIVERY_MODES:
            raise ValueError(
                f"delivery must be one of {DELIVERY_MODES}, "
                f"got {self.delivery!r}"
            )


@dataclasses.dataclass(frozen=True)
class Result:
    """What an execution produced, plus the design point that produced it.

    ``superstep_stats``: ``(v_active, he_active)`` int32 tensors of
    length ``max_iters`` when ``collect_stats`` was set (``[B,
    max_iters]`` from ``run_batch``).
    ``supersteps_executed``: batched serving only — the superstep pairs
    the batch ran (its slowest query's count, halting pair included).
    ``decision``: the reasons behind each resolved axis, plus
    ``measured`` (``wall_s``, ``dispatch_s``, ``device_wait_s``,
    ``max_iters``, ``supersteps``, ``pairs_run``, ``host_syncs``; a
    checkpointed run adds ``resumed_from``, the pairs its snapshot had
    done, and counts only the pairs it ran; on
    the fused path ``delivery``, the modeled bytes of one superstep pair
    over the built layouts (``obs.calibrate.delivery_traffic_pair``); a
    compiled run adds ``graph``: whether a CUDA graph replayed).  A
    clique run measures ``wall_s``, ``dispatch_s`` and
    ``device_wait_s``.
    """

    value: Any
    config: ExecutionConfig
    representation: str
    backend: str
    partition: str | None = None
    partition_stats: Any = None
    superstep_stats: Any = None
    supersteps_executed: Any = None
    decision: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class AnalyticsSpec:
    """A batch analytics workload — the non-iterative counterpart of
    ``AlgorithmSpec``, consumed by ``Engine.analyze`` (the JAX package's
    fields and checks).

    Attributes:
      hg: the input hypergraph (on the Engine's device).
      task: ``hmotif_census`` (classify connected 3-hyperedge patterns
        into the 26 h-motif classes) or ``pair_intersections``
        (intersection size per hyperedge pair).
      mode: census only — ``exact`` enumerates every connected triple,
        ``sample`` runs the uniform linked-pair estimator, ``auto``
        picks by the overlap-pair budget below.
      n_samples / seed / confidence: sampling-estimator parameters.
      pairs: ``pair_intersections`` only — optional ``(ea, eb)`` id
        arrays; ``None`` = every overlapping pair.
      exact_pair_budget: ``mode="auto"`` runs exact while the overlap
        graph has at most this many linked pairs.
      tile: pair-batch tile size of the intersection paths on the CPU
        (on the card the bitset kernel takes a batch in one launch).
    """

    hg: HyperGraph
    task: str = "hmotif_census"
    mode: str = "auto"
    n_samples: int = 4000
    seed: int = 0
    confidence: float = 0.95
    pairs: Any = None
    exact_pair_budget: int = 200_000
    tile: int = 2048
    name: str = "hmotifs"

    def __post_init__(self):
        if self.task not in ANALYTICS_TASKS:
            raise ValueError(
                f"task must be one of {ANALYTICS_TASKS}, got {self.task!r}"
            )
        if self.mode not in ANALYTICS_MODES:
            raise ValueError(
                f"mode must be one of {ANALYTICS_MODES}, got {self.mode!r}"
            )


@dataclasses.dataclass(frozen=True)
class AnalyticsResult:
    """What a batch analytics execution produced, plus its design point.

    Attributes:
      value: ``Census`` (exact) / ``CensusEstimate`` (sampled) for the
        census task; ``(pairs, sizes)`` host arrays for
        ``pair_intersections``.
      representation: ``clique`` = pairwise intersections materialized
        from the dual clique expansion; ``bipartite`` = derived on the
        fly from the incidence by the kernel.
      kernel: ``bitset`` | ``merge`` — the intersection kernel path.
      backend: ``local``, or ``sharded``: pair blocks tiled over the
        mesh's ranks.
      mode: ``exact`` | ``sample`` (census task; ``None`` otherwise).
      decision: cost-model numbers behind each ``auto`` choice, plus
        ``measured``: ``wall_s`` split into ``preprocess_s`` (overlap
        pairs and graph, index build, triple enumeration or sampling),
        ``intersect_s`` (the ``intersect_calls`` batch calls, copies
        included) and ``classify_s`` (cardinalities, table lookups,
        classification, histogram).
    """

    value: Any
    config: ExecutionConfig
    representation: str
    kernel: str
    backend: str
    mode: str | None = None
    decision: Mapping[str, Any] = dataclasses.field(default_factory=dict)


def select_representation(
    spec, hg: HyperGraph, *, edge_budget: float = 4.0
) -> tuple[str, dict]:
    """Clique vs bipartite for one spec — the paper's constant-folding
    rule plus a size cost model (the JAX package's, unchanged).

    Clique expansion is chosen only when (a) the algorithm never touches
    hyperedge state and ships a ``clique_program`` (correctness
    precondition, §IV-A1) and (b) the symmetrized expansion stays within
    ``edge_budget`` x the bipartite incidence count (Table I: heavy-tailed
    cardinalities blow the expansion up quadratically).
    """
    touches = getattr(spec, "touches_hyperedge_state", True)
    has_program = getattr(spec, "clique_program", None) is not None
    why: dict[str, Any] = {
        "touches_hyperedge_state": touches,
        "has_clique_program": has_program,
    }
    if touches or not has_program:
        why["reason"] = (
            "algorithm touches hyperedge state"
            if touches
            else "no clique program supplied"
        )
        return "bipartite", why

    n_clique_edges = 2 * clique_expansion_size(hg)  # symmetrized
    budget = edge_budget * max(hg.nnz, 1)
    why.update(
        clique_edges=int(n_clique_edges),
        bipartite_edges=int(hg.nnz),
        edge_budget=float(budget),
    )
    if n_clique_edges <= budget:
        why["reason"] = "expansion within edge budget"
        return "clique", why
    why["reason"] = "expansion exceeds edge budget"
    return "bipartite", why


def state_width_bytes(attr: Pytree, n: int, default: float = 4.0) -> float:
    """Bytes of state per entity in an attribute tree with leading dim
    ``n`` (one float32 dim when there is no state to measure)."""
    leaves = [leaf for leaf in tree_leaves(attr)
              if isinstance(leaf, torch.Tensor)]
    if not leaves or n <= 0:
        return default
    total = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
    return max(float(total) / n, 1.0)


def select_backend(
    plan,
    n_vertices: int,
    n_hyperedges: int,
    *,
    replicated_bias: float = 0.5,
    v_state_bytes: float = 4.0,
    he_state_bytes: float = 4.0,
) -> tuple[str, dict]:
    """Replicated vs sharded for one partition plan (the JAX package's
    model, numbers and reasons).

    The replicated backend syncs a *full-size* state buffer across every
    partition each half-superstep — equivalent to refreshing ``P - 1``
    replicas of every entity:
    ``full_sync = 2 * (P - 1) * (w_v |V| + w_he |E|)`` bytes, the widths
    being the spec's bytes of state per vertex / hyperedge.  The sharded
    backend's traffic tracks the replicas the edge cut created, weighted
    the same way (``PartitionStats.sync_bytes``).  Sharded wins when its
    projected sync is below ``replicated_bias`` x the full bound.
    """
    stats = plan.stats
    p = plan.n_parts
    full_sync = 2.0 * max(p - 1, 0) * (
        v_state_bytes * n_vertices + he_state_bytes * n_hyperedges
    )
    sharded_sync = stats.sync_bytes(v_state_bytes, he_state_bytes)
    why = {
        "n_parts": p,
        "sync_bytes_per_dim": float(stats.sync_bytes_per_dim),
        "sharded_sync_bytes": sharded_sync,
        "full_replication_sync_bytes": full_sync,
        "v_state_bytes": v_state_bytes,
        "he_state_bytes": he_state_bytes,
        "replicated_bias": replicated_bias,
    }
    if p <= 1:
        why["reason"] = "single partition: replication is free"
        return "replicated", why
    if sharded_sync < replicated_bias * full_sync:
        why["reason"] = "plan sync volume beats full replication"
        return "sharded", why
    why["reason"] = "cut replicates most entities anyway"
    return "replicated", why


def select_partition(
    hg: HyperGraph, n_parts: int, strategy: str = "auto"
) -> tuple[Any, dict]:
    """Build a plan; ``auto`` = min projected sync volume over the
    strategy registry (greedy strategies run in chunked mode so the
    selection stays cheap) — the JAX package's rule."""
    from repro_torch.partition import STRATEGIES, partition

    if strategy != "auto":
        if strategy not in STRATEGIES:
            raise ValueError(
                f"unknown partition strategy {strategy!r}; pick one of "
                f"{sorted(STRATEGIES)} or 'auto'"
            )
        kw = {"chunk": 256} if "greedy" in strategy else {}
        return partition(strategy, hg, n_parts, **kw), {
            "strategy": strategy, "reason": "explicitly configured",
        }

    best_name, best_plan = None, None
    costs = {}
    for name in sorted(STRATEGIES):
        kw = {"chunk": 256} if "greedy" in name else {}
        try:
            plan = partition(name, hg, n_parts, **kw)
        except ValueError:
            continue  # e.g. greedy bitmask width on wide meshes
        costs[name] = plan.stats.sync_bytes_per_dim
        if best_plan is None or (
            plan.stats.sync_bytes_per_dim
            < best_plan.stats.sync_bytes_per_dim
        ):
            best_name, best_plan = name, plan
    if best_plan is None:
        raise RuntimeError("no partition strategy produced a plan")
    return best_plan, {
        "strategy": best_name,
        "reason": "min projected sync volume",
        "sync_bytes_by_strategy": costs,
    }


# The CPU (ELL) cost model's budgets: the JAX package's constants,
# measured there on CPU XLA.
FUSED_MAX_WIDTH_BYTES = 64.0    # per-entity message bytes
FUSED_ELL_WORK_BUDGET = 4.0     # padded ELL slots per real incidence
FUSED_MIN_NNZ = 4096
# The card's term, measured: one delivery pair (v->he + he->v, float32
# sum) through the xla lowering and the fused K1 leaf on one H100 (700
# W), over DBLP at 5,660 to 2,838,951 incidences and 4 to 256 bytes a
# row (``chip_smoke.py`` phase 10; PERF.md §6).  Up to 64-byte rows K1
# led at every size in every recorded grid, by 1.9x or more.  At 256-byte
# rows it did not: its lead there ran from 0.88x to 2.1x, no size showed
# it 1.5x ahead in every grid, and at the small sizes the order followed
# the host (xla is bound by the host's dispatch of ~20 launches, K1 by
# the card).  So rows wider than ``H100_CONTESTED_WIDTH_BYTES`` are
# contested at every size: ``select_delivery`` times one pair on each
# lowering there (``time_in_turns``, as phase 10 times its pairs).  On
# one host xla's time there moves between two levels (~0.23 and ~0.55
# ms at 28,396 incidences) within seconds, K1's far less
# (``tools/delivery_pick_probe.py``), so a timing that puts xla a little
# ahead does not say the next will: xla is taken only when it leads by
# more than ``DELIVERY_MEASURE_MARGIN``, else the kernel.  Elsewhere
# the nnz floor is the smallest size measured: below it, unmeasured, auto
# keeps the reference lowering.
H100_FUSED_MIN_NNZ = 5_660
H100_CONTESTED_WIDTH_BYTES = 64.0
DELIVERY_MEASURE_TURNS = 20   # pairs timed a lowering at a contested point
DELIVERY_MEASURE_WARM = 3     # untimed pairs a lowering before them
DELIVERY_MEASURE_MARGIN = 0.10  # xla's lead that the pick asks for


def _non_monoid_reason(spec) -> str | None:
    """Why the fused delivery path is illegal for this spec, or None."""
    for side, prog in (("v_program", spec.v_program),
                       ("he_program", spec.he_program)):
        if getattr(prog, "reducer", None) is not None:
            return f"{side} has a custom (Seq) reducer"
        if getattr(prog, "edge_transform", None) is not None:
            return f"{side} has a per-incidence edge_transform"
    return None


def message_width_bytes(initial_msg: Any) -> float:
    """Bytes per entity of one broadcast message (from the spec's
    ``initial_msg`` template)."""
    total = 0.0
    for leaf in tree_leaves(initial_msg):
        if isinstance(leaf, torch.Tensor):
            total += float(leaf.numel() * leaf.element_size())
        else:
            arr = np.asarray(leaf)
            total += float(arr.size * arr.dtype.itemsize)
    return max(total, 1.0)


def time_in_turns(fn_a: Callable[[], Any], fn_b: Callable[[], Any],
                  device, flush: torch.Tensor | None = None,
                  turns: int = DELIVERY_MEASURE_TURNS,
                  warm: int = DELIVERY_MEASURE_WARM,
                  ) -> tuple[float, float]:
    """Median ms of ``fn_a()`` and of ``fn_b()`` on the card ``device``,
    timed in turns (a, b, a, b, ...) after ``warm`` calls each, so that
    both meet the same state of the host: every call after an L2 flush
    (``flush``, by default twice the card's L2 of int32) and from an
    idle card, the timer started once the flush is done, so that the
    host's dispatch counts in full.  ``select_delivery``'s contested
    pick and ``chip_smoke.py``'s phase 10 check both time with it."""
    if flush is None:
        flush = torch.empty(
            max(2 * torch.cuda.get_device_properties(device).L2_cache_size,
                1 << 20) // 4, dtype=torch.int32, device=device)
    for _ in range(warm):
        fn_a()
        fn_b()
    times: tuple[list, list] = ([], [])
    for _ in range(turns):
        for fn, out in ((fn_a, times[0]), (fn_b, times[1])):
            flush.zero_()
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def measure_delivery_pair(spec, hg: HyperGraph,
                          layouts) -> tuple[float, float]:
    """``(xla_ms, fused_ms)``: one delivery pair (v->he with the spec's
    ``v_program``, he->v with its ``he_program``) of messages shaped as
    ``spec.initial_msg`` on ``hg``, through the reference lowering and
    through the fused ``layouts`` (``layout_pair``'s), timed by
    ``time_in_turns``."""

    def msgs(n):
        return tree_map(lambda x: x.contiguous(), constant_initial_msg(
            spec.initial_msg, n, device=hg.device))

    m_v, m_he = msgs(hg.n_vertices), msgs(hg.n_hyperedges)

    def pair(fwd, bwd):
        deliver(m_v, None, hg.src, hg.dst, hg.n_hyperedges, spec.v_program,
                hg.e_attr, hg.e_mask, layout=fwd)
        deliver(m_he, None, hg.dst, hg.src, hg.n_vertices, spec.he_program,
                hg.e_attr, hg.e_mask, layout=bwd)

    return time_in_turns(lambda: pair(None, None), lambda: pair(*layouts),
                         hg.device)


def measured_pick(xla_ms: float, fused_ms: float) -> str:
    """The lowering a contested point takes from its two times: ``xla``
    where it leads the fused kernel by more than
    ``DELIVERY_MEASURE_MARGIN``, else ``pallas_fused``."""
    if xla_ms * (1.0 + DELIVERY_MEASURE_MARGIN) < fused_ms:
        return "xla"
    return "pallas_fused"


def select_delivery(spec, hg: HyperGraph, measure=None) -> tuple[str, dict]:
    """Fused vs reference delivery for one spec.

    Hard gates first: custom ``reducer``s / ``edge_transform`` (which
    consume materialized per-incidence rows) and empty structures take
    ``xla``.  Then per lowering:

    * ``ell`` (CPU): the JAX package's ELL cost model, unchanged — fused
      while the degree-class padding stays within
      ``FUSED_ELL_WORK_BUDGET`` slots per incidence and the message row
      within ``FUSED_MAX_WIDTH_BYTES``.
    * ``cuda``: the card's measured term.  Rows wider than
      ``H100_CONTESTED_WIDTH_BYTES`` are contested: one delivery pair is
      timed on each lowering by ``measure(spec, hg) -> (xla_ms,
      fused_ms)`` (the ``Engine``'s ``_measure_delivery``, cached per
      structure and width, the same on every rank), both times in
      ``why["measured_ms"]``, and ``measured_pick`` decides; without
      ``measure`` such a point raises.  Narrower rows take the fused kernel from
      ``H100_FUSED_MIN_NNZ`` live incidences up.
    """
    reason = _non_monoid_reason(spec)
    why: dict[str, Any] = {}
    if reason is not None:
        why["reason"] = f"non-monoid path: {reason}"
        return "xla", why
    if hg.nnz == 0 or hg.n_vertices == 0 or hg.n_hyperedges == 0:
        why["reason"] = "empty structure"
        return "xla", why

    lowering = select_lowering(hg.device)
    why["lowering"] = lowering
    live = (
        hg.e_mask.cpu().numpy() != 0
        if hg.e_mask is not None
        else np.ones(hg.nnz, bool)
    )
    nnz = int(live.sum())
    if nnz == 0:
        why["reason"] = "no live incidences"
        return "xla", why
    width = message_width_bytes(spec.initial_msg)
    why["message_width_bytes"] = width
    if lowering == "cuda":
        why.update(nnz=nnz, min_nnz=H100_FUSED_MIN_NNZ)
        if width > H100_CONTESTED_WIDTH_BYTES:
            if measure is None:
                raise ValueError(
                    f"rows of {width:g} bytes are contested on the card: "
                    "the pick is measured; pass measure= (Engine.resolve "
                    "does)")
            xla_ms, fused_ms = measure(spec, hg)
            why["measured_ms"] = {"xla": xla_ms, "pallas_fused": fused_ms}
            why["reason"] = (
                f"contested on the card (rows of {width:g} bytes > "
                f"{H100_CONTESTED_WIDTH_BYTES:g}): one delivery pair timed "
                f"on this structure, xla {xla_ms:.4f} ms, fused "
                f"{fused_ms:.4f} ms; xla only if it leads by more than "
                f"{DELIVERY_MEASURE_MARGIN:.0%}"
            )
            return measured_pick(xla_ms, fused_ms), why
        if nnz < H100_FUSED_MIN_NNZ:
            why["reason"] = (
                f"incidence below the smallest measured on the card ({nnz} "
                f"< {H100_FUSED_MIN_NNZ}): the reference lowering"
            )
            return "xla", why
        why["reason"] = (
            "monoid path on the card: the fused CUDA kernel measured "
            f"faster at every size from {H100_FUSED_MIN_NNZ} incidences up "
            f"to {H100_CONTESTED_WIDTH_BYTES:g}-byte rows (1.9-11.2x)"
        )
        return "pallas_fused", why
    if nnz < FUSED_MIN_NNZ:
        why["reason"] = (
            f"tiny incidence ({nnz} < {FUSED_MIN_NNZ}): layout and "
            "dispatch overheads dominate"
        )
        return "xla", why

    src = hg.src.cpu().numpy()[live]
    dst = hg.dst.cpu().numpy()[live]
    class_work = 0.0
    class_weighted = 0.0
    single_weighted = 0.0
    residual = 0
    plans = {}
    for side, n_dst, ids in (
        ("fwd", hg.n_hyperedges, dst), ("bwd", hg.n_vertices, src)
    ):
        deg = np.bincount(ids, minlength=n_dst)
        plan = plan_degree_classes(deg, nnz)
        k1, rem1 = plan_ell_width(deg, nnz)
        # built_work: dense slots at the builder's pow2 row padding.
        class_work += float(plan.built_work)
        class_weighted += float(
            plan.built_work - plan.residual
            + RESIDUAL_WEIGHT * plan.residual
        )
        single_weighted += float(n_dst * k1 + RESIDUAL_WEIGHT * rem1)
        residual = max(residual, plan.residual)
        plans[side] = {
            "widths": plan.widths, "rows": plan.rows,
            "residual": plan.residual,
        }
    skew_gain = single_weighted / max(class_weighted, 1.0)
    why.update(
        nnz=nnz,
        class_work_slots=class_work,
        class_weighted_work=class_weighted,
        single_ell_weighted_work=single_weighted,
        skew_gain=skew_gain,
        work_budget=FUSED_ELL_WORK_BUDGET * 2 * nnz,
        residual=residual,
        width_budget=FUSED_MAX_WIDTH_BYTES,
        class_plans=plans,
    )
    if class_work > FUSED_ELL_WORK_BUDGET * 2 * nnz:
        why["reason"] = "degree-class padding exceeds the work budget"
        return "xla", why
    if width > FUSED_MAX_WIDTH_BYTES:
        why["reason"] = (
            "wide message rows: the reference gather/scatter already "
            "vectorizes; class-table row traffic multiplies with width"
        )
        return "xla", why
    why["reason"] = (
        "degree-class dense reduces beat the serialized scatter "
        + ("(skewed degrees: per-class widths keep hubs dense)"
           if skew_gain >= 1.4
           else "(bounded class padding)")
    )
    return "pallas_fused", why


class Engine:
    """The single entry point for hypergraph execution.

    >>> eng = Engine()                    # on the card
    >>> res = eng.run(pagerank_spec(hg))
    >>> res.value, res.decision["measured"]
    >>> eng.analyze(AnalyticsSpec(hg)).value.counts   # h-motif census

    ``device``: where specs must live and run (default ``cuda``; raises
    when no card is present — pass ``device="cpu"`` for the host).
    ``exec_cache_size``: capacity of the compiled-executable LRU, in
    entries.  ``exec_cache_bytes``: its capacity in bytes (an entry
    holds its structure, layouts, loop state and graph); ``None`` is a
    quarter of the card's memory on the card and no byte bound on the
    CPU.
    ``tracer``: an optional span recorder (``repro_torch.obs.Tracer``, or
    anything with ``span``/``block``); ``metrics``: the registry this
    Engine's executable-cache counters surface through (default: the
    port's process-wide ``obs.default_registry()``).  Both cost nothing
    when unused: span sites branch on ``tracer is None`` and the
    registry provider is a weakref pulled only at snapshot time.
    ``fault_injector``: an optional ``repro_torch.faults.FaultInjector``
    whose plan fires at the instrumented points (``layout.build``,
    ``execute``, ``checkpoint.chunk``, and the attached store's
    ``disk.*`` / ``compile.aot``); duck-typed like ``tracer``, and every
    point branches on ``is None`` first.
    ``disk_cache``: an optional ``repro_torch.serve.DiskExecutableCache``
    on this Engine's device type: each new executable is made under its
    signature's lock and recorded there (``serve.cache.warm``).
    ``mesh``: a 1-D ``DeviceMesh`` over the initialised world
    (``repro_torch.launch.mesh.make_host_mesh``), its dimension named by
    ``ExecutionConfig.axis``; the distributed backends run over it, every
    rank calling the same methods with the same specs.  ``plan``: the
    ``PartitionPlan`` to run (default: ``select_partition`` per
    hypergraph, cached).  One lock (``_lock``) serializes this
    Engine's public methods and its ``CompiledAlgorithm`` calls across
    threads (the serving front-end's worker and its callers): a CUDA
    graph capture never overlaps other work of this Engine.
    """

    def __init__(
        self,
        plan=None,
        mesh=None,
        config: ExecutionConfig | None = None,
        disk_cache=None,
        tracer=None,
        metrics=None,
        fault_injector=None,
        device=None,
        exec_cache_size: int = 32,
        exec_cache_bytes: int | None = None,
        **overrides: Any,
    ):
        cfg = config if config is not None else ExecutionConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.device = resolve_device(device)
        self.config = cfg
        self.plan = plan
        self.mesh = mesh
        mesh_type = getattr(mesh, "device_type", self.device.type)
        if mesh_type != self.device.type:
            raise ValueError(
                f"the mesh spans {mesh_type} ranks; this Engine runs on "
                f"{self.device.type}"
            )
        # Auto-built plans, keyed by hypergraph identity: repeated
        # run()/resolve() on one hypergraph runs the strategy sweep once.
        # [(hg, n_parts, strategy, plan, why)]
        self._plan_cache: list = []
        # This rank's fused shard layouts per plan (and padded sizes).
        self._shard_cache: list = []
        # This rank's RankShard per structure, plan, backend and delivery:
        # its shard row on the card and the padded degrees, built once.
        self._rank_shard_cache: list = []
        # Fused-delivery layouts, keyed by the identity of a structure's
        # incidence tensors: the dst-sort + ELL/CSR precompute is paid
        # once per structure (and per padded bucket).
        self._delivery_cache: list = []
        # Measured delivery pairs at contested points, keyed as the
        # layouts are and by message width: [(tensors, width, times)].
        self._delivery_times: list = []
        # The compile-once executable cache (see ``compile``).
        self.exec_cache_size = int(exec_cache_size)
        if exec_cache_bytes is None and self.device.type == "cuda":
            exec_cache_bytes = torch.cuda.get_device_properties(
                self.device).total_memory // 4
        self.exec_cache_bytes = exec_cache_bytes
        self._exec_cache: OrderedDict = OrderedDict()
        self._exec_meta: dict = {}
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_evictions = 0
        self._trace_count = 0
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else default_registry()
        self.metrics.register_provider(
            "engine.exec_cache", weak_provider(self.cache_stats)
        )
        self.fault_injector = fault_injector
        if disk_cache is not None:
            store_device = getattr(disk_cache, "device", self.device)
            if store_device.type != self.device.type:
                raise ValueError(
                    f"disk_cache records {store_device.type} "
                    f"executables; this Engine runs on {self.device.type}"
                )
            # The store's disk.* points fire on this Engine's plan.
            if fault_injector is not None:
                disk_cache.fault_injector = fault_injector
        self.disk_cache = disk_cache
        self._lock = threading.RLock()

    # -- resolution ---------------------------------------------------------

    def _resolve_representation(self, spec, cfg) -> tuple[str, dict]:
        """The JAX package's checks and messages: the clique
        representation executes locally, so a distributed backend or a
        mesh pins bipartite under ``auto`` and is refused under
        ``clique``."""
        if cfg.representation == "bipartite":
            return "bipartite", {"reason": "explicitly configured"}
        touches = getattr(spec, "touches_hyperedge_state", True)
        has_program = getattr(spec, "clique_program", None) is not None
        if cfg.representation == "clique":
            if touches:
                raise ValueError(
                    "representation='clique' is invalid for "
                    f"{getattr(spec, 'name', 'this spec')!r}: clique "
                    "expansion is only legal for algorithms that never "
                    "touch hyperedge state (MESH §IV-A1)"
                )
            if not has_program:
                raise ValueError(
                    "representation='clique' needs a clique_program on "
                    "the AlgorithmSpec"
                )
            if cfg.backend in ("replicated", "sharded"):
                raise ValueError(
                    "representation='clique' executes locally and cannot "
                    f"honor backend={cfg.backend!r}"
                )
            if cfg.max_iters is not None:
                raise ValueError(
                    "max_iters cannot override a clique_program (its "
                    "iteration count is baked into the spec); rebuild "
                    "the spec with the desired iters instead"
                )
            if self.mesh is not None:
                raise ValueError(
                    "representation='clique' executes locally and "
                    "cannot use the supplied mesh; drop the mesh or "
                    "use representation='bipartite'"
                )
            return "clique", {"reason": "explicitly configured"}
        # auto: explicit requests the clique path cannot honor pin
        # bipartite rather than being silently dropped.
        if cfg.backend in ("replicated", "sharded"):
            return "bipartite", {
                "reason": "distributed backend requested; clique "
                "executes locally"
            }
        if self.mesh is not None:
            return "bipartite", {
                "reason": "mesh supplied (distributed intent); clique "
                "executes locally"
            }
        if cfg.max_iters is not None and has_program and not touches:
            return "bipartite", {
                "reason": "max_iters override cannot apply to a "
                "clique_program"
            }
        return select_representation(
            spec, spec.hg0, edge_budget=cfg.clique_edge_budget
        )

    def _resolve_backend(self, spec, cfg) -> tuple[str, Any, dict, dict]:
        """Returns ``(backend, plan_or_None, backend_why,
        partition_why)`` (the JAX package's rules and messages)."""
        if cfg.backend == "local":
            return "local", None, {"reason": "explicitly configured"}, {}

        if self.mesh is None:
            if cfg.backend in ("replicated", "sharded"):
                raise ValueError(
                    f"backend={cfg.backend!r} needs a mesh; construct "
                    "Engine(mesh=...) or use backend='local'"
                )
            return "local", None, {"reason": "no mesh available"}, {}

        from repro_torch.launch.mesh import mesh_size

        n_parts = cfg.n_parts or mesh_size(self.mesh, cfg.axis)
        plan = self.plan
        if plan is None:
            plan, part_why = self._cached_plan(
                spec.hg0, n_parts, cfg.partition_strategy
            )
        else:
            part_why = {"strategy": plan.name,
                        "reason": "plan supplied by caller"}
        if plan.n_parts != n_parts:
            raise ValueError(
                f"plan has {plan.n_parts} partitions but mesh"
                f"[{cfg.axis!r}] = {n_parts}"
            )
        if cfg.backend in ("replicated", "sharded"):
            return (
                cfg.backend, plan,
                {"reason": "explicitly configured"}, part_why,
            )
        backend, why = select_backend(
            plan,
            spec.hg0.n_vertices,
            spec.hg0.n_hyperedges,
            replicated_bias=cfg.replicated_bias,
            v_state_bytes=state_width_bytes(
                spec.hg0.v_attr, spec.hg0.n_vertices
            ),
            he_state_bytes=state_width_bytes(
                spec.hg0.he_attr, spec.hg0.n_hyperedges
            ),
        )
        return backend, plan, why, part_why

    def _cached_plan(self, hg, n_parts: int, strategy: str):
        for c_hg, c_parts, c_strat, c_plan, c_why in self._plan_cache:
            if c_hg is hg and c_parts == n_parts and c_strat == strategy:
                return c_plan, c_why
        plan, why = select_partition(hg, n_parts, strategy)
        self._plan_cache.append((hg, n_parts, strategy, plan, why))
        del self._plan_cache[:-4]  # bound the strong refs we hold
        return plan, why

    def _shard_layouts(self, plan, ctx, shards=None):
        """This rank's fused layout pair over ``plan``'s edge shards
        (``shards``: the shards bucket-padded by the compiled path),
        cached by plan identity and padded sizes."""
        from repro_torch.core.distributed import build_shard_delivery

        key = (ctx.nv_pad, ctx.ne_pad, ctx.rank,
               None if shards is None else int(shards[0].shape[1]))
        for c_plan, c_key, lay in self._shard_cache:
            if c_plan is plan and c_key == key:
                return lay
        src, dst, mask = (shards if shards is not None else
                          (plan.shard_src, plan.shard_dst, plan.shard_mask))
        with maybe_span(
            self.tracer,
            "engine.layout_build" if shards is None else "serve.layout_build",
            cat="compile", n_parts=plan.n_parts, rank=ctx.rank,
            shard_len=int(src.shape[1]),
        ):
            lay = build_shard_delivery(src, dst, mask, ctx.nv_pad,
                                       ctx.ne_pad, parts=(ctx.rank,),
                                       device=self.device)[0]
        self._shard_cache.append((plan, key, lay))
        del self._shard_cache[:-4]  # bound the strong refs we hold
        return lay

    def _rank_shard(self, hg, plan, ctx, delivery: str):
        """This rank's ``plan_rank_shard`` of ``plan`` over ``hg``'s
        structure, cached by the identity of its incidence tensors, the
        plan, the context and the delivery."""
        from repro_torch.core.distributed import plan_rank_shard

        key = (ctx.backend, ctx.rank, ctx.nv_pad, ctx.ne_pad, delivery)
        for c_src, c_mask, c_plan, c_key, shard in self._rank_shard_cache:
            if (c_src is hg.src and c_mask is hg.e_mask and c_plan is plan
                    and c_key == key):
                return shard
        layouts = (self._shard_layouts(plan, ctx)
                   if delivery == "pallas_fused" else None)
        shard = plan_rank_shard(hg, plan, ctx, delivery, layouts)
        self._rank_shard_cache.append((hg.src, hg.e_mask, plan, key, shard))
        del self._rank_shard_cache[:-4]  # bound the strong refs we hold
        return shard

    def _resolve_delivery(self, spec, cfg) -> tuple[str, dict]:
        if cfg.delivery == "xla":
            return "xla", {"reason": "explicitly configured"}
        if cfg.delivery == "pallas_fused":
            reason = _non_monoid_reason(spec)
            if reason is not None:
                raise ValueError(
                    "delivery='pallas_fused' is invalid for "
                    f"{getattr(spec, 'name', 'this spec')!r}: {reason}; "
                    "the fused kernel serves monoid combiners only"
                )
            if spec.hg0.nnz == 0:
                raise ValueError(
                    "delivery='pallas_fused' needs a non-empty incidence"
                )
            return "pallas_fused", {"reason": "explicitly configured"}
        return select_delivery(spec, spec.hg0,
                               measure=self._measure_delivery)

    def _measure_delivery(self, spec, hg) -> tuple[float, float]:
        """``measure_delivery_pair`` over this Engine's layouts of ``hg``,
        once per structure (the identity of its incidence tensors) and
        message width.  With a mesh every rank measures, and every rank
        takes the largest time of each lowering (one ``all_reduce``
        MAX), so that all ranks make one pick: replicated ranks stay
        bitwise equal.  The pair is timed on the whole structure, not on
        a rank's shard."""
        tensors = (hg.src, hg.dst, hg.e_mask)
        width = message_width_bytes(spec.initial_msg)
        for c_tensors, c_width, times in self._delivery_times:
            if c_width == width and all(
                    a is b for a, b in zip(c_tensors, tensors)):
                return times
        times = measure_delivery_pair(spec, hg, self._delivery_layouts(hg))
        if self.mesh is not None:
            both = torch.tensor(times, dtype=torch.float64,
                                device=self.device)
            dist.all_reduce(both, op=dist.ReduceOp.MAX,
                            group=self.mesh.get_group())
            times = tuple(both.tolist())
        self._delivery_times.append((tensors, width, times))
        del self._delivery_times[:-16]  # bound the strong refs we hold
        return times

    def _delivery_layouts(self, hg, padded=None):
        """Both directions' fused layouts for one structure, cached by
        the identity of its incidence tensors (``src``, ``dst``,
        ``e_mask``): a spec's hypergraph and its re-initialized or
        query-bound copies share them.  ``padded``: a bucket-padded copy
        of ``hg`` (the compiled path), whose layouts are built and
        cached under ``hg``'s tensors and the padded sizes."""
        target = hg if padded is None else padded
        tensors = (hg.src, hg.dst, hg.e_mask)
        sizes = (target.n_vertices, target.n_hyperedges, target.nnz)
        for c_tensors, c_sizes, lay in self._delivery_cache:
            if c_sizes == sizes and all(
                    a is b for a, b in zip(c_tensors, tensors)):
                return lay
        # A build for the compiled path is the serving tier's span.
        with maybe_span(
            self.tracer,
            "engine.layout_build" if padded is None else "serve.layout_build",
            cat="compile", nnz=int(target.nnz),
            n_vertices=int(target.n_vertices),
            n_hyperedges=int(target.n_hyperedges),
        ):
            lay = layout_pair(
                target.src, target.dst, target.e_mask, target.n_vertices,
                target.n_hyperedges,
            )
        self._delivery_cache.append((tensors, sizes, lay))
        del self._delivery_cache[:-4]  # bound the strong refs we hold
        return lay

    @_serialized
    def resolve(
        self, spec, **overrides: Any
    ) -> tuple[ExecutionConfig, Any, dict]:
        """Resolve every ``"auto"`` field for ``spec`` WITHOUT executing.

        Returns ``(resolved_config, plan_or_None, decision)`` — the
        design point ``run`` would execute (partition construction does
        run when a plan must be built).
        """
        cfg = (
            dataclasses.replace(self.config, **overrides)
            if overrides
            else self.config
        )
        decision: dict[str, Any] = {}
        representation, rep_why = self._resolve_representation(spec, cfg)
        decision["representation"] = rep_why
        max_iters = (
            cfg.max_iters if cfg.max_iters is not None else spec.max_iters
        )
        if representation == "clique":
            decision["backend"] = {
                "reason": "clique representation executes locally"
            }
            decision["delivery"] = {
                "reason": "clique constant-folding runs a host-side "
                "program; no superstep delivery exists"
            }
            resolved = dataclasses.replace(
                cfg,
                representation="clique",
                backend="local",
                max_iters=max_iters,
                partition_strategy="none",
                delivery="xla",
            )
            return resolved, None, decision
        backend, plan, backend_why, part_why = self._resolve_backend(
            spec, cfg
        )
        decision["backend"] = backend_why
        if part_why:
            decision["partition"] = part_why
        delivery, delivery_why = self._resolve_delivery(spec, cfg)
        decision["delivery"] = delivery_why
        resolved = dataclasses.replace(
            cfg,
            representation="bipartite",
            backend=backend,
            max_iters=max_iters,
            # "none" = this execution partitions nothing (local path);
            # a plan pins its strategy name.
            partition_strategy=(
                plan.name if plan is not None else "none"
            ),
            n_parts=plan.n_parts if plan is not None else cfg.n_parts,
            delivery=delivery,
        )
        return resolved, plan, decision

    def _device_wait(self, sp, device, t1: float) -> float:
        """Wait for the card (a ``torch.cuda.synchronize`` on a CUDA
        ``device``; nothing on the CPU) and return the wait, also
        recorded on the span ``sp`` when tracing."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        if sp is not None:
            sp.args["device_wait_s"] = t2 - t1
        return t2

    @_serialized
    def run(self, spec, **overrides: Any) -> Result:
        """Execute an ``AlgorithmSpec`` at the resolved design point:
        bipartite or clique, local or (every rank calling) distributed.

        ``overrides`` are per-call ``ExecutionConfig`` replacements
        (e.g. ``engine.run(spec, max_iters=8)``).
        """
        hg = spec.hg0
        if hg.device.type != self.device.type:
            raise ValueError(
                f"spec lives on {hg.device}, this Engine runs on "
                f"{self.device}; build the hypergraph with "
                f"device={self.device.type!r}"
            )
        resolved, plan, decision = self.resolve(spec, **overrides)
        name = getattr(spec, "name", "anonymous")

        if resolved.representation == "clique":
            t0 = time.perf_counter()
            with maybe_span(
                self.tracer, "engine.run", cat="execute",
                algorithm=name, representation="clique",
            ) as sp:
                graph = to_graph(hg)
                value = spec.clique_program(graph)
                t1 = time.perf_counter()
                t2 = self._device_wait(sp, hg.device, t1)
            decision = {**decision, "measured": {
                "wall_s": t2 - t0,
                "dispatch_s": t1 - t0,
                "device_wait_s": t2 - t1,
            }}
            return Result(
                value=value,
                config=resolved,
                representation="clique",
                backend="local",
                decision=decision,
            )

        if resolved.backend != "local":
            return self._run_distributed(spec, resolved, plan, decision)
        delivery = (
            self._delivery_layouts(hg)
            if resolved.delivery == "pallas_fused"
            else None
        )
        counters: dict[str, Any] = {}
        t0 = time.perf_counter()
        with maybe_span(
            self.tracer, "engine.run", cat="execute",
            algorithm=name, backend="local", delivery=resolved.delivery,
        ) as sp:
            if resolved.checkpoint_every is not None:
                from repro_torch.faults.checkpoint import checkpointed_compute

                out = checkpointed_compute(
                    hg,
                    resolved.max_iters,
                    spec.initial_msg,
                    spec.v_program,
                    spec.he_program,
                    every=resolved.checkpoint_every,
                    ckpt_dir=resolved.checkpoint_dir,
                    return_stats=resolved.collect_stats,
                    delivery=delivery,
                    tracer=self.tracer,
                    metrics=self.metrics,
                    fault_injector=self.fault_injector,
                    counters=counters,
                )
            else:
                out = compute(
                    hg,
                    max_iters=resolved.max_iters,
                    initial_msg=spec.initial_msg,
                    v_program=spec.v_program,
                    he_program=spec.he_program,
                    return_stats=resolved.collect_stats,
                    delivery=delivery,
                    counters=counters,
                )
            t1 = time.perf_counter()
            t2 = self._device_wait(sp, hg.device, t1)
        stats = None
        if resolved.collect_stats:
            out, stats = out
        measured = self._loop_measured(resolved, counters, t0, t1, t2)
        if delivery is not None:
            measured["delivery"] = delivery_traffic_pair(
                delivery, message_width_bytes(spec.initial_msg)
            )
        decision = {**decision, "measured": measured}
        return Result(
            value=spec.extract(out),
            config=resolved,
            representation="bipartite",
            backend="local",
            superstep_stats=stats,
            decision=decision,
        )

    @staticmethod
    def _loop_measured(resolved, counters, t0, t1, t2) -> dict:
        """``measured`` of a superstep run: times and ``counters``."""
        pairs = counters["pairs_run"]
        measured = {
            "wall_s": t2 - t0,
            "dispatch_s": t1 - t0,
            "device_wait_s": t2 - t1,
            "max_iters": resolved.max_iters,
            # Pairs that did real work: the halting pair reports zero
            # activity and is not counted (the JAX package's
            # ``executed_supersteps`` rule).
            "supersteps": pairs - 1 if counters["halted"] and pairs else pairs,
            "pairs_run": pairs,
            "host_syncs": counters["host_syncs"],
        }
        if "resumed_from" in counters:
            # A checkpointed run counts the pairs it ran itself, after
            # the snapshot it resumed from.
            measured["resumed_from"] = counters["resumed_from"]
        return measured

    def _run_distributed(self, spec, resolved, plan, decision) -> Result:
        """``run`` on the ``replicated`` / ``sharded`` backends: this
        rank's part of ``distributed_compute`` (or its checkpointed
        form), the whole result on every rank."""
        from repro_torch.core.distributed import (
            DistContext,
            distributed_compute,
        )

        hg = spec.hg0
        ctx = DistContext.for_mesh(self.mesh, resolved.axis, hg.n_vertices,
                                   hg.n_hyperedges, resolved.backend)
        shard = self._rank_shard(hg, plan, ctx, resolved.delivery)
        counters: dict[str, Any] = {}
        kw = dict(axis=resolved.axis, backend=resolved.backend,
                  return_stats=resolved.collect_stats,
                  delivery=resolved.delivery, shard=shard,
                  counters=counters)
        t0 = time.perf_counter()
        with maybe_span(
            self.tracer, "engine.run", cat="execute",
            algorithm=getattr(spec, "name", "anonymous"),
            backend=resolved.backend, delivery=resolved.delivery,
            n_parts=plan.n_parts,
        ) as sp:
            if resolved.checkpoint_every is not None:
                from repro_torch.faults.checkpoint import (
                    checkpointed_distributed_compute,
                )

                out = checkpointed_distributed_compute(
                    hg, plan, self.mesh, resolved.max_iters,
                    spec.initial_msg, spec.v_program, spec.he_program,
                    every=resolved.checkpoint_every,
                    ckpt_dir=resolved.checkpoint_dir, tracer=self.tracer,
                    metrics=self.metrics,
                    fault_injector=self.fault_injector, **kw,
                )
            else:
                out = distributed_compute(
                    hg, plan, self.mesh, resolved.max_iters,
                    spec.initial_msg, spec.v_program, spec.he_program, **kw,
                )
            t1 = time.perf_counter()
            t2 = self._device_wait(sp, hg.device, t1)
        stats = None
        if resolved.collect_stats:
            out, stats = out
        # No measured delivery bytes, as in the JAX package: a rank's
        # layouts price its own shard only.
        measured = self._loop_measured(resolved, counters, t0, t1, t2)
        return Result(
            value=spec.extract(out),
            config=resolved,
            representation="bipartite",
            backend=resolved.backend,
            partition=plan.name,
            partition_stats=plan.stats,
            superstep_stats=stats,
            decision={**decision, "measured": measured},
        )

    def submit(self, spec, **overrides: Any):
        """The unified entry point: dispatch on spec type.

        ``AlgorithmSpec`` -> iterative superstep execution (``run``),
        ``AnalyticsSpec`` -> batch analytics (``analyze``).
        """
        if isinstance(spec, AnalyticsSpec):
            return self.analyze(spec, **overrides)
        from repro_torch.algorithms.spec import AlgorithmSpec

        if isinstance(spec, AlgorithmSpec):
            return self.run(spec, **overrides)
        raise TypeError(
            "Engine.submit takes an AlgorithmSpec or AnalyticsSpec, got "
            f"{type(spec).__name__}"
        )

    # -- compile-once serve-many --------------------------------------------

    @_serialized
    def compile(self, spec, **overrides: Any):
        """Resolve the design point ONCE and return a ``CompiledAlgorithm``.

        The serve-many half of the facade: the returned handle's
        ``run(hg)`` serves any hypergraph in the same shape bucket
        (sizes padded to bounded power-of-two buckets; executables
        cached in this Engine's LRU), and ``run_batch(queries)`` serves
        B requests along the spec's query axis
        (``AlgorithmSpec.bind_query``) through one batched executable.

        >>> compiled = engine.compile(shortest_paths_spec(hg, 0))
        >>> compiled.run_batch(np.arange(8))      # 8 sources, 1 build
        >>> engine.cache_stats()                   # hits/misses/traces

        On the card an executable replays a CUDA graph of one superstep
        pair (the counterpart of the JAX package's always-jitted
        compiled execution), and a failure there raises: the handle's
        ``xla`` twin serves only CPU requests.  Compiled execution is
        always bipartite
        (the clique representation has no executable to cache).
        ``overrides`` are per-compile ``ExecutionConfig`` replacements,
        as for ``run``.
        """
        from repro_torch.core.serving import CompiledAlgorithm

        if isinstance(spec, AnalyticsSpec):
            raise TypeError(
                "Engine.compile serves iterative AlgorithmSpecs; batch "
                "analytics runs one-shot through Engine.analyze/submit"
            )
        probe = (
            dataclasses.replace(self.config, **overrides)
            if overrides
            else self.config
        )
        if probe.representation == "clique":
            raise ValueError(
                "Engine.compile serves the bipartite representation only: "
                "the clique path runs a host-side clique_program with no "
                "executable to cache; use Engine.run for one-shot clique "
                "execution"
            )
        if spec.hg0.device.type != self.device.type:
            raise ValueError(
                f"spec lives on {spec.hg0.device}, this Engine runs on "
                f"{self.device}; build the hypergraph with "
                f"device={self.device.type!r}"
            )
        overrides = {**overrides, "representation": "bipartite"}
        resolved, plan, decision = self.resolve(spec, **overrides)
        return CompiledAlgorithm(
            engine=self,
            spec=spec,
            config=resolved,
            decision=decision,
            _plan0=plan,
        )

    def cache_stats(self) -> dict:
        """Executable-cache observability.

        ``traces`` counts executables made ready: CUDA-graph captures on
        the card, executable builds on the CPU (a new trace on a warm
        cache is a bug the serving tests assert against);
        ``hits``/``misses`` count ``CompiledAlgorithm`` lookups in this
        Engine's LRU; ``evictions`` counts LRU drops, by either limit:
        ``capacity`` entries or ``capacity_bytes`` bytes (``None``: no
        byte bound); ``bytes`` is what the live entries hold;
        ``entry_shapes`` describes each live entry's bucket (algorithm,
        padded dims, batch bucket, design point) and its ``bytes``;
        ``disk`` mirrors the attached store's counters (``None``
        without one).
        """
        cache = self._exec_cache
        return {
            "entries": len(cache),
            "capacity": self.exec_cache_size,
            "capacity_bytes": self.exec_cache_bytes,
            "bytes": sum(exe.nbytes for exe in cache.values()),
            "hits": self._cache_hits,
            "misses": self._cache_misses,
            "evictions": self._cache_evictions,
            "traces": self._trace_count,
            "entry_shapes": [
                {**self._exec_meta.get(key, {}), "bytes": exe.nbytes}
                for key, exe in cache.items()
            ],
            "disk": (
                self.disk_cache.stats()
                if self.disk_cache is not None
                else None
            ),
        }

    def _note_trace(self) -> None:
        """One executable made ready (a capture, or a CPU build)."""
        self._trace_count += 1

    def _executable_for(self, key, build: Callable[[], Any], meta=None):
        """LRU lookup of a compiled executable by shape signature.

        ``meta``: a small human-readable bucket summary recorded per
        entry for ``cache_stats()["entry_shapes"]``."""
        cache = self._exec_cache
        if key in cache:
            cache.move_to_end(key)
            self._cache_hits += 1
            return cache[key]
        self._cache_misses += 1
        if self.tracer is None:
            exe = build()
        else:
            span_args = {
                k: v
                for k, v in (meta or {}).items()
                if isinstance(v, (str, int, float, bool))
            }
            with self.tracer.span(
                "engine.build_executable", cat="compile", **span_args
            ):
                exe = build()
        if self.disk_cache is not None:
            exe = self.disk_cache.wrap(self, key, exe)
        cache[key] = exe
        if meta is not None:
            self._exec_meta[key] = meta
        while len(cache) > self.exec_cache_size:
            self._evict_oldest()
        return exe

    def _fit_exec_cache(self) -> None:
        """Evict least-recently-used entries until the live ones hold
        at most ``exec_cache_bytes`` (the newest entry always stays);
        called once a new entry's size is known."""
        cache, limit = self._exec_cache, self.exec_cache_bytes
        if limit is None:
            return
        while (len(cache) > 1
               and sum(exe.nbytes for exe in cache.values()) > limit):
            self._evict_oldest()

    def _evict_oldest(self) -> None:
        self._discard_executable(next(iter(self._exec_cache)))
        self._cache_evictions += 1

    def _discard_executable(self, key) -> None:
        """Drop one entry and release what it holds (an eviction, or a
        build that failed before it was ready)."""
        exe = self._exec_cache.pop(key, None)
        self._exec_meta.pop(key, None)
        if exe is not None:
            exe.release()

    # -- batch analytics -----------------------------------------------------

    def _resolve_analytics(
        self, spec: AnalyticsSpec, cfg: ExecutionConfig, n_pairs: int
    ) -> tuple[ExecutionConfig, str | None, dict]:
        """Resolve the batch design point given the overlap-pair count
        (the JAX package's cost models, numbers and reasons).

        Returns ``(resolved_config, mode, decision)``: representation
        weighs the dual clique expansion against the incidence via
        ``clique_edge_budget``; the kernel axis is
        ``select_intersect_kernel``; the backend tiles pair blocks
        across the mesh when one is available.
        """
        from repro_torch.motifs import select_intersect_kernel

        decision: dict[str, Any] = {}

        if cfg.intersect_kernel == "auto":
            kernel, kernel_why = select_intersect_kernel(spec.hg)
        else:
            kernel = cfg.intersect_kernel
            kernel_why = {"reason": "explicitly configured"}
        decision["kernel"] = kernel_why

        if cfg.representation == "auto":
            # The paper's §IV-A tradeoff, applied to the *dual*: clique
            # expansion of the dual materializes every pairwise
            # intersection; choose it only while the expansion stays
            # within the same edge budget the iterative path uses.
            dual_edges = 2 * n_pairs
            budget = cfg.clique_edge_budget * max(spec.hg.nnz, 1)
            representation = "clique" if dual_edges <= budget else "bipartite"
            decision["representation"] = {
                "dual_clique_edges": dual_edges,
                "bipartite_edges": int(spec.hg.nnz),
                "edge_budget": float(budget),
                "reason": (
                    "dual expansion within edge budget: materialize "
                    "pair intersections"
                    if representation == "clique"
                    else "dual expansion exceeds edge budget: derive "
                    "intersections from the incidence"
                ),
            }
        else:
            representation = cfg.representation
            decision["representation"] = {"reason": "explicitly configured"}

        if cfg.backend == "replicated":
            raise ValueError(
                "backend='replicated' does not apply to batch analytics "
                "(no replicated superstep state); use 'sharded' to tile "
                "pair blocks across the mesh, or 'local'"
            )
        if cfg.backend == "sharded" and self.mesh is None:
            raise ValueError(
                "backend='sharded' needs a mesh; construct "
                "Engine(mesh=...) or use backend='local'"
            )
        if cfg.backend in ("local", "sharded"):
            backend = cfg.backend
            decision["backend"] = {"reason": "explicitly configured"}
        elif self.mesh is not None:
            backend = "sharded"
            decision["backend"] = {
                "reason": "mesh available: tile hyperedge-pair blocks "
                "across it"
            }
        else:
            backend = "local"
            decision["backend"] = {"reason": "no mesh available"}

        mode: str | None = None
        if spec.task == "hmotif_census":
            enumerable = spec.hg.n_hyperedges < (1 << 21)
            if spec.mode != "auto":
                mode = spec.mode
                decision["mode"] = {"reason": "explicitly configured"}
            else:
                mode = (
                    "exact"
                    if enumerable and n_pairs <= spec.exact_pair_budget
                    else "sample"
                )
                decision["mode"] = {
                    "n_overlap_pairs": n_pairs,
                    "exact_pair_budget": spec.exact_pair_budget,
                    "reason": (
                        "overlap graph within exact budget"
                        if mode == "exact"
                        else "overlap graph too large: sample linked pairs"
                    ),
                }
            if mode == "exact" and not enumerable:
                raise ValueError(
                    "mode='exact' needs n_hyperedges < 2^21; use "
                    "mode='sample'"
                )

        resolved = dataclasses.replace(
            cfg,
            representation=representation,
            backend=backend,
            intersect_kernel=kernel,
            partition_strategy="none",
        )
        return resolved, mode, decision

    @_serialized
    def resolve_analytics(
        self, spec: AnalyticsSpec, **overrides: Any
    ) -> tuple[ExecutionConfig, str | None, dict]:
        """Resolve every ``"auto"`` analytics choice WITHOUT executing.

        Runs the host-side overlap-pair discovery (the quantity every
        cost term turns on) but no intersection kernels.
        """
        from repro_torch.motifs import overlap_pairs_with_counts

        cfg = (
            dataclasses.replace(self.config, **overrides)
            if overrides
            else self.config
        )
        pairs, _ = overlap_pairs_with_counts(spec.hg)
        return self._resolve_analytics(spec, cfg, len(pairs))

    @_serialized
    def analyze(
        self, spec: AnalyticsSpec, **overrides: Any
    ) -> AnalyticsResult:
        """Execute a batch ``AnalyticsSpec`` at the configured design
        point — the batch-mode twin of ``run``.

        >>> res = Engine().analyze(AnalyticsSpec(hg))
        >>> res.value.counts, res.kernel, res.decision["measured"]
        """
        from repro_torch import motifs

        if not isinstance(spec, AnalyticsSpec):
            raise TypeError(
                "Engine.analyze takes an AnalyticsSpec, got "
                f"{type(spec).__name__}"
            )
        hg = spec.hg
        if hg.device.type != self.device.type:
            raise ValueError(
                f"spec lives on {hg.device}, this Engine runs on "
                f"{self.device}; build the hypergraph with "
                f"device={self.device.type!r}"
            )
        cfg = (
            dataclasses.replace(self.config, **overrides)
            if overrides
            else self.config
        )
        t_start = time.perf_counter()
        # Overlap-pair discovery is the O(sum deg^2) host-side
        # preprocessing step; skip it when nothing consumes it — an
        # explicit pair batch on a pinned bipartite representation
        # needs only the kernel.
        need_pairs = (
            spec.task == "hmotif_census"
            or spec.pairs is None
            or cfg.representation in ("auto", "clique")
        )
        pairs = n_shared = None
        if need_pairs:
            pairs, n_shared = motifs.overlap_pairs_with_counts(hg)
        resolved, mode, decision = self._resolve_analytics(
            spec, cfg, len(pairs) if pairs is not None else 0
        )
        index = motifs.build_index(hg, resolved.intersect_kernel)
        mesh = self.mesh if resolved.backend == "sharded" else None
        pair_sizes = (
            motifs.materialize_pair_sizes(hg, pairs, n_shared)
            if resolved.representation == "clique"
            else None
        )
        og = (
            motifs.build_overlap_graph(hg, pairs)
            if spec.task == "hmotif_census"
            else None
        )
        timings: dict[str, Any] = {
            "preprocess_s": time.perf_counter() - t_start,
            "intersect_s": 0.0, "intersect_calls": 0, "classify_s": 0.0,
        }

        if spec.task == "pair_intersections":
            if spec.pairs is not None:
                ea = np.asarray(spec.pairs[0], np.int64)
                eb = np.asarray(spec.pairs[1], np.int64)
            else:
                ea, eb = pairs[:, 0], pairs[:, 1]
            if pair_sizes is not None:
                t0 = time.perf_counter()
                e = np.int64(hg.n_hyperedges)
                lo, hi = np.minimum(ea, eb), np.maximum(ea, eb)
                sizes = motifs.pair_sizes_lookup(pair_sizes, lo * e + hi)
                # The materialized table holds overlapping a < b pairs
                # only; |e ∩ e| = |e| must not fall through to 0.
                self_pair = ea == eb
                if self_pair.any():
                    sizes = np.where(
                        self_pair, index.cardinalities()[ea], sizes
                    )
                timings["classify_s"] += time.perf_counter() - t0
            else:
                sizes = motifs.batch_intersections(
                    index, ea, eb, tile=spec.tile, mesh=mesh,
                    axis=resolved.axis, timings=timings,
                ).astype(np.int64)
            value: Any = (np.stack([ea, eb], axis=1), sizes)
        elif mode == "exact":
            value = motifs.exact_census(
                hg, index=index, tile=spec.tile, mesh=mesh,
                axis=resolved.axis,
                pair_sizes=pair_sizes, og=og, timings=timings,
            )
        else:
            value = motifs.sampled_census(
                hg, spec.n_samples, seed=spec.seed,
                confidence=spec.confidence, index=index, tile=spec.tile,
                mesh=mesh, axis=resolved.axis, og=og, pair_sizes=pair_sizes,
                timings=timings,
            )
        decision = {**decision, "measured": {
            "wall_s": time.perf_counter() - t_start, **timings,
        }}
        return AnalyticsResult(
            value=value,
            config=resolved,
            representation=resolved.representation,
            kernel=resolved.intersect_kernel,
            backend=resolved.backend,
            mode=mode,
            decision=decision,
        )

    @_serialized
    def explain(self, spec, hg=None, **overrides: Any) -> dict:
        """The full decision tree for every ``auto`` axis — inputs,
        per-candidate predicted costs, winner, reason — WITHOUT
        executing (no layout build, no capture, no kernel).

        Built directly on ``resolve`` (the same call ``run`` and
        ``compile`` make), so the winners here are by construction the
        axes an execution of the same inputs resolves.  On top of the
        winner, every axis reports the costs of the candidates it did
        NOT pick.  The backend and partition axes take the JAX
        package's two forms: without a plan (local execution) and with
        one (each backend's and each strategy's predicted sync bytes).
        On the card the delivery axis reports ``lowering: "cuda"`` and
        the card's term's inputs.

        ``hg``: explain against this hypergraph instead of the spec's
        own (applies ``spec.init`` like ``CompiledAlgorithm.run(hg)``).
        ``AnalyticsSpec`` routes to the batch axes (kernel /
        representation / backend / mode).  Returns::

            {"config": resolved ExecutionConfig,
             "decision": the resolve() decision dict,
             "axes": {axis: {"winner", "reason", "inputs",
                             "candidates": {name: {...costs}}}}}
        """
        if isinstance(spec, AnalyticsSpec):
            return self._explain_analytics(spec, **overrides)
        if hg is not None:
            hg = spec.init(hg) if spec.init is not None else hg
            spec = spec._replace(hg0=hg)
        resolved, plan, decision = self.resolve(spec, **overrides)
        cfg = (
            dataclasses.replace(self.config, **overrides)
            if overrides
            else self.config
        )
        hg0 = spec.hg0
        axes: dict[str, Any] = {}

        # -- representation: bipartite vs clique constant-folding ------
        touches = getattr(spec, "touches_hyperedge_state", True)
        has_program = getattr(spec, "clique_program", None) is not None
        eligible = (not touches) and has_program
        clique_edges = (
            int(2 * clique_expansion_size(hg0)) if eligible else None
        )
        axes["representation"] = {
            "winner": resolved.representation,
            "reason": decision["representation"].get("reason"),
            "inputs": {
                "touches_hyperedge_state": touches,
                "has_clique_program": has_program,
                "nnz": int(hg0.nnz),
            },
            "candidates": {
                "bipartite": {
                    "eligible": True,
                    "predicted_cost_edges": int(hg0.nnz),
                },
                "clique": {
                    "eligible": eligible,
                    "predicted_cost_edges": clique_edges,
                    "edge_budget": float(
                        cfg.clique_edge_budget * max(hg0.nnz, 1)
                    ),
                },
            },
        }

        axes["backend"], axes["partition"] = self._explain_partitioning(
            resolved, plan, decision, cfg, hg0)

        # -- delivery: reference vs fused HBM-traffic model ------------
        # Run the cost model even when the axis was pinned or gated, so
        # the non-winning candidate's predicted cost is always visible.
        gate = _non_monoid_reason(spec)
        _, dwhy = select_delivery(spec, hg0, measure=self._measure_delivery)
        width = dwhy.get(
            "message_width_bytes", message_width_bytes(spec.initial_msg)
        )
        nnz = dwhy.get("nnz", int(hg0.nnz))
        ref_bytes = reference_traffic(
            nnz, hg0.n_hyperedges, width
        ) + reference_traffic(nnz, hg0.n_vertices, width)
        fused_cand: dict[str, Any] = {
            "eligible": gate is None and nnz > 0,
            "gate": gate,
        }
        for k in (
            "class_work_slots", "class_weighted_work",
            "single_ell_weighted_work", "skew_gain", "work_budget",
            "residual", "class_plans",
        ):
            if k in dwhy:
                fused_cand[k] = dwhy[k]
        if "class_work_slots" in dwhy:
            # Predicted fused HBM bytes from the class plan's work
            # slots — the same (width + id) per slot + output model
            # obs.calibrate prices a BUILT layout with.
            fused_cand["predicted_hbm_bytes"] = (
                dwhy["class_work_slots"] * (width + 4.0)
                + (hg0.n_vertices + hg0.n_hyperedges) * width
            )
        inputs = {
            "nnz": nnz,
            "message_width_bytes": width,
            "width_budget": FUSED_MAX_WIDTH_BYTES,
            "min_nnz": FUSED_MIN_NNZ,
            "lowering": dwhy.get("lowering"),
        }
        if dwhy.get("lowering") == "cuda":
            # The card's term replaces the CPU's budgets.
            inputs.update(width_budget=None, min_nnz=H100_FUSED_MIN_NNZ)
        axes["delivery"] = {
            "winner": resolved.delivery,
            "reason": decision["delivery"].get("reason"),
            "inputs": inputs,
            "candidates": {
                "xla": {
                    "eligible": True,
                    "predicted_hbm_bytes": ref_bytes,
                },
                "pallas_fused": fused_cand,
            },
        }

        return {"config": resolved, "decision": decision, "axes": axes}

    def _explain_partitioning(self, resolved, plan, decision, cfg,
                              hg0) -> tuple[dict, dict]:
        """``explain``'s backend and partition axes (the JAX package's
        keys: its ``plan is None`` form, or each backend's and each
        strategy's predicted sync bytes)."""
        if plan is None:
            backend = {
                "winner": resolved.backend,
                "reason": decision["backend"].get("reason"),
                "inputs": {"mesh": self.mesh is not None},
                "candidates": {
                    "local": {"eligible": True, "predicted_sync_bytes": 0.0},
                    "replicated": {"eligible": self.mesh is not None},
                    "sharded": {"eligible": self.mesh is not None},
                },
            }
            partition = {
                "winner": resolved.partition_strategy,
                "reason": "local execution partitions nothing",
                "inputs": {},
                "candidates": {},
            }
            return backend, partition
        v_w = state_width_bytes(hg0.v_attr, hg0.n_vertices)
        he_w = state_width_bytes(hg0.he_attr, hg0.n_hyperedges)
        _, bwhy = select_backend(
            plan, hg0.n_vertices, hg0.n_hyperedges,
            replicated_bias=cfg.replicated_bias,
            v_state_bytes=v_w, he_state_bytes=he_w,
        )
        backend = {
            "winner": resolved.backend,
            "reason": decision["backend"].get("reason"),
            "inputs": {
                "n_parts": bwhy["n_parts"],
                "v_state_bytes": v_w,
                "he_state_bytes": he_w,
                "replicated_bias": cfg.replicated_bias,
            },
            "candidates": {
                "replicated": {
                    "eligible": True,
                    "predicted_sync_bytes": bwhy[
                        "full_replication_sync_bytes"
                    ],
                    "bias_adjusted_bytes": (
                        cfg.replicated_bias
                        * bwhy["full_replication_sync_bytes"]
                    ),
                },
                "sharded": {
                    "eligible": True,
                    "predicted_sync_bytes": bwhy["sharded_sync_bytes"],
                },
            },
        }
        part_why = decision.get("partition", {})
        costs = part_why.get("sync_bytes_by_strategy")
        if costs is None:
            # pinned strategy / caller-supplied plan: the sweep was
            # skipped — report the one plan actually in play.
            costs = {plan.name: float(plan.stats.sync_bytes_per_dim)}
        partition = {
            "winner": resolved.partition_strategy,
            "reason": part_why.get("reason"),
            "inputs": {"n_parts": plan.n_parts},
            "candidates": {
                nm: {
                    "eligible": True,
                    "predicted_sync_bytes_per_dim": float(c),
                }
                for nm, c in costs.items()
            },
        }
        return backend, partition

    def _explain_analytics(self, spec: AnalyticsSpec, **overrides) -> dict:
        """``explain`` for the batch axes: intersect kernel,
        (dual) representation, backend, census mode."""
        from repro_torch.motifs import (
            overlap_pairs_with_counts,
            select_intersect_kernel,
        )

        cfg = (
            dataclasses.replace(self.config, **overrides)
            if overrides
            else self.config
        )
        pairs, _ = overlap_pairs_with_counts(spec.hg)
        n_pairs = len(pairs)
        resolved, mode, decision = self._resolve_analytics(
            spec, cfg, n_pairs
        )
        _, kwhy = select_intersect_kernel(spec.hg)
        axes: dict[str, Any] = {
            "kernel": {
                "winner": resolved.intersect_kernel,
                "reason": decision["kernel"].get("reason"),
                "inputs": {
                    "n_hyperedges": int(spec.hg.n_hyperedges),
                    "n_vertices": int(spec.hg.n_vertices),
                },
                "candidates": {
                    "bitset": {
                        "eligible": (
                            kwhy["bitset_index_bytes"]
                            <= kwhy["bitset_budget_bytes"]
                        ),
                        "predicted_ops_per_pair": kwhy[
                            "bitset_words_per_pair"
                        ],
                        "index_bytes": kwhy["bitset_index_bytes"],
                    },
                    "merge": {
                        "eligible": True,
                        "predicted_ops_per_pair": kwhy[
                            "merge_ops_per_pair"
                        ],
                    },
                },
            },
            "representation": {
                "winner": resolved.representation,
                "reason": decision["representation"].get("reason"),
                "inputs": {"n_overlap_pairs": n_pairs},
                "candidates": {
                    "bipartite": {
                        "eligible": True,
                        "predicted_cost_edges": int(spec.hg.nnz),
                    },
                    "clique": {
                        "eligible": True,
                        "predicted_cost_edges": 2 * n_pairs,
                        "edge_budget": float(
                            cfg.clique_edge_budget * max(spec.hg.nnz, 1)
                        ),
                    },
                },
            },
            "backend": {
                "winner": resolved.backend,
                "reason": decision["backend"].get("reason"),
                "inputs": {"mesh": self.mesh is not None},
                "candidates": {
                    "local": {"eligible": True},
                    "sharded": {"eligible": self.mesh is not None},
                },
            },
        }
        if mode is not None:
            axes["mode"] = {
                "winner": mode,
                "reason": decision.get("mode", {}).get("reason"),
                "inputs": {
                    "n_overlap_pairs": n_pairs,
                    "exact_pair_budget": spec.exact_pair_budget,
                },
                "candidates": {
                    "exact": {
                        "eligible": spec.hg.n_hyperedges < (1 << 21),
                        "predicted_pairs": n_pairs,
                    },
                    "sample": {
                        "eligible": True,
                        "predicted_pairs": int(spec.n_samples),
                    },
                },
            }
        return {
            "config": resolved,
            "decision": decision,
            "mode": mode,
            "axes": axes,
        }
