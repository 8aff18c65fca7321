"""One API, many design points: the ``Engine`` facade, in PyTorch.

The port runs the local backend.  ``Engine(...).run(spec)`` takes an
``AlgorithmSpec``: it resolves the representation (the bipartite
incidence, or the clique expansion's constant folding for specs that
never touch hyperedge state, ``select_representation``) and, on the
bipartite representation, the ``delivery`` axis (reference
gather/mask/segment path vs the fused degree-class layout, which on the
card runs the hand-written CUDA kernel, ``select_delivery``), then
executes the superstep loop of ``repro_torch.core.engine`` or the
spec's ``clique_program`` over ``to_graph``.  The chosen design point
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
JAX package's cost models, and returns an ``AnalyticsResult``.
``submit`` dispatches on the spec's type.

Design axes this slice does not port raise ``NotImplementedError``
naming their ROADMAP.md item; none is silently ignored.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.core.api import tree_leaves
from repro_torch.core.clique import clique_expansion_size, to_graph
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import compute
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"{item})"
    )


_DISTRIBUTED = "item 10: core/distributed.py"
_CHECKPOINT = "item 8's fault half: faults/checkpoint.py"
_FAULTS = "item 8's fault half: faults/inject.py and faults/plan.py"
_DISK_CACHE = "item 9: serve/cache.py"


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Every design choice from the paper, in one place (the JAX
    package's fields; see ``repro.core.executor.ExecutionConfig``).

    Values of axes that the port does not run yet raise
    ``NotImplementedError``: a ``replicated`` or ``sharded`` backend
    and ``checkpoint_every``.  ``representation='clique'`` constant-folds
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
        if self.backend in ("replicated", "sharded"):
            raise _not_ported(f"backend={self.backend!r}", _DISTRIBUTED)
        if self.checkpoint_every is not None:
            raise _not_ported("checkpoint_every", _CHECKPOINT)


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
    ``max_iters``, ``supersteps``, ``pairs_run``, ``host_syncs``; on
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
      backend: ``local``.
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


# The CPU (ELL) cost model's budgets: the JAX package's constants,
# measured there on CPU XLA.
FUSED_MAX_WIDTH_BYTES = 64.0    # per-entity message bytes
FUSED_ELL_WORK_BUDGET = 4.0     # padded ELL slots per real incidence
FUSED_MIN_NNZ = 4096
# The card's term, measured: one delivery pair (v->he + he->v, float32
# sum) through the xla lowering and the fused K1 leaf on one H100 (700
# W), over DBLP at 5,660 to 2,838,951 incidences and 4 to 256 bytes a
# row (``chip_smoke.py`` phase 10; PERF.md §6).  K1 won at every width
# and size: 1.9-10.1x up to 64-byte rows, 1.14-1.43x at 256 bytes, where
# the two smallest sizes are launch-bound (K1 0.22-0.27 ms a pair,
# xla's host dispatch of ~20 launches 0.25-0.33).  So the card has no
# width bound, and its nnz floor is the smallest size measured: below
# it, unmeasured, auto keeps the reference lowering.
H100_FUSED_MIN_NNZ = 5_660


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


def select_delivery(spec, hg: HyperGraph) -> tuple[str, dict]:
    """Fused vs reference delivery for one spec.

    Hard gates first: custom ``reducer``s / ``edge_transform`` (which
    consume materialized per-incidence rows) and empty structures take
    ``xla``.  Then per lowering:

    * ``ell`` (CPU): the JAX package's ELL cost model, unchanged — fused
      while the degree-class padding stays within
      ``FUSED_ELL_WORK_BUDGET`` slots per incidence and the message row
      within ``FUSED_MAX_WIDTH_BYTES``.
    * ``cuda``: the card's measured term — fused from
      ``H100_FUSED_MIN_NNZ`` live incidences up, at any message width
      (the fused kernel won at every width and size measured).
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
        if nnz < H100_FUSED_MIN_NNZ:
            why["reason"] = (
                f"incidence below the smallest measured on the card ({nnz} "
                f"< {H100_FUSED_MIN_NNZ}): the reference lowering"
            )
            return "xla", why
        why["reason"] = (
            "monoid path on the card: the fused CUDA kernel measured "
            f"faster at every width and size from {H100_FUSED_MIN_NNZ} "
            "incidences (1.14-10.1x; no crossover up to 256-byte rows and "
            "2.84 M incidences)"
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
    ``plan``, ``mesh``, ``disk_cache`` and ``fault_injector`` belong to
    slices not ported yet and raise when given.
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
        if plan is not None or mesh is not None:
            raise _not_ported("a partition plan or mesh", _DISTRIBUTED)
        if disk_cache is not None:
            raise _not_ported("disk_cache", _DISK_CACHE)
        if fault_injector is not None:
            raise _not_ported("fault_injector", _FAULTS)
        cfg = config if config is not None else ExecutionConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.device = resolve_device(device)
        self.config = cfg
        self.plan = self.mesh = None  # the distributed backends' slots
        # Fused-delivery layouts, keyed by the identity of a structure's
        # incidence tensors: the dst-sort + ELL/CSR precompute is paid
        # once per structure (and per padded bucket).
        self._delivery_cache: list = []
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

    # -- resolution ---------------------------------------------------------

    def _resolve_representation(self, spec, cfg) -> tuple[str, dict]:
        """The JAX package's checks and messages.  Its distributed
        branches (a ``replicated``/``sharded`` backend, a mesh) cannot
        be reached here: ``ExecutionConfig`` refuses those backends and
        ``Engine(mesh=)`` raises, both with ``NotImplementedError``
        (ROADMAP.md queue 1, item 10).  They are kept so that the
        clique rules stay whole when that item lands."""
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
            if cfg.backend in ("replicated", "sharded"):  # unreachable
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
            if self.mesh is not None:  # unreachable
                raise ValueError(
                    "representation='clique' executes locally and "
                    "cannot use the supplied mesh; drop the mesh or "
                    "use representation='bipartite'"
                )
            return "clique", {"reason": "explicitly configured"}
        # auto: explicit requests the clique path cannot honor pin
        # bipartite rather than being silently dropped.
        if cfg.backend in ("replicated", "sharded"):  # unreachable
            return "bipartite", {
                "reason": "distributed backend requested; clique "
                "executes locally"
            }
        if self.mesh is not None:  # unreachable
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
        return select_delivery(spec, spec.hg0)

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

    def resolve(
        self, spec, **overrides: Any
    ) -> tuple[ExecutionConfig, Any, dict]:
        """Resolve every ``"auto"`` field for ``spec`` WITHOUT executing.

        Returns ``(resolved_config, None, decision)`` — the design point
        ``run`` would execute (the ``None`` is the partition plan slot
        of the JAX package, always empty on the local backend).
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
        # ExecutionConfig already refused "replicated" and "sharded".
        decision["backend"] = (
            {"reason": "explicitly configured"}
            if cfg.backend == "local"
            else {"reason": "no mesh available"}
        )
        delivery, delivery_why = self._resolve_delivery(spec, cfg)
        decision["delivery"] = delivery_why
        resolved = dataclasses.replace(
            cfg,
            representation="bipartite",
            backend="local",
            max_iters=max_iters,
            partition_strategy="none",
            delivery=delivery,
        )
        return resolved, None, decision

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

    def run(self, spec, **overrides: Any) -> Result:
        """Execute an ``AlgorithmSpec`` on the local backend, bipartite
        or clique.

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
        resolved, _, decision = self.resolve(spec, **overrides)
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
        pairs = counters["pairs_run"]
        measured = {
            "wall_s": t2 - t0,
            "dispatch_s": t1 - t0,
            "device_wait_s": t2 - t1,
            "max_iters": resolved.max_iters,
            # Pairs that did real work: the halting pair reports zero
            # activity and is not counted (the JAX package's
            # ``executed_supersteps`` rule).
            "supersteps": pairs - 1 if counters["halted"] else pairs,
            "pairs_run": pairs,
            "host_syncs": counters["host_syncs"],
        }
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
        resolved, _, decision = self.resolve(spec, **overrides)
        return CompiledAlgorithm(
            engine=self,
            spec=spec,
            config=resolved,
            decision=decision,
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
        ``disk`` is ``None`` (the persistent store, ROADMAP.md item 9,
        is not ported).
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
            "disk": None,
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
        ``select_intersect_kernel``; the backend is local (the sharded
        one is not ported).
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

        # ExecutionConfig already refused "replicated" and "sharded".
        decision["backend"] = (
            {"reason": "explicitly configured"}
            if cfg.backend == "local"
            else {"reason": "no mesh available"}
        )

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
            backend="local",
            intersect_kernel=kernel,
            partition_strategy="none",
        )
        return resolved, mode, decision

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
                    index, ea, eb, tile=spec.tile, axis=resolved.axis,
                    timings=timings,
                ).astype(np.int64)
            value: Any = (np.stack([ea, eb], axis=1), sizes)
        elif mode == "exact":
            value = motifs.exact_census(
                hg, index=index, tile=spec.tile, axis=resolved.axis,
                pair_sizes=pair_sizes, og=og, timings=timings,
            )
        else:
            value = motifs.sampled_census(
                hg, spec.n_samples, seed=spec.seed,
                confidence=spec.confidence, index=index, tile=spec.tile,
                axis=resolved.axis, og=og, pair_sizes=pair_sizes,
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

    def explain(self, spec, hg=None, **overrides: Any) -> dict:
        """The full decision tree for every ``auto`` axis — inputs,
        per-candidate predicted costs, winner, reason — WITHOUT
        executing (no layout build, no capture, no kernel).

        Built directly on ``resolve`` (the same call ``run`` and
        ``compile`` make), so the winners here are by construction the
        axes an execution of the same inputs resolves.  On top of the
        winner, every axis reports the costs of the candidates it did
        NOT pick.  With no plan and no mesh (the port's local backend)
        the backend and partition axes take the JAX package's
        ``plan is None`` form; on the card the delivery axis reports
        ``lowering: "cuda"`` and the card's term's inputs.

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
        resolved, _, decision = self.resolve(spec, **overrides)
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

        # -- backend and partition: local, no plan ---------------------
        axes["backend"] = {
            "winner": resolved.backend,
            "reason": decision["backend"].get("reason"),
            "inputs": {"mesh": self.mesh is not None},
            "candidates": {
                "local": {"eligible": True, "predicted_sync_bytes": 0.0},
                "replicated": {"eligible": self.mesh is not None},
                "sharded": {"eligible": self.mesh is not None},
            },
        }
        axes["partition"] = {
            "winner": resolved.partition_strategy,
            "reason": "local execution partitions nothing",
            "inputs": {},
            "candidates": {},
        }

        # -- delivery: reference vs fused HBM-traffic model ------------
        # Run the cost model even when the axis was pinned or gated, so
        # the non-winning candidate's predicted cost is always visible.
        gate = _non_monoid_reason(spec)
        _, dwhy = select_delivery(spec, hg0)
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
