"""One API, many design points: the ``Engine`` facade, in PyTorch.

This slice of the port runs the local backend on the bipartite
representation: ``Engine(...).run(spec)`` resolves the ``delivery`` axis
(reference gather/mask/segment path vs the fused degree-class layout,
which on the card runs the hand-written CUDA kernel) and executes the
superstep loop of ``repro_torch.core.engine``.  The chosen design point
and the measured wall, dispatch and device-wait times come back on the
``Result``.

Design axes this slice does not port raise ``NotImplementedError``
naming their ROADMAP.md item; none is silently ignored.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.api import tree_leaves
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

REPRESENTATIONS = ("auto", "bipartite", "clique")
BACKENDS = ("auto", "local", "replicated", "sharded")
INTERSECT_KERNELS = ("auto", "bitset", "merge")

Pytree = Any


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"{item})"
    )


_CLIQUE = "item 5: core/clique.py and the clique representation"
_DISTRIBUTED = "item 10: core/distributed.py"
_CHECKPOINT = "item 8: faults/checkpoint.py"
_SERVING = "item 6: core/serving.py"
_ANALYTICS = "item 7: motifs/ and Engine.analyze"
_OBS_FAULTS = "item 8: obs/ and faults/"
_DISK_CACHE = "item 9: serve/cache.py"


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Every design choice from the paper, in one place (the JAX
    package's fields; see ``repro.core.executor.ExecutionConfig``).

    Values of axes that this slice does not port raise
    ``NotImplementedError``: ``representation='clique'``, a
    ``replicated`` or ``sharded`` backend, and ``checkpoint_every``.
    ``jit`` is accepted and has no effect: PyTorch runs eagerly.
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
        if self.representation == "clique":
            raise _not_ported("representation='clique'", _CLIQUE)
        if self.backend in ("replicated", "sharded"):
            raise _not_ported(f"backend={self.backend!r}", _DISTRIBUTED)
        if self.checkpoint_every is not None:
            raise _not_ported("checkpoint_every", _CHECKPOINT)


@dataclasses.dataclass(frozen=True)
class Result:
    """What an execution produced, plus the design point that produced it.

    ``superstep_stats``: ``(v_active, he_active)`` int32 tensors of
    length ``max_iters`` when ``collect_stats`` was set.
    ``decision``: the reasons behind each resolved axis, plus
    ``measured`` (``wall_s``, ``dispatch_s``, ``device_wait_s``,
    ``max_iters``, ``supersteps``, ``pairs_run``, ``host_syncs``).
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


# Hard gates of the fused delivery path (the JAX package's constants).
# The width and padding-work terms are the CPU (ELL) cost model; on the
# card only the gates apply until H100 measurements fill in a cost term.
FUSED_MAX_WIDTH_BYTES = 64.0    # per-entity message bytes
FUSED_ELL_WORK_BUDGET = 4.0     # padded ELL slots per real incidence
FUSED_MIN_NNZ = 4096


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
    * ``cuda``: only the gates (plus ``FUSED_MIN_NNZ``), then the kernel.
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
    if nnz < FUSED_MIN_NNZ:
        why["reason"] = (
            f"tiny incidence ({nnz} < {FUSED_MIN_NNZ}): layout and "
            "dispatch overheads dominate"
        )
        return "xla", why
    if lowering == "cuda":
        why["nnz"] = nnz
        why["reason"] = (
            "monoid path on the card: fused CUDA kernel (the cost term "
            "waits for H100 measurements; only the hard gates apply)"
        )
        return "pallas_fused", why

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

    ``device``: where specs must live and run (default ``cuda``; raises
    when no card is present — pass ``device="cpu"`` for the host).
    ``plan``, ``mesh``, ``disk_cache``, ``tracer``, ``metrics`` and
    ``fault_injector`` belong to slices not ported yet and raise when
    given.
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
        **overrides: Any,
    ):
        if plan is not None or mesh is not None:
            raise _not_ported("a partition plan or mesh", _DISTRIBUTED)
        if disk_cache is not None:
            raise _not_ported("disk_cache", _DISK_CACHE)
        if tracer is not None or metrics is not None:
            raise _not_ported("tracer / metrics", _OBS_FAULTS)
        if fault_injector is not None:
            raise _not_ported("fault_injector", _OBS_FAULTS)
        cfg = config if config is not None else ExecutionConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.device = resolve_device(device)
        self.config = cfg
        # Fused-delivery layouts, keyed by hypergraph identity: the
        # dst-sort + ELL/CSR precompute is paid once per structure.
        self._delivery_cache: list = []

    # -- resolution ---------------------------------------------------------

    def _resolve_representation(self, spec, cfg) -> tuple[str, dict]:
        if cfg.representation == "bipartite":
            return "bipartite", {"reason": "explicitly configured"}
        touches = getattr(spec, "touches_hyperedge_state", True)
        has_program = getattr(spec, "clique_program", None) is not None
        if not touches and has_program:
            raise _not_ported(
                "auto representation for a clique-eligible spec", _CLIQUE
            )
        return "bipartite", {
            "touches_hyperedge_state": touches,
            "has_clique_program": has_program,
            "reason": (
                "algorithm touches hyperedge state"
                if touches else "no clique program supplied"
            ),
        }

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

    def _delivery_layouts(self, hg):
        """Both directions' fused layouts for one structure, cached by
        hypergraph identity."""
        for c_hg, lay in self._delivery_cache:
            if c_hg is hg:
                return lay
        lay = layout_pair(
            hg.src, hg.dst, hg.e_mask, hg.n_vertices, hg.n_hyperedges
        )
        self._delivery_cache.append((hg, lay))
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
        decision["backend"] = (
            {"reason": "explicitly configured"}
            if cfg.backend == "local"
            else {"reason": "no mesh available"}
        )
        delivery, delivery_why = self._resolve_delivery(spec, cfg)
        decision["delivery"] = delivery_why
        resolved = dataclasses.replace(
            cfg,
            representation=representation,
            backend="local",
            max_iters=(
                cfg.max_iters if cfg.max_iters is not None
                else spec.max_iters
            ),
            partition_strategy="none",
            delivery=delivery,
        )
        return resolved, None, decision

    def run(self, spec, **overrides: Any) -> Result:
        """Execute an ``AlgorithmSpec`` on the local backend.

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
        delivery = (
            self._delivery_layouts(hg)
            if resolved.delivery == "pallas_fused"
            else None
        )
        counters: dict[str, Any] = {}
        t0 = time.perf_counter()
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
        if hg.device.type == "cuda":
            torch.cuda.synchronize(hg.device)
        t2 = time.perf_counter()
        stats = None
        if resolved.collect_stats:
            out, stats = out
        pairs = counters["pairs_run"]
        decision = {**decision, "measured": {
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
        }}
        return Result(
            value=spec.extract(out),
            config=resolved,
            representation="bipartite",
            backend="local",
            superstep_stats=stats,
            decision=decision,
        )

    def submit(self, spec, **overrides: Any):
        """Dispatch on spec type: an ``AlgorithmSpec`` runs (``run``);
        batch analytics specs wait for their slice."""
        from repro_torch.algorithms.spec import AlgorithmSpec

        if isinstance(spec, AlgorithmSpec):
            return self.run(spec, **overrides)
        raise TypeError(
            "Engine.submit takes an AlgorithmSpec in this port, got "
            f"{type(spec).__name__} (batch analytics: ROADMAP.md queue 1, "
            f"{_ANALYTICS})"
        )

    def compile(self, spec, **overrides: Any):
        raise _not_ported("Engine.compile", _SERVING)

    def analyze(self, spec, **overrides: Any):
        raise _not_ported("Engine.analyze", _ANALYTICS)

    def explain(self, spec, hg=None, **overrides: Any):
        raise _not_ported("Engine.explain", _OBS_FAULTS)
