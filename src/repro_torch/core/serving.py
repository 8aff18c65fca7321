"""Compile-once serve-many for the port: what ``Engine.compile`` returns.

``Engine.run`` resolves the design point and builds its layouts per
call, and dispatches every operation of every superstep pair from the
host.  Serving many SSSP sources or personalized-restart seeds against
one hypergraph wants the opposite: resolve once, pay the set-up once,
and dispatch as little as possible per request.  This module is the
serving half of the facade (the JAX package's ``repro.core.serving``):

* ``bucket_dim`` quantizes ``n_vertices`` / ``n_hyperedges`` / ``nnz``
  (and batch sizes) to power-of-two buckets, so a stream of
  slightly-varying hypergraphs maps onto a bounded set of padded shapes;
* ``signature`` canonicalizes (programs, design point, bucket dims,
  attribute dtypes, query structure, batch bucket, delivery layout
  shapes) into the hashable key of the Engine's LRU executable cache;
* ``CompiledAlgorithm`` is the serve-many handle: ``run(hg,
  query=...)`` and ``run_batch(queries)`` for any same-bucket
  hypergraph, through one cached executable per signature.

The JAX package's executable is a jitted function.  Here it is an
``_Executable``: buffers it owns (a copy of the padded structure, the
delivery layouts and their kernel launch plans, the real sizes, the
loop state) and, on the card, a CUDA graph of ONE superstep pair over
them (``engine.pair_in_place``), captured at first use.  So an entry
holds device memory (a 64-query DBLP batch: its ``[n, 64]`` state
buffers and the graph's pool), and the Engine's LRU is bounded in bytes
as well as in entries; an evicted entry releases its graph and buffers.  A request
copies its structure in (skipped when the last request had the same
one), resets the loop state and replays the graph once per pair; the
halting decision stays on the host (``engine.halting_loop``), one read
per pair only for specs with activity vectors.  On the CPU the same
pair runs eagerly on the same buffers.  ``Engine.cache_stats()
["traces"]`` counts graph captures on the card and executable builds on
the CPU.

Real (unpadded) sizes live in device scalars the pair reads, so activity
stats and halting mask padding slots and results equal an unpadded run
while shapes stay bucket-stable.  A batch keeps its query axis inner
(``[n, B, ...]``): one fused delivery serves every query (the kernel's
rows are ``B·d`` wide), and results are transposed once, at the end, to
the JAX package's ``[B, n]``.

On the distributed backends (``Engine(mesh=)``, every rank calling
with the same requests) an executable holds this rank's edge shard over
the padded entity range (the plan's shards padded to a bucketed length,
``_pad_shards``), its fused layouts (``build_shard_delivery``) and its
part of the loop state, and its pair is the distributed one
(``engine.pair_in_place(dist=)``, ``repro_torch.core.distributed``).
On the card it is captured as on the local backend, collectives
included (NCCL's communicator is made by an eager collective first); on
``gloo`` the pair runs eagerly.  A batch halts on the ``all(halted)`` of
counts that are the same on every rank.  The cache key carries every
rank's layout signature, and an entry's bytes are the largest over the
ranks, so every rank's cache hits, misses and evicts alike: a miss on
one rank only would run a capture's warm-up pair, and its collectives,
on that rank alone.

With ``Engine(tracer=)``, a layout build records ``serve.layout_build``,
an executable build ``engine.build_executable`` and a request
``engine.execute`` (its device wait included), and the request's
``measured`` adds the modeled delivery bytes, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.api import constant_initial_msg, tree_leaves, tree_map
from repro_torch.core.engine import (
    entity_ids,
    halting_loop,
    pair_in_place,
    pair_state,
    reset_pair_state,
)
from repro_torch.core.hypergraph import HyperGraph, _host
from repro_torch.faults.errors import is_transient
from repro_torch.obs.calibrate import delivery_traffic_pair
from repro_torch.obs.trace import maybe_span
from repro_torch.kernels.deliver.fused import (
    captured_launches,
    count_replay,
    leaf_plan,
)

Pytree = Any

# Smallest entity/incidence bucket: graphs below this all share one shape.
BUCKET_FLOOR = 64
# Batch-size buckets start lower — single-digit batches are common.
BATCH_FLOOR = 8


def bucket_dim(n: int, floor: int = BUCKET_FLOOR) -> int:
    """Smallest power-of-two ≥ ``n`` (and ≥ ``floor``).

    Bounded buckets are the compile-amortization contract: padded work
    grows at most 2x, while the number of distinct executables a
    workload can touch is O(log max_size).
    """
    b = int(floor)
    n = int(n)
    while b < n:
        b *= 2
    return b


def _tree_sig(tree: Pytree, leaf_sig):
    """Hashable structure of a tree (container types, dict keys) with
    ``leaf_sig`` of each leaf."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,
                tuple(_tree_sig(x, leaf_sig) for x in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, _tree_sig(tree[k], leaf_sig))
                              for k in sorted(tree)))
    return leaf_sig(tree)


def _attr_sig(tree: Pytree):
    """Per-leaf dtype + trailing shape: the leading entity dim is the
    bucket's business, dtype/feature-shape changes must miss the
    cache."""
    return _tree_sig(tree, lambda t: (str(t.dtype), tuple(t.shape[1:])))


def _query_sig(query: Pytree):
    """Full dtype/shape structure of one (unbatched) canonical query."""
    return _tree_sig(query, lambda a: (a.dtype.name, a.shape))


def _canon_query(query: Pytree) -> Pytree:
    """Host numpy arrays of fixed width: a Python int, a numpy int64
    and a numpy int32 give one signature (as in the JAX package, whose
    arrays are 32-bit)."""
    def one(x):
        a = _host(x)
        if a.dtype == np.int64:
            return a.astype(np.int32)
        if a.dtype == np.float64:
            return a.astype(np.float32)
        return a

    return tree_map(one, query)


def _initial_msg_sig(initial_msg: Pytree):
    """Hashable VALUE signature of a spec's initial message: it can be
    swapped via ``spec._replace`` without changing any program, and it
    is the loop's starting message, so its bytes enter the key."""
    return _tree_sig(initial_msg, lambda leaf: (
        lambda a: (a.dtype.name, a.shape, a.tobytes()))(_host(leaf)))


def signature(
    spec,
    cfg,
    *,
    nv_pad: int,
    ne_pad: int,
    nnz_pad: int,
    v_attr_sig,
    he_attr_sig,
    e_attr_sig,
    query_sig,
    batch_pad: int | None,
    delivery_sig=None,
    initial_msg_sig=None,
    shard_len_pad: int = 0,
    n_parts: int = 0,
):
    """The executable cache key (the JAX package's fields).

    Program objects participate by identity (their closures bake in
    algorithm constants), so distinct specs never collide; everything
    else is the padded-shape/dtype/design-point signature: same bucket
    + same design point = same executable.

    ``delivery_sig``: the fused layouts' ``shape_signature()`` pair —
    class shapes and the kernel's per-class launch scalars, which a
    captured graph keeps; ``None`` on the reference path.  Same-bucket
    hypergraphs usually share it; a degree-regime shift recompiles.
    ``n_parts`` / ``shard_len_pad``: the distributed backends' partition
    count and bucketed shard length (0 on the local backend).

    ``initial_msg_sig``: the precomputed ``_initial_msg_sig`` value
    (memoized per ``CompiledAlgorithm``); ``None`` recomputes.
    """
    return (
        spec.v_program,
        spec.he_program,
        spec.bind_query if query_sig is not None else None,
        (initial_msg_sig if initial_msg_sig is not None
         else _initial_msg_sig(spec.initial_msg)),
        cfg.backend,
        cfg.axis,
        cfg.max_iters,
        cfg.collect_stats,
        cfg.delivery,
        n_parts,
        nv_pad,
        ne_pad,
        nnz_pad,
        shard_len_pad,
        v_attr_sig,
        he_attr_sig,
        e_attr_sig,
        query_sig,
        batch_pad,
        delivery_sig,
    )


# --------------------------------------------------------------------------
# prepared inputs and the executable
# --------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class _Prepared:
    """One source hypergraph, initialized and bucket-padded: what a
    request copies into an executable's buffers.  On a distributed
    backend the pair runs over ``exec_hg``, this rank's edge shard, with
    this rank's degrees and layouts; locally ``exec_hg`` is ``hgp``."""

    base: HyperGraph          # initialized, real size
    nv: int
    ne: int
    nv_pad: int
    ne_pad: int
    nnz_pad: int
    hgp: HyperGraph           # padded; attrs unbound when rebinding
    exec_hg: HyperGraph       # what the pair delivers over
    v_deg: torch.Tensor
    he_card: torch.Tensor
    delivery: tuple | None    # fused layouts of exec_hg (leaf plans built)
    delivery_sig: tuple | None
    attr_sigs: tuple
    ctx: Any = None           # DistContext on a distributed backend
    plan: Any = None
    n_parts: int = 0
    shard_len_pad: int = 0


def _pad_shards(plan, shard_len_pad: int):
    """Zero-pad a plan's ``[n_parts, shard_len]`` edge shards out to the
    bucketed shard length (padding lanes carry mask 0), as host arrays."""
    pad = shard_len_pad - plan.shard_len
    return tuple(np.pad(x, ((0, 0), (0, pad))) if pad else x
                 for x in (plan.shard_src, plan.shard_dst, plan.shard_mask))


def _structure(hg: HyperGraph, v_deg, he_card, delivery) -> list:
    """Every structure tensor a pair reads, in a fixed order: the
    incidence, the degrees, the layouts and, on the card, their leaf
    plans' slot maps (the kernel's descriptor points into the layout
    tensors, so it holds for any layout copied into them)."""
    out = [hg.src, hg.dst, hg.e_mask, *tree_leaves(hg.e_attr), v_deg,
           he_card]
    for lay in delivery or ():
        out += lay.tensors()
        if lay.device.type == "cuda":
            plan = leaf_plan(lay)
            out += [plan.slot_dst, plan.zero_dst]
    return out


def _clone_layout(lay):
    c = lambda ts: tuple(t.clone() for t in ts)
    return dataclasses.replace(
        lay, class_ell=c(lay.class_ell), class_src=c(lay.class_src),
        class_dst=c(lay.class_dst), class_bounds=c(lay.class_bounds),
        inv_perm=lay.inv_perm.clone(), rem_src=lay.rem_src.clone(),
        rem_dst=lay.rem_dst.clone())


class _Executable:
    """What one cache signature compiles to (see the module docstring):
    owned copies of a prepared structure, the loop state, and on the
    card the CUDA graph of one superstep pair over them."""

    def __init__(self, spec, cfg, prep: _Prepared, batch_pad, note_trace):
        # Only what the pair needs: NOT the spec, whose hg0 would stay
        # pinned in the Engine's LRU for the entry's lifetime.
        self.v_program, self.he_program = spec.v_program, spec.he_program
        self.initial_msg = spec.initial_msg
        self.max_iters = cfg.max_iters
        self.batch_pad = batch_pad
        self._note_trace = note_trace
        hgp = prep.exec_hg
        self.ctx = prep.ctx
        self.device = hgp.device
        self.hg = HyperGraph(
            src=hgp.src.clone(), dst=hgp.dst.clone(),
            n_vertices=hgp.n_vertices, n_hyperedges=hgp.n_hyperedges,
            e_attr=tree_map(torch.clone, hgp.e_attr),
            e_mask=hgp.e_mask.clone(),
        )
        self.v_deg, self.he_card = prep.v_deg.clone(), prep.he_card.clone()
        self.delivery = (None if prep.delivery is None
                         else tuple(map(_clone_layout, prep.delivery)))
        self._buffers = _structure(self.hg, self.v_deg, self.he_card,
                                   self.delivery)
        self.n_real = tuple(torch.full((), n, dtype=torch.int32,
                                       device=self.device)
                            for n in (prep.nv, prep.ne))
        self._loaded = weakref.ref(prep)
        self.ids = entity_ids(self.hg)
        if self.ctx is not None:
            self.ids = tuple(map(self.ctx.block, self.ids))
        self.state = None
        self.graph = None
        self.pool_bytes = 0          # the graph's private memory pool
        self.nbytes = 0              # set by ``measure``
        self.recorded = 0            # kernel launches in one replay
        self.data_dependent = True   # until a pair says otherwise
        if self.device.type != "cuda":
            self._note_trace()       # the CPU builds, it captures nothing

    def load(self, prep: _Prepared) -> None:
        """Copy ``prep``'s structure into the buffers, unless they hold
        it already (the warm serve loop over one hypergraph)."""
        if self._loaded() is prep:
            return
        theirs = _structure(prep.exec_hg, prep.v_deg, prep.he_card,
                            prep.delivery)
        for mine, src in zip(self._buffers, theirs, strict=True):
            mine.copy_(src)
        self.n_real[0].fill_(prep.nv)
        self.n_real[1].fill_(prep.ne)
        self._loaded = weakref.ref(prep)

    def reset(self, v_attr, he_attr) -> None:
        """Start the loop state over from these (bound) attributes."""
        msg = constant_initial_msg(self.initial_msg, self.hg.n_vertices,
                                   self.device)
        if self.batch_pad is not None:
            msg = tree_map(lambda x: x.unsqueeze(1).expand(
                (x.shape[0], self.batch_pad) + x.shape[1:]), msg)
        if self.ctx is not None:
            # This rank's part of the state (its id block under sharded).
            v_attr, he_attr, msg = (tree_map(self.ctx.block, t)
                                    for t in (v_attr, he_attr, msg))
        if self.state is None:
            self.state = pair_state(v_attr, he_attr, msg, self.max_iters,
                                    self.batch_pad, device=self.device)
        else:
            reset_pair_state(self.state, v_attr, he_attr, msg)

    def pair(self) -> bool:
        self.data_dependent = pair_in_place(
            self.state, self.hg, self.v_program, self.he_program,
            self.v_deg, self.he_card, ids=self.ids, n_real=self.n_real,
            delivery=self.delivery, dist=self.ctx,
        )
        return self.data_dependent

    @property
    def needs_capture(self) -> bool:
        return self.device.type == "cuda" and self.graph is None

    def capture(self) -> None:
        """Warm up one pair on a side stream (the kernels' first
        launches, vmap's set-up, allocations), then capture one pair
        into a CUDA graph.  Both advance the loop state: the caller
        resets it.  A capture failure (a procedure that reads the step
        on the host, say) raises; nothing falls back to eager pairs.
        A distributed pair is captured with its collectives: one eager
        collective on the group first makes NCCL's communicator, which
        NCCL creates lazily and a capture cannot."""
        dev = self.device
        if self.ctx is not None:
            dist.all_reduce(torch.zeros(1, device=dev), group=self.ctx.group)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.pair()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        pool = []

        def record():
            # "thread_local": work that another thread queues meanwhile
            # on a stream of its own (a serving front-end's callers)
            # does not void the capture, as it does in "global" mode;
            # this Engine's own work waits on its lock.
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                # Entering the capture empties the allocator's cache;
                # what the card reserves from here on is the graph's own
                # pool, held until the graph goes.
                reserved = torch.cuda.memory_reserved(dev)
                self.pair()
                pool.append(torch.cuda.memory_reserved(dev) - reserved)

        self.recorded = captured_launches(record)
        self.graph = graph
        self.pool_bytes = pool[0]
        self._note_trace()

    def measure(self) -> int:
        """Memory this entry holds, once its state and graph exist: its
        tensors (structure, layouts, leaf plans' slot maps, real sizes,
        ids, loop state), each storage once, plus the graph's pool on
        the card.  Kept in ``nbytes``: the buffers never reallocate."""
        seen, total = set(), self.pool_bytes
        for t in (*self._buffers, *self.n_real, *self.ids,
                  *tree_leaves(self.state)):
            key = t.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
        self.nbytes = total
        return total

    def release(self) -> None:
        """Drop the graph and every buffer (an evicted entry), so a
        reference kept elsewhere pins no device memory."""
        self.graph = None
        self.state = None
        self.hg = self.delivery = self.v_deg = self.he_card = None
        self._buffers, self.n_real, self.ids = [], (), ()
        self.pool_bytes = self.nbytes = 0

    def replay(self) -> bool:
        """One pair: the graph's replay on the card, the eager pair on
        the CPU.  Returns whether halting depends on the device's data."""
        if self.graph is None:
            return self.pair()
        self.graph.replay()
        count_replay(self.recorded)
        return self.data_dependent


# --------------------------------------------------------------------------
# the serve-many handle
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CompiledAlgorithm:
    """What ``Engine.compile`` returns: a design point resolved once,
    served many times.

    >>> compiled = engine.compile(shortest_paths_spec(hg, 0))
    >>> compiled.run()                         # hg0, baked-in source
    >>> compiled.run(query=7)                  # same executable, source 7
    >>> compiled.run_batch(np.arange(64))      # one batched executable
    >>> compiled.run(other_hg)                 # no capture if same bucket

    Executables live in the owning Engine's LRU cache keyed by
    ``signature``: a second same-bucket hypergraph (or a second
    ``compile`` of the same spec) is a cache hit with no new capture;
    dtype, bucket, or design-point changes miss and build afresh.
    ``Engine.cache_stats()`` exposes hits/misses/entries/traces.

    With ``checkpoint_every`` set, ``run`` takes the chunked
    checkpoint/resume loop (``_run_checkpointed``) in place of the
    cached executable.  On a distributed backend every rank of the
    Engine's mesh makes the same calls.  An ``Engine(fault_injector=)`` fires
    ``layout.build`` where a fused layout is built and ``execute`` before
    each request's pairs run (never during a capture; ``warmup`` never
    fires it).  Calls hold the Engine's lock, so a capture on one thread
    never overlaps another thread's work on this Engine.
    """

    engine: Any
    spec: Any
    config: Any                       # fully-resolved ExecutionConfig
    decision: dict
    # Warm-path memo: (source_hg identity, rebind) -> _Prepared, so a
    # serve loop over one hypergraph pays init + padding + layouts once.
    _pad_cache: list = dataclasses.field(default_factory=list)
    # Memoized _initial_msg_sig (host work, not per request).
    _init_msg_sig: Any = None
    # Memoized graceful-degradation twin (delivery="xla").
    _xla_twin: Any = None
    # The plan resolve() chose for hg0 (distributed backends).
    _plan0: Any = None

    # -- public API --------------------------------------------------------

    def run(self, hg: HyperGraph | None = None, query: Any = None):
        """Execute on ``hg`` (default: the spec's own hypergraph).

        ``query`` rebinds the spec's per-request state (requires
        ``spec.bind_query``); ``hg`` may be any hypergraph the spec's
        ``init`` can re-initialize.  When no query is given but the spec
        declares one (``query0``), the default query is bound through
        the same path, so querying and non-querying calls share one
        executable.
        """
        spec = self.spec
        if (query is None and spec.bind_query is not None
                and spec.init is not None and spec.query0 is not None):
            query = spec.query0
        with self.engine._lock:
            if self.config.checkpoint_every is not None:
                return self._run_checkpointed(hg, query)
            try:
                prep = self._prepared(hg, rebind=query is not None)
                q = _canon_query(query) if query is not None else None
                return self._execute(prep, q, batch=None)
            except ValueError:
                raise
            except Exception as err:
                twin = self._degraded_sibling(err)
                if twin is None:
                    raise
                return twin.run(hg, query=query)

    def run_batch(self, queries: Any, hg: HyperGraph | None = None):
        """Serve a batch of queries through one batched executable.

        ``queries`` is a query tree with a leading batch dim B (for
        scalar queries: an array of B values).  Returns one ``Result``
        whose value/stats carry a leading B axis, equal to B sequential
        ``run(query=...)`` calls (bitwise for min/max programs; float
        sums within reassociation), with ``supersteps_executed`` the
        pairs the slowest query needed.  The batch dim is bucketed
        (queries repeat-padded with the last one, results sliced back),
        so varying B hits a bounded set of executables.
        """
        if self.spec.bind_query is None:
            raise ValueError(
                f"spec {self.spec.name!r} has no bind_query: declare the "
                "per-request axis to serve batched queries"
            )
        with self.engine._lock:
            try:
                prep = self._prepared(hg, rebind=True)
                queries_c = _canon_query(queries)
                leaves = tree_leaves(queries_c)
                if not leaves or any(leaf.ndim == 0 for leaf in leaves):
                    raise ValueError("batched queries need a leading batch "
                                     "axis on every leaf")
                sizes = {int(leaf.shape[0]) for leaf in leaves}
                if len(sizes) != 1:
                    raise ValueError("query leaves disagree on batch size: "
                                     f"{sorted(sizes)}")
                b = sizes.pop()
                b_pad = bucket_dim(b, floor=BATCH_FLOOR)
                # Repeat-pad with the last query: always a *valid*
                # request, and the padded rows are sliced off the results.
                queries_p = tree_map(
                    lambda leaf: np.concatenate(
                        [leaf] + [leaf[-1:]] * (b_pad - b)
                    ) if b_pad > b else leaf,
                    queries_c,
                )
                return self._execute(prep, queries_p, batch=(b, b_pad))
            except ValueError:
                raise
            except Exception as err:
                twin = self._degraded_sibling(err)
                if twin is None:
                    raise
                return twin.run_batch(queries, hg=hg)

    def warmup(
        self,
        *,
        query: Any = None,
        batch_sizes: tuple[int, ...] = (),
        hg: HyperGraph | None = None,
    ) -> dict:
        """Build (and on the card capture) executables WITHOUT serving
        traffic: the unbatched path plus one batched path per bucket in
        ``batch_sizes``.  ``query``: example request for specs whose
        ``query0`` is unset; required to warm query-bearing paths.

        Returns ``{path: {"source": "disk" | "aot" | "jit",
        "executable": "graph" | "eager"}}``: ``source`` says what the
        Engine's ``disk_cache`` held (``disk``: the signature's record;
        ``aot``: none, one was written; ``jit``: no store attached, see
        ``repro_torch.serve.cache``), ``executable`` what was made
        (``graph``: a captured CUDA graph; ``eager``: pairs run eagerly,
        on the CPU).
        """
        with self.engine._lock:
            spec = self.spec
            if query is None:
                query = spec.query0
            has_query = (
                spec.bind_query is not None
                and spec.init is not None
                and query is not None
            )
            prep = self._prepared(hg, rebind=has_query)
            q = _canon_query(query) if has_query else None
            report = {"single": self._execute(prep, q, batch=None,
                                              warm_only=True)}
            for b in batch_sizes:
                if spec.bind_query is None:
                    raise ValueError(
                        f"spec {spec.name!r} has no bind_query: no batched "
                        "path to warm"
                    )
                if q is None:
                    raise ValueError(
                        "warming a batched path needs an example query "
                        "(spec.query0 is unset — pass query=...)"
                    )
                b_pad = bucket_dim(int(b), floor=BATCH_FLOOR)
                queries = tree_map(
                    lambda leaf: np.broadcast_to(
                        leaf, (b_pad,) + leaf.shape).copy(),
                    q,
                )
                report[f"batch{b_pad}"] = self._execute(
                    prep, queries, batch=(b_pad, b_pad), warm_only=True
                )
            return report

    # -- fault tolerance ---------------------------------------------------

    def _degraded_sibling(self, err: Exception):
        """Graceful degradation, delivery link, on the CPU: a permanent
        ``pallas_fused`` layout-build or execute failure is served by the
        memoized ``delivery="xla"`` twin of this handle, whose Results
        carry ``decision["degraded_from"] = "pallas_fused"``.
        Non-sticky: the next request tries the fused path again.

        ``None`` (the caller re-raises) on the card, where a request is
        never served by plain delivery in place of the kernel: a K1
        launch, build or out-of-memory failure surfaces.  ``None`` too
        for a transient ``err`` (``is_transient``: a retry should run
        the same design point) and when already on ``xla``."""
        engine = self.engine
        if (engine.device.type == "cuda" or is_transient(err)
                or self.config.delivery != "pallas_fused"):
            return None
        if self._xla_twin is None:
            self._xla_twin = CompiledAlgorithm(
                engine=engine,
                spec=self.spec,
                config=dataclasses.replace(self.config, delivery="xla"),
                decision={**self.decision, "degraded_from": "pallas_fused"},
                _plan0=self._plan0,
            )
        engine.metrics.counter("faults.delivery_degraded").inc()
        with maybe_span(
            engine.tracer, "faults.degrade_delivery", cat="faults",
            algorithm=self.spec.name, error=type(err).__name__,
        ):
            pass
        return self._xla_twin

    def _run_checkpointed(self, hg, query):
        """Route through the chunked checkpoint/resume loop
        (``repro_torch.faults.checkpoint``) instead of the cached
        executable.

        The chunks run the SAME pair and loop as the compiled path
        (``engine.pair_in_place`` under ``halting_loop``, eagerly) on
        the same padded structure and layouts, snapshotting the state
        every ``checkpoint_every`` superstep pairs — results are
        bitwise equal to the uninterrupted executable and a killed run
        resumes from ``checkpoint_dir``'s latest snapshot."""
        from repro_torch.core.executor import Result
        from repro_torch.faults.checkpoint import (
            checkpointed_compute,
            checkpointed_distributed_compute,
        )

        cfg = self.config
        spec = self.spec
        engine = self.engine
        prep = self._prepared(hg, rebind=query is not None)
        q = _canon_query(query) if query is not None else None
        nv, ne = prep.nv, prep.ne
        plan = prep.plan
        kw = dict(every=cfg.checkpoint_every, ckpt_dir=cfg.checkpoint_dir,
                  return_stats=cfg.collect_stats, tracer=engine.tracer,
                  metrics=engine.metrics,
                  fault_injector=engine.fault_injector)
        if plan is not None:
            # The distributed chunks run on the real-size hypergraph
            # and the plan's own shards, as Engine.run does.
            from repro_torch.core.distributed import DistContext

            hgq = prep.base if q is None else spec.bind_query(prep.base, q)
            ctx = DistContext.for_mesh(engine.mesh, cfg.axis, nv, ne,
                                       cfg.backend)
            out = checkpointed_distributed_compute(
                hgq, plan, engine.mesh, cfg.max_iters, spec.initial_msg,
                spec.v_program, spec.he_program, axis=cfg.axis,
                backend=cfg.backend, delivery=cfg.delivery,
                shard=engine._rank_shard(hgq, plan, ctx, cfg.delivery), **kw,
            )
        else:
            hgq = prep.hgp if q is None else spec.bind_query(prep.hgp, q)
            out = checkpointed_compute(
                hgq, cfg.max_iters, spec.initial_msg,
                spec.v_program, spec.he_program, n_real=(nv, ne),
                delivery=prep.delivery, **kw,
            )
        stats = None
        if cfg.collect_stats:
            out, stats = out
        if plan is None:
            # The chunks ran on the padded buffers; slice back.
            out = prep.base.with_attrs(
                v_attr=tree_map(lambda x: x[:nv], out.v_attr),
                he_attr=tree_map(lambda x: x[:ne], out.he_attr),
            )
        return Result(
            value=spec.extract(out),
            config=cfg,
            representation=cfg.representation,
            backend=cfg.backend,
            partition=plan.name if plan is not None else None,
            partition_stats=plan.stats if plan is not None else None,
            superstep_stats=stats,
            supersteps_executed=None,
            decision={
                **self.decision,
                "checkpointed": {
                    "every": cfg.checkpoint_every,
                    "dir": cfg.checkpoint_dir,
                },
            },
        )

    # -- internals ---------------------------------------------------------

    def _base_state(self, hg, *, rebind: bool):
        """(initialized state, source hypergraph).

        ``rebind=True`` re-initializes even the spec's own hypergraph so
        ``bind_query`` starts from unbound state (hg0 already carries
        ``query0``)."""
        spec = self.spec
        if hg is None and not rebind:
            return spec.hg0, spec.hg0
        if spec.init is None:
            raise ValueError(
                f"spec {self.spec.name!r} has no init: cannot "
                + ("rebind queries" if hg is None else
                   "re-initialize a new hypergraph")
            )
        source = spec.hg0 if hg is None else hg
        return spec.init(source), source

    def _prepared(self, hg, *, rebind: bool) -> _Prepared:
        """Initialized + bucket-padded inputs for one source hypergraph,
        memoized by (hypergraph identity, rebind): the warm serve loop
        pays init/padding/layouts once, not per request."""
        source_probe = self.spec.hg0 if hg is None else hg
        for s, r, prep in self._pad_cache:
            if s is source_probe and r == rebind:
                return prep

        base, _ = self._base_state(hg, rebind=rebind)
        engine = self.engine
        if base.device.type != engine.device.type:
            raise ValueError(
                f"hypergraph lives on {base.device}, this Engine runs on "
                f"{engine.device}"
            )
        nv, ne, nnz = base.n_vertices, base.n_hyperedges, base.nnz
        nv_pad, ne_pad = bucket_dim(nv), bucket_dim(ne)
        nnz_pad = bucket_dim(nnz)
        cfg = self.config
        plan = ctx = shards = None
        shard_len_pad = 0
        if cfg.backend != "local":
            from repro_torch.core.distributed import DistContext, _pad_to

            plan = self._plan_for(source_probe)
            nv_pad = _pad_to(nv_pad, plan.n_parts)
            ne_pad = _pad_to(ne_pad, plan.n_parts)
            shard_len_pad = bucket_dim(plan.shard_len)
            shards = _pad_shards(plan, shard_len_pad)
            ctx = DistContext.for_mesh(engine.mesh, cfg.axis, nv_pad, ne_pad,
                                       cfg.backend)
        hgp = base.padded(nv_pad, ne_pad, nnz_pad)
        # Fused delivery: the dst-sort + class layouts (and the kernel's
        # launch plans) are built HERE, once per structure and bucket —
        # from the PADDED structure (or this rank's padded shard), whose
        # padding lanes carry e_mask=0 and drop out; their shapes enter
        # the cache signature.
        delivery = delivery_sig = None
        if cfg.delivery == "pallas_fused":
            inj = engine.fault_injector
            if inj is not None:
                inj.maybe_raise("layout.build", algorithm=self.spec.name)
            if ctx is None:
                delivery = engine._delivery_layouts(base, padded=hgp)
            else:
                delivery = engine._shard_layouts(plan, ctx, shards)
            delivery_sig = tuple(lay.shape_signature() for lay in delivery)
            if ctx is not None:
                # Every rank's signature, so the ranks' keys agree.
                sigs = [None] * ctx.n_parts
                dist.all_gather_object(sigs, delivery_sig, group=ctx.group)
                delivery_sig = tuple(sigs)
        v_deg, he_card, exec_hg = hgp.degrees(), hgp.cardinalities(), hgp
        if ctx is not None:
            from repro_torch.core.distributed import rank_shard

            shard = rank_shard(ctx, *shards, v_deg, he_card, nv, ne,
                               delivery, hgp.device)
            exec_hg, v_deg, he_card = shard.hg, shard.v_deg, shard.he_card
        prep = _Prepared(
            base=base, nv=nv, ne=ne,
            nv_pad=nv_pad, ne_pad=ne_pad, nnz_pad=nnz_pad, hgp=hgp,
            exec_hg=exec_hg, v_deg=v_deg, he_card=he_card,
            delivery=delivery, delivery_sig=delivery_sig,
            attr_sigs=(_attr_sig(hgp.v_attr), _attr_sig(hgp.he_attr),
                       _attr_sig(hgp.e_attr)),
            ctx=ctx, plan=plan, n_parts=plan.n_parts if plan else 0,
            shard_len_pad=shard_len_pad,
        )
        self._pad_cache.append((source_probe, rebind, prep))
        del self._pad_cache[:-4]  # bound the strong refs we hold
        return prep

    def _plan_for(self, source_hg):
        """The plan a distributed request runs: resolve()'s for hg0, else
        the Engine's cached plan for ``source_hg`` under the resolved
        strategy."""
        if source_hg is self.spec.hg0 and self._plan0 is not None:
            return self._plan0
        plan, _ = self.engine._cached_plan(
            source_hg, self.config.n_parts, self.config.partition_strategy
        )
        return plan

    def _initial_attrs(self, prep: _Prepared, query, batch):
        """The padded starting attributes: bound to ``query``, or for a
        batch to each query in turn (``bind_query`` reads queries on the
        host, so it runs once per query), stacked, with the query axis
        moved to dim 1 (a view: the state's reset copies it)."""
        bind = self.spec.bind_query
        if batch is None:
            hgq = bind(prep.hgp, query) if query is not None else prep.hgp
            return hgq.v_attr, hgq.he_attr
        n = batch[1]
        bound = [bind(prep.hgp, tree_map(lambda leaf: leaf[i], query))
                 for i in range(n)]
        # Stacked on dim 0 and moved: a contiguous stack, then one
        # transposing copy, not a strided stack.
        stack = lambda *xs: torch.stack(xs).movedim(0, 1)
        return (tree_map(stack, *[g.v_attr for g in bound]),
                tree_map(stack, *[g.he_attr for g in bound]))

    def _execute(self, prep: _Prepared, query, batch,
                 warm_only: bool = False):
        from repro_torch.core.executor import Result, message_width_bytes

        cfg = self.config
        spec = self.spec
        engine = self.engine
        b, b_pad = batch if batch is not None else (None, None)
        v_sig, he_sig, e_sig = prep.attr_sigs
        one_query = (
            tree_map(lambda leaf: leaf[0], query)
            if batch is not None and query is not None
            else query
        )
        if self._init_msg_sig is None:
            self._init_msg_sig = _initial_msg_sig(spec.initial_msg)
        key = signature(
            spec, cfg,
            nv_pad=prep.nv_pad, ne_pad=prep.ne_pad, nnz_pad=prep.nnz_pad,
            v_attr_sig=v_sig, he_attr_sig=he_sig, e_attr_sig=e_sig,
            query_sig=_query_sig(one_query),
            batch_pad=b_pad,
            delivery_sig=prep.delivery_sig,
            initial_msg_sig=self._init_msg_sig,
            shard_len_pad=prep.shard_len_pad,
            n_parts=prep.n_parts,
        )
        meta = {
            "algorithm": spec.name,
            "backend": cfg.backend,
            "delivery": cfg.delivery,
            "nv_pad": prep.nv_pad,
            "ne_pad": prep.ne_pad,
            "nnz_pad": prep.nnz_pad,
            "batch_pad": b_pad,
            "n_parts": prep.n_parts,
        }
        exe = engine._executable_for(
            key,
            lambda: _Executable(spec, cfg, prep, b_pad, engine._note_trace),
            meta=meta,
        )
        t0 = time.perf_counter()
        try:
            exe.load(prep)
            v_attr, he_attr = self._initial_attrs(prep, query, batch)
            exe.reset(v_attr, he_attr)
            if exe.needs_capture:
                exe.capture()
                exe.reset(v_attr, he_attr)
        except Exception:
            if not exe.nbytes:  # a build that never got ready: drop it
                engine._discard_executable(key)
            raise
        if not exe.nbytes:
            exe.measure()
            if prep.ctx is not None:
                # The largest over the ranks: every rank evicts alike.
                most = torch.tensor([exe.nbytes], dtype=torch.int64,
                                    device=exe.device)
                dist.all_reduce(most, op=dist.ReduceOp.MAX,
                                group=prep.ctx.group)
                exe.nbytes = int(most)
            engine._fit_exec_cache()
        if warm_only:
            return {"source": getattr(exe, "source", None) or "jit",
                    "executable": "eager" if exe.graph is None else "graph"}
        # Fault injection on the execute seam: one attribute load and a
        # None-check when no injector is attached.  It fires before the
        # pairs run, after any capture, and never on a warmup.
        inj = engine.fault_injector
        if inj is not None:
            inj.maybe_raise(
                "execute", algorithm=spec.name, backend=cfg.backend,
                delivery=cfg.delivery, batch=int(b) if b is not None else 0,
            )
        counters: dict = {}
        tracer = engine.tracer
        with maybe_span(
            tracer, "engine.execute", cat="execute", algorithm=spec.name,
            backend=cfg.backend, delivery=cfg.delivery,
            batch=int(b) if b is not None else 0,
        ) as sp:
            pairs = halting_loop(exe.replay, exe.state, cfg.max_iters,
                                 counters)
            if sp is not None:
                tracer.block(sp, exe.state)

        # Slice padding (and batch padding) back off, into tensors the
        # next request cannot overwrite; extract on a real-size
        # hypergraph whose attrs may carry a leading batch dim.  A
        # sharded state is gathered first.
        state, nv, ne = exe.state, prep.nv, prep.ne
        if prep.ctx is not None:
            state = {**state, "v_attr": prep.ctx.full(state["v_attr"]),
                     "he_attr": prep.ctx.full(state["he_attr"])}
        if batch is not None:
            own = lambda x: x.clone(memory_format=torch.contiguous_format)
            take_v = lambda x: own(x[:nv, :b].movedim(1, 0))
            take_he = lambda x: own(x[:ne, :b].movedim(1, 0))
            trace = lambda x: own(x[:, :b].T)
        else:
            take_v = lambda x: x[:nv].clone()
            take_he = lambda x: x[:ne].clone()
            trace = torch.clone
        stats = ((trace(state["v_trace"]), trace(state["he_trace"]))
                 if cfg.collect_stats else None)
        out = prep.base.with_attrs(
            v_attr=tree_map(take_v, state["v_attr"]),
            he_attr=tree_map(take_he, state["he_attr"]),
        )
        t1 = time.perf_counter()
        if exe.device.type == "cuda":
            torch.cuda.synchronize(exe.device)
        t2 = time.perf_counter()
        halted = counters["halted"]
        measured = {
            "wall_s": t2 - t0,
            "dispatch_s": t1 - t0,
            "device_wait_s": t2 - t1,
            "max_iters": cfg.max_iters,
            "supersteps": pairs - 1 if halted else pairs,
            "pairs_run": pairs,
            "host_syncs": counters["host_syncs"],
            "graph": exe.graph is not None,
        }
        if (tracer is not None and prep.delivery is not None
                and prep.ctx is None):
            # Tracer-gated, as in the JAX package: warm serving builds
            # no traffic record by default.
            measured["delivery"] = delivery_traffic_pair(
                prep.delivery, message_width_bytes(spec.initial_msg))
        decision = {**self.decision, "measured": measured}
        return Result(
            value=spec.extract(out),
            config=cfg,
            representation=cfg.representation,
            backend=cfg.backend,
            partition=prep.plan.name if prep.plan is not None else None,
            partition_stats=(prep.plan.stats if prep.plan is not None
                             else None),
            superstep_stats=stats,
            supersteps_executed=pairs if batch is not None else None,
            decision=decision,
        )
