"""AST lints over ``src/repro_torch``: the four static rules of the port
(the JAX package's ``repro.analysis.lint``, its machinery whole, its
rules made torch's).

* ``host-sync`` — host reads of a tensor: ``.item()`` / ``.tolist()`` /
  ``.cpu()`` / ``.numpy()`` / ``int()`` / ``float()`` / ``bool()`` /
  ``np.asarray`` / ``np.array`` / ``torch.equal`` / a ``synchronize``
  (``torch.cuda.synchronize``, an event's or a stream's), and
  ``torch.any`` / ``torch.all`` / ``.any()`` / ``.all()`` used as a
  Python bool, classified against the serve / superstep **hot-path
  inventory** (``HOT_PATHS``):

  - ``finding`` — on a hot path, outside any tracer guard;
  - ``guarded`` — on a hot path but inside ``if tracer is not None:``
    (or after an early ``if tracer is None: return`` fast path) — the
    observability contract: sync only when someone is watching;
  - ``cold-path`` — everywhere else (compile/boot/layout-build time);
    reported as counts, never as findings.

  Casts of static values are Python-level and skipped: constants,
  shape reads (``int(x.shape[0])``, ``len``, ``.numel()``, ``.dim()``,
  ``.size()``, ``.element_size()``, ``.data_ptr()``), parameters
  annotated ``int`` / ``float`` / ``bool`` / ``str``, names assigned
  from such values and ``range`` loop variables.

* ``capture-sync`` — the counterpart of the JAX package's
  ``traced-cond``.  Eager torch has no traced ``if``; what breaks a
  CUDA-graph capture is a host read, or a Python branch on a tensor,
  inside the captured region.  Regions are the bodies of every ``with
  torch.cuda.graph(...)`` in the package, followed through each
  package-local function they call (by name, transitively, across
  modules: a function-valued argument, a local alias and a parameter's
  default are followed; ``self.m`` to the enclosing class's method;
  ``obj.m`` to the package's one method of that name, if it is one).
  Flagged there: every ``host-sync`` form, and ``if`` / ``while`` whose
  test is a tensor expression (a name assigned from a ``torch`` call or
  a tensor's method, a parameter annotated ``torch.Tensor``, their
  subscripts and arithmetic).  Identity tests, ``isinstance`` and
  shape / dtype reads are exempt, as in the reference.  A procedure
  passed in as a value (an algorithm's) is not followed: the card test
  of a host read of the step covers it.  A capture-sync suppression on
  a call's line also stops the walk at that call (a callee that runs
  only before the capture, a leaf plan built once, say).

* ``tracer-gate`` — a function that accepts a ``tracer`` and calls
  ``tracer.span(...)`` / ``tracer.block(...)`` with no ``tracer is
  None`` branch anywhere in its body (``maybe_span`` is the sanctioned
  alternative and never flagged).

* ``swallowed-error`` — a bare/broad ``except`` on a hot path that
  neither re-raises, forwards the bound exception nor reaches the
  faults taxonomy (``_ERROR_ROUTES``); a cold-path count elsewhere.

The reference's ``static-arg-array`` has no counterpart: nothing is
jitted with static arguments.

Suppression: a trailing ``# analysis: ignore[rule]`` on the finding's
line (or a comment block right above it) reclassifies it as
``suppressed`` — the inline acknowledgment for intentional sites.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.findings import Finding

# Python-static predicates: never a tensor branch.
_SAFE_CALLS = {
    "isinstance", "hasattr", "callable", "len", "issubclass", "getattr",
    "type", "id", "repr", "str",
}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size"}
# Tensor methods whose result is a host int (no device read).
_STATIC_METHODS = {
    "numel", "dim", "size", "element_size", "data_ptr", "stride",
    "nelement", "storage_offset",
}
_SCALAR_TYPES = {"int", "float", "bool", "str"}

# Host-sync method / function names.
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_SYNC_DOTTED = {
    ("np", "asarray"), ("np", "array"), ("numpy", "asarray"),
    ("numpy", "array"), ("torch", "equal"),
}
_SYNC_BARE = {"float", "int", "bool"}
# Reductions that read the device when a Python bool is taken of them.
_BOOL_REDUCE_DOTTED = {("torch", "any"), ("torch", "all")}
_BOOL_REDUCE_METHODS = {"any", "all"}
# ``torch.<x>`` calls whose result is no tensor.
_TORCH_HOST = {
    "cuda", "device", "dtype", "Size", "finfo", "iinfo", "is_tensor",
    "distributed", "backends", "get_default_dtype", "is_floating_point",
}

# The serve / superstep hot-path inventory: module-relative path suffix
# -> qualname prefixes.  A call site is "hot" when its file matches and
# its enclosing qualname extends one of these (closures included:
# ``_serve_replica._on_done`` is hot because ``_serve_replica`` is).
HOT_PATHS: dict[str, tuple[str, ...]] = {
    "core/engine.py": (
        "deliver", "_pair", "compute_resumable", "compute",
        "pair_in_place", "halting_loop",
    ),
    "core/serving.py": (
        "signature", "_query_sig", "_canon_query", "_initial_msg_sig",
        "_Executable.pair", "_Executable.capture", "_Executable.replay",
        "CompiledAlgorithm.run", "CompiledAlgorithm.run_batch",
        "CompiledAlgorithm._execute",
    ),
    "core/distributed.py": (
        "_cross_combine", "_cross_combine_scatter",
        "_superstep_replicated", "_superstep_sharded", "DistContext.count",
    ),
    "kernels/deliver/__init__.py": (
        "fused_deliver", "_pallas_leaf", "_mask_per_query",
    ),
    "kernels/deliver/fused.py": ("deliver_leaf_cuda", "_launch"),
    "kernels/flash/flash.py": (
        "flash_cuda", "flash_backward_cuda", "FlashAttentionFn",
    ),
    "kernels/flash/ops.py": ("flash_attention",),
    "models/transformer.py": (
        "prefill", "serve_step", "encode", "forward", "_qkv",
        "_attention_block", "_ffn_block", "_residual", "_logits", "_layer",
        "loss_fn",
    ),
    "models/attention.py": (
        "causal_attention", "bidirectional_attention", "naive_attention", "blocked_attention",
        "chunked_local_attention", "decode_attention",
    ),
    "models/moe.py": (
        "moe_ffn", "_dispatch", "_dispatch_group", "_combine", "_experts",
        "_swiglu_experts", "_top_k", "_router_sums", "_router_losses",
        "_moe_ffn_partitioned", "partitioned_router_losses",
    ),
    "models/layers.py": (
        "cast_weight", "dense", "rmsnorm", "swiglu", "rope", "embed",
        "unembed", "fused_unembed_cross_entropy",
    ),
    "launch/serve.py": ("generate", "_sync"),
    "sparse/segment.py": (
        "mp_segment_sum", "mp_segment_max", "mp_segment_min",
        "_mp_extreme", "_merge_sum", "_MergeSum", "_MergeExtreme",
        "_all_reduced", "_segment_sum", "_take", "segment_count",
        "segment_mean", "segment_std", "segment_softmax",
        "segment_logsumexp",
    ),
    "kernels/segsum/ops.py": ("SegmentSumFn", "segment_sum_mxu"),
    "kernels/segsum/segsum.py": ("segsum_cuda",),
    "models/gnn/gat.py": ("forward", "loss_fn"),
    "models/gnn/pna.py": ("forward", "loss_fn", "_finite_or_zero"),
    "models/gnn/equivariant.py": (
        "forward", "loss_fn", "forces", "_tensor_product_msg",
        "_self_product", "_update",
    ),
    "models/gnn/irreps.py": ("sph_harm", "bessel_basis"),
    "models/recsys/bert4rec.py": (
        "encode", "logits_all_items", "loss_fn", "loss_sampled",
        "serve_score", "retrieval_score",
    ),
    "sparse/embedding_bag.py": ("embedding_bag", "embedding_bag_dense"),
    "sparse/gather.py": ("take_rows",),
    "launch/gnn_sharded.py": ("make_edge_sharded_step", "edge_shard"),
    "train/step.py": ("make_train_step",),
    "train/optimizer.py": ("adamw_update", "schedule", "global_norm"),
    "train/tree.py": ("leaves", "named_leaves", "_children"),
    "serve/frontend.py": (
        "Frontend.submit", "Frontend.pump", "Frontend._worker",
        "Frontend._serve_loop", "Frontend._run_flush",
        "Frontend._execute_requests", "Frontend._attempt",
        "Frontend._requeue_after_crash", "Frontend._fail",
        "_stack", "_unstack", "_block",
    ),
    "serve/queue.py": (
        "CoalescingBatcher.submit", "CoalescingBatcher.poll",
        "CoalescingBatcher._take", "AdaptiveDelay.observe",
    ),
    "serve/replica.py": (
        "_serve_replica", "_to_host", "ProcessReplica.poll_messages",
        "ProcessReplica.send",
    ),
    "serve/router.py": (
        "Router.submit", "Router.pump", "Router._admit", "Router._route",
        "Router._dispatch", "Router._on_message", "Router._mark_dead",
        "Router._apply", "Router._fail_pending_if_hopeless",
    ),
}

_SUPPRESS_RE = re.compile(r"#\s*analysis:\s*ignore(?:\[([a-z\-,\s]+)\])?")

# Broad exception classes a handler may catch without naming the real
# failure; and the faults-taxonomy / error-forwarding names whose
# presence in a handler body means the error was routed, not swallowed
# (``repro_torch.faults.errors``).
_BROAD_EXC = {"Exception", "BaseException"}
_ERROR_ROUTES = {
    "FaultError", "InjectedFault", "TransientExecuteError",
    "DeadlineExceeded", "FrontendClosed", "PoisonQuery", "CircuitOpen",
    "CorruptCacheEntry", "CheckpointError", "ReplicaLost", "Overloaded",
    "is_transient", "set_exception",
}


def _broad_handler(h: ast.ExceptHandler) -> bool:
    if h.type is None:
        return True
    elts = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    return any(
        (_dotted(e) or "").rsplit(".", 1)[-1] in _BROAD_EXC for e in elts
    )


def _handler_routes(h: ast.ExceptHandler) -> bool:
    """Does the handler re-raise, forward the bound exception, or reach
    into the faults taxonomy?  Any of these counts as routing."""
    for node in ast.walk(h):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Name):
            if node.id in _ERROR_ROUTES:
                return True
            if (
                h.name is not None
                and node.id == h.name
                and isinstance(node.ctx, ast.Load)
            ):
                return True
        if isinstance(node, ast.Attribute) and node.attr in _ERROR_ROUTES:
            return True
    return False


def _dotted(node: ast.expr) -> str | None:
    """``a.b.c`` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_static_expr(node: ast.expr) -> bool:
    """Shape/len reads: host ints by construction, cast-safe."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            return True
        if isinstance(sub, ast.Call):
            name = _dotted(sub.func) or ""
            if name == "len" or name.endswith(".shape"):
                return True
            if (isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _STATIC_METHODS):
                return True
    return False


def _annotation_names(ann: ast.expr | None) -> set[str]:
    """Leaf type names of an annotation (``int | None`` -> int, None)."""
    if ann is None:
        return set()
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return set()
    out = set()
    for sub in ast.walk(ann):
        name = _dotted(sub) if isinstance(sub, (ast.Name, ast.Attribute)) \
            else None
        if name:
            out.add(name)
        elif isinstance(sub, ast.Constant) and sub.value is None:
            out.add("None")
    return out


def _all_params(fn) -> list[ast.arg]:
    a = fn.args
    out = list(a.posonlyargs + a.args + a.kwonlyargs)
    out += [p for p in (a.vararg, a.kwarg) if p is not None]
    return out


def _static_names(fn) -> set[str]:
    """Names in ``fn`` that hold host scalars: parameters annotated with
    a Python scalar type, ``range`` loop variables, and names assigned
    from constants or static expressions (two passes)."""
    static = {
        p.arg for p in _all_params(fn)
        if (names := _annotation_names(p.annotation))
        and names <= _SCALAR_TYPES | {"None"} and names & _SCALAR_TYPES
    }
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.For) and isinstance(node.iter, ast.Call) \
                    and _dotted(node.iter.func) == "range":
                static |= {n.id for n in ast.walk(node.target)
                           if isinstance(n, ast.Name)}
            if not isinstance(node, ast.Assign):
                continue
            v = node.value
            if not (isinstance(v, ast.Constant) or _is_static_expr(v)
                    or (isinstance(v, ast.Name) and v.id in static)):
                continue
            for tgt in node.targets:
                static |= {n.id for n in ast.walk(tgt)
                           if isinstance(n, ast.Name)}
    return static


def _is_torch_tensor_call(name: str) -> bool:
    parts = name.split(".")
    return parts[0] == "torch" and len(parts) > 1 and (
        parts[1] not in _TORCH_HOST)


def _tensor_locals(fn) -> set[str]:
    """Names plausibly holding tensors in ``fn``: parameters annotated
    ``torch.Tensor``, names whose in-place method (``x.add_(...)``) the
    function calls, and names assigned from ``torch`` calls, from a
    tensor's methods, subscripts and arithmetic (two passes)."""
    tensors = {
        p.arg for p in _all_params(fn)
        if _annotation_names(p.annotation) & {"torch.Tensor", "Tensor"}
    }
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.attr.endswith("_")
                and not node.func.attr.startswith("_")):
            tensors.add(node.func.value.id)

    def derived(v) -> bool:
        if isinstance(v, ast.Name):
            return v.id in tensors
        if isinstance(v, ast.Subscript):
            return derived(v.value)
        if isinstance(v, (ast.BinOp,)):
            return derived(v.left) or derived(v.right)
        if isinstance(v, ast.UnaryOp):
            return derived(v.operand)
        if isinstance(v, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in v.ops):
                return False
            return derived(v.left) or any(derived(c) for c in v.comparators)
        if isinstance(v, ast.Call):
            name = _dotted(v.func) or ""
            if _is_torch_tensor_call(name):
                return True
            if isinstance(v.func, ast.Attribute):
                if v.func.attr in _STATIC_METHODS | {"item", "tolist"}:
                    return False
                return derived(v.func.value)
        return False

    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and derived(node.value):
                for tgt in node.targets:
                    tensors |= {n.id for n in ast.walk(tgt)
                                if isinstance(n, ast.Name)}
    return tensors


def _test_uses_tensor(node: ast.expr, tensors: set[str]) -> bool:
    """Does a branch test read a tensor in a way Python must take a bool
    of?  Static predicates are excluded."""
    if isinstance(node, ast.BoolOp):
        return any(_test_uses_tensor(v, tensors) for v in node.values)
    if isinstance(node, ast.UnaryOp):
        return _test_uses_tensor(node.operand, tensors)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False
        return _test_uses_tensor(node.left, tensors) or any(
            _test_uses_tensor(c, tensors) for c in node.comparators
        )
    if isinstance(node, ast.Call):
        name = _dotted(node.func) or ""
        if name.rsplit(".", 1)[-1] in _SAFE_CALLS | _STATIC_METHODS:
            return False
        if _is_torch_tensor_call(name):
            return True
        if isinstance(node.func, ast.Attribute) and _test_uses_tensor(
                node.func.value, tensors):
            return True
        return any(_test_uses_tensor(a, tensors) for a in node.args)
    if isinstance(node, ast.Attribute):
        # attribute reads are config/shape access until proven tensor —
        # direct Name references are the signal this lint keys on.
        return False
    if isinstance(node, ast.Subscript):
        return _test_uses_tensor(node.value, tensors)
    if isinstance(node, ast.BinOp):
        return (_test_uses_tensor(node.left, tensors)
                or _test_uses_tensor(node.right, tensors))
    if isinstance(node, ast.Name):
        return node.id in tensors
    return False


def _bool_reads(test: ast.expr):
    """Calls of ``torch.any`` / ``.all()``-style reductions that a test
    takes a Python bool of (through ``not`` / ``and`` / ``or``)."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        yield from _bool_reads(test.operand)
    elif isinstance(test, ast.BoolOp):
        for v in test.values:
            yield from _bool_reads(v)
    elif isinstance(test, ast.Call):
        name = _dotted(test.func) or ""
        if tuple(name.split(".")) in _BOOL_REDUCE_DOTTED or (
                isinstance(test.func, ast.Attribute)
                and test.func.attr in _BOOL_REDUCE_METHODS):
            yield test


def _sync_call_kind(node: ast.Call, safe_names: set[str]) -> str | None:
    """The host-sync pattern this call matches, or None."""
    if isinstance(node.func, ast.Attribute):
        if node.func.attr in _SYNC_METHODS:
            return f".{node.func.attr}()"
        name = _dotted(node.func)
        if name and tuple(name.split(".")) in _SYNC_DOTTED:
            return name
    elif isinstance(node.func, ast.Name) and node.func.id in _SYNC_BARE:
        if not node.args:
            return None
        arg = node.args[0]
        if isinstance(arg, ast.Constant) or _is_static_expr(arg):
            return None
        if isinstance(arg, ast.Name) and arg.id in safe_names:
            return None
        return f"{node.func.id}()"
    return None


class _Suppressions:
    """Per-file ``# analysis: ignore[rule]`` index.  A marker covers
    its own line (trailing comment) or, when it sits in a comment-only
    block, every line of that block plus the next source line."""

    def __init__(self, source: str):
        self.by_line: dict[int, set[str] | None] = {}
        lines = source.splitlines()
        for i, text in enumerate(lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = m.group(1)
            parsed = (
                {r.strip() for r in rules.split(",")} if rules else None
            )
            covered = [i]
            if text.lstrip().startswith("#"):
                # comment-only marker: extend through the rest of the
                # comment block to the first source line below
                j = i
                while j < len(lines) and lines[j].lstrip().startswith("#"):
                    j += 1
                    covered.append(j)
                covered.append(j + 1)
            for ln in covered:
                prev = self.by_line.get(ln, set())
                if parsed is None or prev is None:
                    self.by_line[ln] = None   # None = all rules
                else:
                    self.by_line[ln] = prev | parsed

    def covers(self, line: int, rule: str) -> bool:
        rules = self.by_line.get(line, ())
        return rules is None or (rules != () and rule in rules)


def _is_tracer_none_test(test: ast.expr) -> tuple[bool, bool]:
    """(is a ``tracer is None``-family test, truthy-branch-means-absent).

    Compound ``and`` tests (``tracer is not None and timing``) count as
    guards: their truthy branch can only run with a tracer present.
    """
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            ok, absent = _is_tracer_none_test(v)
            if ok:
                return ok, absent
        return False, False
    if not isinstance(test, ast.Compare) or len(test.ops) != 1:
        return False, False
    if not isinstance(test.ops[0], (ast.Is, ast.IsNot)):
        return False, False
    comp = test.comparators[0]
    if not (isinstance(comp, ast.Constant) and comp.value is None):
        return False, False
    if not _tracer_exprs(test.left):
        return False, False
    return True, isinstance(test.ops[0], ast.Is)


def _tracer_exprs(node: ast.expr) -> bool:
    """Does an expression read a tracer (``tracer`` name or ``*.tracer``
    attribute)?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == "tracer":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "tracer":
            return True
    return False


def _returns(body: list[ast.stmt]) -> bool:
    return any(isinstance(s, (ast.Return, ast.Raise)) for s in body)


def _early_tracer_return_line(fn) -> int | None:
    """Line of a top-level ``if tracer is None: return`` fast path."""
    for stmt in fn.body:
        if isinstance(stmt, ast.If):
            ok, absent = _is_tracer_none_test(stmt.test)
            if ok and absent and _returns(stmt.body):
                return stmt.lineno
    return None


def _hot_prefixes(rel_path: str) -> tuple[str, ...]:
    for suffix, prefixes in HOT_PATHS.items():
        if rel_path.endswith(suffix):
            return prefixes
    return ()


def _is_hot(qualname: str, prefixes: tuple[str, ...]) -> bool:
    return any(
        qualname == p or qualname.startswith(p + ".") for p in prefixes
    )


# --------------------------------------------------------------------------
# per-file linter: host-sync, swallowed-error, tracer-gate
# --------------------------------------------------------------------------

class _Ctx:
    """Walk context: enclosing qualname, active tracer guards, and names
    safe to cast (host scalars)."""

    __slots__ = ("qual", "guards", "safe_names")

    def __init__(self, qual="", guards=(), safe_names=frozenset()):
        self.qual = qual
        self.guards = guards
        self.safe_names = safe_names

    def with_(self, **kw) -> "_Ctx":
        new = _Ctx(self.qual, self.guards, self.safe_names)
        for k, v in kw.items():
            setattr(new, k, v)
        return new


class _FileLinter:
    def __init__(self, rel_path: str, source: str, tree: ast.Module):
        self.rel = rel_path
        self.tree = tree
        self.suppress = _Suppressions(source)
        self.hot = _hot_prefixes(rel_path)
        self.findings: list[Finding] = []

    def run(self) -> list[Finding]:
        ctx = _Ctx()
        for stmt in self.tree.body:
            self._walk_stmt(stmt, ctx)
        return self.findings

    # -- emit --------------------------------------------------------------

    def _emit(self, rule, node, scope, message, classification="finding"):
        line = getattr(node, "lineno", 0)
        if classification == "finding" and self.suppress.covers(line, rule):
            classification = "suppressed"
        self.findings.append(Finding(
            rule=rule, path=self.rel, line=line, scope=scope,
            message=message, classification=classification,
        ))

    # -- traversal ---------------------------------------------------------

    def _walk_stmt(self, stmt: ast.stmt, ctx: _Ctx) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._enter_function(stmt, ctx)
            return
        if isinstance(stmt, ast.ClassDef):
            inner = ctx.with_(qual=self._join(ctx.qual, stmt.name))
            for s in stmt.body:
                self._walk_stmt(s, inner)
            return
        if isinstance(stmt, (ast.If, ast.While, ast.Assert)):
            for call in _bool_reads(stmt.test):
                self._sync(call, f"{_dotted(call.func)}() as a bool", ctx)
        if isinstance(stmt, ast.Try):
            self._check_swallowed(stmt, ctx)
        if isinstance(stmt, ast.If):
            is_tracer, absent = _is_tracer_none_test(stmt.test)
            if is_tracer and not absent:
                # truthy branch runs only with a tracer present
                self._walk_expr(stmt.test, ctx)
                on = ctx.with_(guards=ctx.guards + ("tracer",))
                for s in stmt.body:
                    self._walk_stmt(s, on)
                for s in stmt.orelse:
                    self._walk_stmt(s, ctx)
                return
        self._walk_children(stmt, ctx)

    def _walk_children(self, node: ast.AST, ctx: _Ctx) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._enter_function(child, ctx)
            elif isinstance(child, ast.ClassDef):
                self._walk_stmt(child, ctx)
            elif isinstance(child, ast.stmt):
                self._walk_stmt(child, ctx)
            elif isinstance(child, ast.expr):
                self._walk_expr(child, ctx)
            else:  # withitem, ExceptHandler, keyword, arguments, ...
                self._walk_children(child, ctx)

    def _walk_expr(self, node: ast.expr, ctx: _Ctx) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                kind = _sync_call_kind(sub, ctx.safe_names)
                if kind is not None:
                    self._sync(sub, kind, ctx)

    # -- host-sync ---------------------------------------------------------

    def _sync(self, node: ast.Call, kind: str, ctx: _Ctx) -> None:
        scope = ctx.qual or "<module>"
        if not self.hot or not _is_hot(scope, self.hot):
            self._emit("host-sync", node, scope, f"{kind} (cold path)",
                       classification="cold-path")
        elif "tracer" in ctx.guards:
            self._emit("host-sync", node, scope,
                       f"{kind} inside a tracer guard",
                       classification="guarded")
        else:
            self._emit(
                "host-sync", node, scope,
                f"{kind} on hot path `{scope}` outside any tracer guard",
            )

    # -- swallowed-error ---------------------------------------------------

    def _check_swallowed(self, stmt: ast.Try, ctx: _Ctx) -> None:
        """Bare/broad ``except`` that discards the error.  On the serve /
        superstep hot paths this is a finding (a fault silently eaten
        there breaks the every-request-resolves invariant); elsewhere
        it is reported as a cold-path count."""
        scope = ctx.qual or "<module>"
        hot = bool(self.hot) and _is_hot(scope, self.hot)
        for h in stmt.handlers:
            if not _broad_handler(h) or _handler_routes(h):
                continue
            what = (
                "bare `except:`" if h.type is None
                else "broad `except`"
            )
            if hot:
                self._emit(
                    "swallowed-error", h, scope,
                    f"{what} on hot path `{scope}` discards the error "
                    "without routing it through the faults taxonomy",
                )
            else:
                self._emit(
                    "swallowed-error", h, scope, f"{what} (cold path)",
                    classification="cold-path",
                )

    # -- function entry ----------------------------------------------------

    def _enter_function(self, fn, ctx: _Ctx) -> None:
        fq = self._join(ctx.qual, fn.name)
        self._check_tracer_gate(fn, fq)
        inner = ctx.with_(
            qual=fq, guards=(),
            safe_names=frozenset(_static_names(fn) | ctx.safe_names),
        )
        guard_line = _early_tracer_return_line(fn)
        if guard_line is None:
            for s in fn.body:
                self._walk_stmt(s, inner)
            return
        # `if tracer is None: return ...` — everything after runs
        # tracer-present.
        guarded = inner.with_(guards=("tracer",))
        for s in fn.body:
            self._walk_stmt(s, inner if s.lineno <= guard_line else guarded)

    def _check_tracer_gate(self, fn, fq: str) -> None:
        if "tracer" not in {
            p.arg for p in (
                fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
            )
        }:
            return
        span_calls = []
        has_guard = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = _dotted(node.func) or ""
                if name in ("tracer.span", "tracer.block"):
                    span_calls.append(node)
                if name.rsplit(".", 1)[-1] == "maybe_span":
                    has_guard = True
            if isinstance(node, ast.If):
                ok, _ = _is_tracer_none_test(node.test)
                has_guard = has_guard or ok
        if span_calls and not has_guard:
            self._emit(
                "tracer-gate", span_calls[0], fq,
                "calls tracer.span/block with no `tracer is None` "
                "fast path",
            )

    @staticmethod
    def _join(qual: str, name: str) -> str:
        return f"{qual}.{name}" if qual else name


# --------------------------------------------------------------------------
# capture-sync: the captured regions and what they call, package-wide
# --------------------------------------------------------------------------

class _Module:
    """One parsed module: its functions by qualname, its classes, and
    what its imports bind (``alias -> module`` or ``alias -> (module,
    name)``), function-level imports included."""

    def __init__(self, dotted: str, rel: str, source: str, tree, is_pkg):
        self.dotted, self.rel, self.tree = dotted, rel, tree
        self.suppress = _Suppressions(source)
        self.defs: dict[str, ast.AST] = {}
        self.classes: set[str] = set()
        self.modules: dict[str, str] = {}
        self.names: dict[str, tuple[str, str]] = {}
        self._index(tree.body, "")
        package = dotted if is_pkg else dotted.rpartition(".")[0]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name.partition(".")[0]
                    self.modules[alias] = a.asname and a.name or alias
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = package.split(".")
                    parts = parts[:len(parts) - node.level + 1]
                    base = ".".join(p for p in (*parts, base) if p)
                for a in node.names:
                    alias = a.asname or a.name
                    self.names[alias] = (base, a.name)

    def _index(self, body, prefix: str) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{node.name}"
                self.defs[q] = node
                self._index(node.body, q + ".")
            elif isinstance(node, ast.ClassDef):
                if not prefix:
                    self.classes.add(node.name)
                self._index(node.body, f"{prefix}{node.name}.")
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                self._index(getattr(node, "body", []), prefix)


class _Package:
    """Every module of one package tree, and the methods by name."""

    def __init__(self, modules: list[_Module]):
        self.by_name = {m.dotted: m for m in modules}
        self.methods: dict[str, list[tuple[_Module, str]]] = {}
        for m in modules:
            for q in m.defs:
                head, _, leaf = q.rpartition(".")
                if head and head.split(".")[0] in m.classes:
                    self.methods.setdefault(leaf, []).append((m, q))

    def function(self, module: str, name: str):
        """``(module, qualname)`` of a package function, or None; a name
        imported from a package's ``__init__`` is followed once."""
        mod = self.by_name.get(module)
        if mod is None:
            return None
        if name in mod.defs:
            return mod, name
        if name in mod.names:
            sub, real = mod.names[name]
            target = self.by_name.get(sub)
            if target is not None and real in target.defs:
                return target, real
        return None


def _is_graph_capture(item: ast.withitem) -> bool:
    expr = item.context_expr
    if not isinstance(expr, ast.Call):
        return False
    name = _dotted(expr.func) or ""
    return name in ("torch.cuda.graph", "cuda.graph",
                    "torch.cuda.graphs.graph")


class _CaptureWalk:
    """Follows every ``with torch.cuda.graph(...)`` body through the
    package-local functions it reaches, and flags host reads and
    tensor branches there."""

    def __init__(self, package: _Package):
        self.pkg = package
        self.findings: list[Finding] = []
        # capture site -> the ``module:qualname`` of every function
        # its region reaches
        self.reached: dict[str, set[str]] = {}
        self._seen_sites: set[tuple[str, int, str]] = set()

    def run(self) -> list[Finding]:
        for mod in self.pkg.by_name.values():
            for qual, fn in mod.defs.items():
                for node in self._own_nodes(fn):
                    if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                            _is_graph_capture(i) for i in node.items):
                        self._region(mod, qual, fn, node)
        return self.findings

    @staticmethod
    def _own_nodes(fn):
        """Nodes of ``fn``'s body, not descending into nested defs."""
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                    stack.append(child)

    def _region(self, mod, qual, fn, with_node) -> None:
        where = f"{mod.rel}:{with_node.lineno}"
        queue = [(mod, qual, fn, with_node.body, (qual,))]
        visited = {(mod.dotted, qual)}
        self.reached[where] = {f"{m}:{q}" for m, q in visited}
        while queue:
            m, q, f, body, chain = queue.pop(0)
            for target in self._scan(m, q, f, body, where, chain):
                tm, tq = target
                if (tm.dotted, tq) in visited:
                    continue
                visited.add((tm.dotted, tq))
                self.reached[where].add(f"{tm.dotted}:{tq}")
                tf = tm.defs[tq]
                queue.append((tm, tq, tf, tf.body, chain + (tq,)))
                # nested defs of a reached function are reached too
                for nq, nf in tm.defs.items():
                    if nq.startswith(tq + ".") and (tm.dotted, nq) \
                            not in visited:
                        visited.add((tm.dotted, nq))
                        self.reached[where].add(f"{tm.dotted}:{nq}")
                        queue.append((tm, nq, nf, nf.body, chain + (nq,)))

    def _scan(self, mod, qual, fn, body, where, chain):
        """Check the statements of one reached body; return the package
        functions it calls or passes on."""
        static = _static_names(fn)
        tensors = _tensor_locals(fn)
        reached = []
        stack = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            stack.extend(ast.iter_child_nodes(node))
            if isinstance(node, (ast.If, ast.While, ast.Assert)):
                reads = list(_bool_reads(node.test))
                for call in reads:
                    self._emit(mod, call, qual,
                               f"{_dotted(call.func)}() as a bool", where,
                               chain)
                if not reads and not isinstance(node, ast.Assert) and \
                        _test_uses_tensor(node.test, tensors):
                    kind = "while" if isinstance(node, ast.While) else "if"
                    self._emit(mod, node, qual, f"`{kind}` on a tensor",
                               where, chain)
            if not isinstance(node, ast.Call):
                continue
            kind = _sync_call_kind(node, static)
            if kind is not None:
                self._emit(mod, node, qual, kind, where, chain)
            if mod.suppress.covers(node.lineno, "capture-sync"):
                continue  # a call the capture never makes: not followed
            # the callee, and functions passed on by name (``tree_map(one,
            # ...)``, ``send=send``), which the callee is likely to call
            passed = [a for a in [*node.args,
                                  *(k.value for k in node.keywords)]
                      if isinstance(a, (ast.Name, ast.Lambda))]
            for expr in [node.func, *passed]:
                reached += self._resolve(mod, qual, fn, expr, depth=0)
        return reached

    def _emit(self, mod, node, qual, kind, where, chain) -> None:
        key = (mod.rel, node.lineno, kind)
        if key in self._seen_sites:
            return
        self._seen_sites.add(key)
        cls = ("suppressed" if mod.suppress.covers(node.lineno,
                                                   "capture-sync")
               else "finding")
        path = " -> ".join(chain)
        self.findings.append(Finding(
            rule="capture-sync", path=mod.rel, line=node.lineno,
            scope=qual or "<module>",
            message=(f"{kind} inside the CUDA-graph capture at {where} "
                     f"(via {path})"),
            classification=cls,
        ))

    # -- name resolution ---------------------------------------------------

    def _resolve(self, mod, qual, fn, expr, depth):
        """Package functions an expression may name."""
        if depth > 3 or expr is None:
            return []
        if isinstance(expr, ast.Lambda):
            out = []
            for sub in ast.walk(expr.body):
                if isinstance(sub, ast.Call):
                    out += self._resolve(mod, qual, fn, sub.func, depth + 1)
            return out
        if isinstance(expr, ast.IfExp):
            return (self._resolve(mod, qual, fn, expr.body, depth + 1)
                    + self._resolve(mod, qual, fn, expr.orelse, depth + 1))
        if isinstance(expr, ast.Name):
            return self._resolve_name(mod, qual, fn, expr.id, depth)
        if isinstance(expr, ast.Attribute):
            return self._resolve_attr(mod, qual, expr)
        return []

    def _resolve_name(self, mod, qual, fn, name, depth):
        parts = qual.split(".") if qual else []
        for i in range(len(parts), -1, -1):
            q = ".".join(parts[:i] + [name])
            if q in mod.defs and q != qual:
                return [(mod, q)]
        if name in mod.names:
            hit = self.pkg.function(*mod.names[name])
            if hit is not None:
                return [hit]
        out = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name
                    for t in node.targets):
                out += self._resolve(mod, qual, fn, node.value, depth + 1)
        a = fn.args
        defaults = list(zip(reversed(a.posonlyargs + a.args),
                            reversed(a.defaults)))
        defaults += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                     if d is not None]
        for p, d in defaults:
            if p.arg == name:
                out += self._resolve(mod, qual, fn, d, depth + 1)
        return out

    def _resolve_attr(self, mod, qual, expr):
        attr, value = expr.attr, expr.value
        if isinstance(value, ast.Name):
            head = qual.split(".")[0] if qual else ""
            if value.id in ("self", "cls") and head in mod.classes:
                q = f"{head}.{attr}"
                return [(mod, q)] if q in mod.defs else []
            target = mod.modules.get(value.id)
            if target is None and value.id in mod.names:
                base, name = mod.names[value.id]
                target = f"{base}.{name}"
            if target is not None:
                if target in self.pkg.by_name:
                    hit = self.pkg.function(target, attr)
                    return [hit] if hit is not None else []
                return []  # another package's module: not followed
        methods = self.pkg.methods.get(attr, [])
        return list(methods) if len(methods) == 1 else []


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def _parse(path: Path, rel: str):
    source = path.read_text()
    try:
        return source, ast.parse(source), None
    except SyntaxError as err:
        return source, None, Finding(
            rule="host-sync", path=rel, line=err.lineno or 0,
            scope="<module>", message=f"unparseable: {err.msg}",
        )


def _dotted_module(path: Path, pkg_root: Path) -> tuple[str, bool]:
    rel = path.relative_to(pkg_root.parent).with_suffix("")
    parts = list(rel.parts)
    is_pkg = parts[-1] == "__init__"
    if is_pkg:
        parts = parts[:-1]
    return ".".join(parts), is_pkg


def _parse_tree(paths, pkg_root, repo):
    findings: list[Finding] = []
    modules = []
    for path in paths:
        path = path.resolve()
        rel = str(path.relative_to(repo)) if repo else str(path)
        source, tree, bad = _parse(path, rel)
        if bad is not None:
            findings.append(bad)
            continue
        findings.extend(_FileLinter(rel, source, tree).run())
        dotted, is_pkg = _dotted_module(path, pkg_root)
        modules.append(_Module(dotted, rel, source, tree, is_pkg))
    return findings, _CaptureWalk(_Package(modules))


def _lint_paths(paths: list[Path], pkg_root: Path, repo: Path | None
                ) -> list[Finding]:
    findings, walk = _parse_tree(paths, pkg_root, repo)
    return findings + walk.run()


def capture_reach(root: str | Path) -> dict[str, set[str]]:
    """Each ``torch.cuda.graph`` capture site under the package
    directory ``root`` -> the ``module:qualname`` of every function the
    capture-sync rule follows from it."""
    root = Path(root).resolve()
    _, walk = _parse_tree(sorted(root.rglob("*.py")), root, _repo_root(root))
    walk.run()
    return walk.reached


def lint_file(path: str | Path, root: str | Path | None = None
              ) -> list[Finding]:
    """Lint one file (the capture rule follows calls within it only)."""
    path = Path(path).resolve()
    repo = Path(root).resolve() if root else None
    return _lint_paths([path], path.parent, repo)


def lint_tree(root: str | Path) -> list[Finding]:
    """Lint every ``.py`` under the package directory ``root`` (paths
    reported relative to the repo root when ``root`` sits inside one);
    the capture rule follows calls across its modules."""
    root = Path(root).resolve()
    paths = sorted(root.rglob("*.py"))
    return _lint_paths(paths, root, _repo_root(root))


def _repo_root(start: Path) -> Path | None:
    p = start.resolve()
    for cand in (p, *p.parents):
        if (cand / ".git").exists() or (cand / "pyproject.toml").exists():
            return cand
    return None
