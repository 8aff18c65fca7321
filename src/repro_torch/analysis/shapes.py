"""Shape agreement between the two delivery lowerings, and the card's
shared-memory budgets for the port's six kernels (the port's
counterpart of the JAX package's ``repro.analysis.shapes``, whose VMEM
model is a TPU's: the H100 has none).

* **Shape agreement** (``shape-mismatch``) — the delivery axis is a
  pure design choice only if both lowerings of one leaf agree on output
  shape AND dtype for every degree-class layout / monoid / message
  width: ``kernels/deliver/xla.py``'s ``deliver_ell_leaf`` and the fused
  leaf (``kernels/deliver``'s ``_pallas_leaf``: its plain twin on the
  CPU, the K1 kernel on the card).  Torch has no ``eval_shape``: the
  grid is small and runs for real.

* **Shared-memory budget** (``smem-budget``) — a block gets 49,152
  bytes of shared memory (``DEFAULT_BYTES``) unless its launcher opts in
  with ``cudaFuncSetAttribute``, and at most 232,448 (``OPTIN_BYTES``)
  when it does; a launch above that is refused on the card only.  For
  every template instantiation of every kernel the wrappers launch
  (``instantiations``), the model takes

  - the **static** bytes of its ``__shared__`` arrays, read from the
    source: each declaration's type size times its dimensions, the
    dimensions evaluated with the source's ``constexpr`` constants, the
    kernel's own local ``constexpr``s and the instantiation's template
    arguments, the total rounded up to 16 bytes (as ``ptxas -v``
    reports it: the card's phase 15 holds every entry function's
    number equal to ``ptxas``'s);
  - the **dynamic** bytes at the worst geometry the wrapper admits, from
    the plan or geometry function it launches with: ``fused.py``'s
    ``class_span`` bounded by ``_MAX_SPAN`` (K1's ``(span + 1)`` row
    starts and ``kStage`` staged ids), ``segsum.py``'s ``k2a_geometry``
    (K2a's tile and row bins) and ``k2b_geometry`` (K2b's offsets and
    staged rows), ``isect.cu``'s ring (K3a), ``flash_plan`` at every
    head dim 1-256 in both types (K4, its three routes), and
    ``flash_bwd_plan`` at every head dim in both types for the backward
    kernels (``flash_bwd.cu``, FMA, bf16 and TF32 tensor-core routes,
    counted under K4: they have no TPU kernel of their own);
  - whether its launcher calls ``cudaFuncSetAttribute``, read from the
    source.

  and checks static + dynamic against the limit that applies.  Every
  Python mirror of a source constant that the wrappers size launches by
  is checked equal to the source (``MIRRORS``), and every kernel's
  ``__shared__`` arrays in the source must be the ones the model counts.

* **Width gate** — every message width ``select_delivery`` can pick
  (``FUSED_MAX_WIDTH_BYTES``) fits at worst geometry.  K1's bytes do not
  depend on the width (it stages row starts and sender ids, never a
  row), so the gate binds on K2a's column slicing (the tile is
  ``block_n x d_slice`` float32, sliced to fit) and on K4's head dim
  (at most 256, ``flash_plan``).

``shape_budget_audit(device=None)`` is the CLI pass: the shape grid on
the card unless the caller asks for the CPU, then the budgets (host
arithmetic over the sources).
"""
from __future__ import annotations

import dataclasses
import re
from functools import lru_cache
from pathlib import Path

import numpy as np

from repro_torch.analysis.findings import Finding

# What the card gives a block: ``cudaDevAttrMaxSharedMemoryPerBlock`` (no
# opt-in) and ``cudaDevAttrMaxSharedMemoryPerBlockOptin`` on an H100.
DEFAULT_BYTES = 49_152
OPTIN_BYTES = 232_448

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("deliver_fused.cu", "segsum.cu", "isect.cu", "flash.cu",
           "flash_bwd.cu")

_TYPE_BYTES = {
    "int": 4, "unsigned": 4, "float": 4, "int32_t": 4, "uint32_t": 4,
    "int64_t": 8, "long long": 8, "uint16_t": 2, "int4": 16, "int2": 8,
    "uint8_t": 1, "char": 1,
}
_STATIC_ALIGN = 16


# --------------------------------------------------------------------------
# reading the sources
# --------------------------------------------------------------------------

def _c_eval(expr: str, names: dict) -> int:
    """An integer C expression over known names: literals, + - * / %
    << >>, parentheses and one ``a ? b : c``."""
    expr = re.sub(r"\b(0x[0-9a-fA-F]+|\d+)[uUlL]+\b", r"\1", expr.strip())
    m = re.fullmatch(r"(.+?)\?(.+?):(.+)", expr)
    if m:
        cond, yes, no = m.groups()
        return _c_eval(yes if _c_eval(cond, names) else no, names)
    expr = expr.replace("/", "//").replace("true", "1").replace(
        "false", "0")
    if not re.fullmatch(r"[\w\s+\-*/%<>=!()&|]*", expr):
        raise ValueError(f"not a constant expression: {expr!r}")
    for tok in set(re.findall(r"[A-Za-z_]\w*", expr)):
        if tok not in names:
            raise KeyError(tok)
    return int(eval(expr, {"__builtins__": {}}, dict(names)))


@lru_cache(maxsize=None)
def _read(name: str) -> str:
    return (CSRC / name).read_text()


def source_constants(name: str, text: str | None = None) -> dict[str, int]:
    """The integer ``constexpr`` constants at namespace level of
    ``csrc/<name>``, by name and by ``namespace::name`` (the named
    namespaces of ``flash.cu`` repeat names)."""
    text = _read(name) if text is None else text
    out: dict[str, int] = {}
    spaces: list[str] = []
    for line in text.splitlines():
        m = re.match(r"namespace\s*(\w*)\s*\{", line)
        if m:
            spaces.append(m.group(1))
            continue
        if re.match(r"\}\s*//\s*namespace", line):
            spaces.pop()
            continue
        m = re.match(r"constexpr\s+(?:int|unsigned|size_t|long long)\s+"
                     r"(\w+)\s*=\s*(.+?);", line)
        if not m:
            continue
        scope = dict(out)
        if spaces and spaces[-1]:   # this namespace's names come first
            scope.update({k.rsplit("::", 1)[-1]: v for k, v in out.items()
                          if k.startswith(spaces[-1] + "::")})
        try:
            value = _c_eval(m.group(2), scope)
        except (KeyError, ValueError, SyntaxError):
            continue
        named = [s for s in spaces if s]
        key = "::".join(named + [m.group(1)])
        out[key] = value
        out.setdefault(m.group(1), value)
    return out


def _block_at(text: str, open_at: int) -> str:
    """The text of the brace block that opens at ``open_at``."""
    depth = 0
    for i in range(open_at, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return text[open_at:i + 1]
    raise ValueError("unbalanced braces")


@dataclasses.dataclass(frozen=True)
class _Kernel:
    name: str
    params: tuple          # template parameter names, in order
    namespace: str         # the innermost named namespace, or ""
    arrays: tuple          # (type, name, dims) of its static __shared__
    local: tuple           # (name, expr) of its body's constexpr ints


def source_kernels(name: str, text: str | None = None) -> dict[str, _Kernel]:
    """Every ``__global__`` kernel of ``csrc/<name>``: its template
    parameters and its static ``__shared__`` declarations."""
    text = _read(name) if text is None else text
    out = {}
    for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\("
                         r"[^)]*\)\s+)?(\w+)\s*\(", text):
        head = text[:m.start()]
        t = re.search(r"template\s*<([^>]*)>\s*$", head)
        params = tuple(p.split()[-1] for p in t.group(1).split(",")) \
            if t else ()
        spaces = re.findall(r"namespace\s+(\w+)\s*\{", head)
        closed = re.findall(r"\}\s*//\s*namespace\s+(\w+)", head)
        open_ns = [s for s in spaces if s not in closed]
        body = _block_at(text, text.index("{", m.end()))
        arrays, local = [], []
        for d in re.finditer(r"^\s*(?!extern)__shared__\s+(?:__align__\(\d+"
                             r"\)\s+)?([\w:]+(?:\s+long)?)\s+([^;]+);", body,
                             re.M):
            for part in d.group(2).split(","):
                pm = re.match(r"\s*(\w+)((?:\[[^\]]+\])*)", part)
                dims = tuple(re.findall(r"\[([^\]]+)\]", pm.group(2)))
                arrays.append((d.group(1), pm.group(1), dims))
        for c in re.finditer(r"constexpr\s+int\s+(\w+)\s*=\s*([^;]+);",
                             body):
            local.append((c.group(1), c.group(2)))
        out[m.group(1)] = _Kernel(m.group(1), params,
                                  open_ns[-1] if open_ns else "",
                                  tuple(arrays), tuple(local))
    return out


def _targ_value(arg: str) -> int:
    """A template argument's value (a type argument sizes no array)."""
    if arg in ("true", "false"):
        return int(arg == "true")
    return int(arg) if re.fullmatch(r"-?\d+", arg) else 0


def static_bytes(source: str, kernel: str, targs: tuple) -> int:
    """Static shared memory of one instantiation of ``kernel`` in
    ``csrc/<source>``: its ``__shared__`` arrays, read from the source,
    rounded up to 16 bytes."""
    k = source_kernels(source)[kernel]
    consts = source_constants(source)
    names = {key.rsplit("::", 1)[-1]: v for key, v in consts.items()
             if "::" not in key}
    if k.namespace:
        names.update({key.rsplit("::", 1)[-1]: v for key, v in
                      consts.items() if key.startswith(k.namespace + "::")})
    names.update({p: _targ_value(a) for p, a in zip(k.params, targs)})
    for lname, expr in k.local:
        try:
            names[lname] = _c_eval(expr, names)
        except (KeyError, ValueError, SyntaxError):
            pass  # a local the arrays do not size by
    total = 0
    for typ, _, dims in k.arrays:
        size = _TYPE_BYTES[typ]
        for d in dims:
            size *= _c_eval(d, names)
        total += size
    return -(-total // _STATIC_ALIGN) * _STATIC_ALIGN


def _function_body(text: str, name: str, after: str = "") -> str:
    """The body of the first definition of function ``name`` (after the
    first occurrence of ``after``)."""
    start = text.index(after) if after else 0
    m = re.search(rf"\b{name}\s*\([^;{{]*\)\s*\{{", text[start:])
    if m is None:
        raise ValueError(f"no definition of {name}")
    return _block_at(text, start + m.end() - 1)


def opts_in(source: str, launcher: str, after: str = "") -> bool:
    """Does ``launcher`` in ``csrc/<source>`` call
    ``cudaFuncSetAttribute`` (the opt-in above 48 KB)?"""
    return "cudaFuncSetAttribute" in _function_body(_read(source), launcher,
                                                     after)


# --------------------------------------------------------------------------
# the model: what each launch site may ask for
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaunchBudget:
    """One instantiation's shared memory at its worst admitted geometry."""

    kernel: str        # K1, K2a, K2b, K3a, K3b, K4
    entry: str         # the template instantiation, as the source names it
    source: str        # csrc file
    static: int        # its __shared__ arrays
    dynamic: int       # worst dynamic bytes the wrapper's geometry admits
    opt_in: bool       # its launcher calls cudaFuncSetAttribute
    where: str         # what the dynamic bytes come from

    @property
    def limit(self) -> int:
        return OPTIN_BYTES if self.opt_in else DEFAULT_BYTES

    @property
    def total(self) -> int:
        return self.static + self.dynamic


def entry_name(kernel: str, targs: tuple) -> str:
    return f"{kernel}<{', '.join(targs)}>" if targs else kernel


def k1_dynamic(max_span: int) -> int:
    """K1's dynamic bytes (``launch_k`` in ``deliver_fused.cu``):
    ``max_span + 1`` int64 row starts, then ``kStage`` int32 ids."""
    return (max_span + 1) * 8 + source_constants("deliver_fused.cu")[
        "kStage"] * 4


def k1_worst_span() -> int:
    """The widest span a launch may carry: the source's ``kMaxSpan`` (it
    refuses more), which bounds ``class_span`` at any class size and
    ``block_n`` (checked over a grid)."""
    from repro_torch.kernels.deliver import fused

    worst = max(fused.class_span(nnz, rows, bn)
                for bn in (1, 3, 64, 128, 1000, 4096)
                for rows in (1, 7, 128, 4096, 10**6)
                for nnz in (rows, 4 * rows, 1000 * rows))
    return max(worst, fused._MAX_SPAN)


def k2a_worst() -> dict[tuple, int]:
    """Largest ``k2a_geometry`` tile + bins per ``(itemsize, vec)`` over
    ``block_n`` and widths (the bound the geometry keeps is
    ``K2A_SMEM_BYTES``)."""
    from repro_torch.kernels.segsum.segsum import (
        K2A_MAX_ROWS,
        K2A_SMEM_BYTES,
        k2a_geometry,
    )

    worst: dict[tuple, int] = {}
    for itemsize in (4, 2):
        for aligned in (True, False):
            for bn in sorted({1, 2, 3, 7, 8, 32, 64, 100, 128, 256, 512,
                              1000, 1024, 2048, 4095, K2A_MAX_ROWS}):
                fit = max(1, (K2A_SMEM_BYTES - 4 * bn) // (4 * bn))
                for d in sorted({1, 2, 4, 8, 16, 64, 256, fit, fit + 1,
                                 fit * 2 + 3, 8 * fit}):
                    g = k2a_geometry(1 << 20, 1 << 20, d, itemsize, bn, 512,
                                     aligned)
                    key = (itemsize, g.vec)
                    worst[key] = max(worst.get(key, 0), g.smem_bytes)
    return worst


def _largest_admitted(fn, lo: int = 1, hi: int = 1 << 20) -> int:
    """The largest x in [lo, hi) with fn(x) not raising ValueError."""
    if _raises(fn, lo):
        return 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if _raises(fn, mid) else (mid, hi)
    return lo


def _raises(fn, x) -> bool:
    try:
        fn(x)
    except ValueError:
        return True
    return False


# The (dtype, d, aligned) cases that reach each k2b_kernel template (its
# segsum_sorted_launch branches).
K2B_CASES = {
    ("float", "1", "true"): [(4, 1, True)],
    ("__nv_bfloat16", "1", "true"): [(2, 1, True)],
    ("__nv_bfloat16", "2", "true"): [(2, 2, True)],
    ("float", "4", "false"): [(4, 4, True), (4, 64, True)],
    ("float", "1", "false"): [(4, 2, True), (4, 3, True), (4, 64, False)],
    ("__nv_bfloat16", "8", "false"): [(2, 8, True), (2, 64, True)],
    ("__nv_bfloat16", "1", "false"): [(2, 3, True), (2, 64, False)],
}


def k2b_worst(targs: tuple) -> tuple[int, int]:
    """(largest dynamic bytes, its block_e) that ``k2b_geometry`` admits
    for the cases of one template: over block_e, both when a block takes
    its full share of items (a large input) and when the grid halves it
    down to ``block_e`` (a small one)."""
    from repro_torch.kernels.segsum.segsum import k2b_geometry

    best = (0, 0)
    for itemsize, d, aligned in K2B_CASES[targs]:
        for n, e in ((1 << 20, 1 << 30), (1, 1)):
            def geo(be, n=n, e=e):
                return k2b_geometry(e, n, d, itemsize, be, aligned)
            be = _largest_admitted(geo)
            if be:
                best = max(best, (geo(be).smem_bytes, be))
    return best


def k3a_ring(v_bytes: int, u: int) -> int:
    """K3a's ring (``ring_bytes<V, U>`` in ``isect.cu``)."""
    c = source_constants("isect.cu")
    return (c["kThreads"] // c["kWarp"]) * c["kStreamRing"] * 2 * u * \
        c["kWarp"] * v_bytes


def instantiations() -> list[LaunchBudget]:
    """Every kernel template instantiation the wrappers launch, with its
    static bytes and its worst dynamic bytes."""
    import torch

    from repro_torch.kernels.flash.flash import (
        MAX_HEAD_DIM,
        flash_bwd_plan,
        flash_plan,
    )

    rows: list[LaunchBudget] = []

    def add(kid, source, kernel, targs, dynamic, launcher, where,
            after=""):
        rows.append(LaunchBudget(
            kid, entry_name(kernel, targs), source,
            static_bytes(source, kernel, targs), dynamic,
            opts_in(source, launcher, after), where))

    span = k1_worst_span()
    for t in ("float", "int"):
        for m in range(4):
            for dc in ("1", "4"):
                for act in ("0", "1", "2"):
                    add("K1", "deliver_fused.cu", "deliver_fused_kernel",
                        (t, str(m), dc, act), k1_dynamic(span), "launch_k",
                        f"span {span} (kMaxSpan)")
    for kernel in ("k2a_count", "k2a_plan", "k2a_scatter"):
        add("K2a", "segsum.cu", kernel, (), 0, "segsum_launch",
            "static arrays only")
    k2a = k2a_worst()
    for t, itemsize, vec in (("float", 4, 4), ("float", 4, 1),
                             ("__nv_bfloat16", 2, 8),
                             ("__nv_bfloat16", 2, 1)):
        add("K2a", "segsum.cu", "k2a_accumulate", (t, str(vec)),
            k2a.get((itemsize, vec), 0), "segsum_launch",
            "k2a_geometry: block_n x (d_slice + 1) float32")
    # K2b opts in only above a threshold: below it the default holds.
    below = 1024 * int(re.search(
        r"smem > (\d+) \* 1024", _function_body(
            _read("segsum.cu"), "k2b_launch")).group(1))
    for targs in K2B_CASES:
        dyn, be = k2b_worst(targs)
        add("K2b", "segsum.cu", "k2b_kernel", targs, dyn, "k2b_launch",
            f"k2b_geometry at block_e {be}")
        rows.append(dataclasses.replace(
            rows[-1], dynamic=min(dyn, below), opt_in=False,
            where=f"at most {below} without the opt-in"))
    for v, vb in (("int4", 16), ("int", 4)):
        for u in ((1,) if v == "int4" else (1, 4)):
            add("K3a", "isect.cu", "isect_stream", (v, str(u)),
                k3a_ring(vb, u), "launch_persistent", "ring_bytes")
        for mode in ("1", "2"):
            for u in ((1,) if v == "int4" else (1, 4)):
                add("K3b", "isect.cu", "isect_cached", (mode, v, str(u)),
                    0, "launch_persistent", "registers only")
        for mode in ("0", "1", "2"):
            add("K3a" if mode == "0" else "K3b", "isect.cu", "isect_loop",
                (mode, v), 0, "launch_persistent", "registers only")
    f32: dict[int, int] = {}
    tf: dict[tuple, int] = {}
    tc: dict[tuple, int] = {}
    for d in range(1, MAX_HEAD_DIM + 1):
        p = flash_plan(d, torch.float32)
        if p.kernel == "tf32":
            tf[(p.head_dim, p.block_k)] = p.smem_bytes
        else:
            nj = p.head_dim // 16
            f32[nj] = max(f32.get(nj, 0), p.smem_bytes)
        p = flash_plan(d, torch.bfloat16)
        tc[(p.head_dim, p.block_k)] = p.smem_bytes
    # The FMA kernel is instantiated at every NJ whatever the route: an NJ
    # no head dim reaches launches nothing.
    for nj in (1, 2, 4, 8, 16):
        add("K4", "flash.cu", "flash_kernel", ("float", str(nj)),
            f32.get(nj, 0), "launch_nj", "flash_plan fma, float32")
    for (dp, bk), dyn in sorted(tf.items()):
        blocks = "2" if dp == 32 else "1"
        add("K4", "flash.cu", "flash_tf32_kernel", (str(dp), str(bk),
                                                    blocks),
            dyn, "launch", "flash_plan tf32, float32",
            after="namespace tf32")
    for (dp, bk), dyn in sorted(tc.items()):
        blocks = "2" if dp == 64 else "1"
        add("K4", "flash.cu", "flash_wgmma_kernel", (str(dp), str(bk),
                                                     blocks),
            dyn, "launch", "flash_plan, bfloat16", after="namespace tc")
    # K4's backward: the pre-pass; on the FMA route, per (rows a thread R,
    # columns NJ), the dK / dV and dQ kernels at the widest head dim each
    # admits in either type; on the tensor-core routes (bfloat16, and
    # float32 in three-pass TF32), per padded width.
    fma: dict[tuple, tuple] = {}
    wgmma: dict[int, tuple] = {}
    tf32: dict[int, tuple] = {}
    for d in range(1, MAX_HEAD_DIM + 1):
        for dtype in (torch.float32, torch.bfloat16):
            p = flash_bwd_plan(d, dtype)
            if p.kernel in ("wgmma", "tf32"):
                (wgmma if p.kernel == "wgmma" else tf32)[p.head_dim] = (
                    p.dkdv_smem, p.dq_smem)
                continue
            key = (p.block_rows // 16, 1 << (-(-d // 16) - 1).bit_length())
            old = fma.get(key, (0, 0))
            fma[key] = (max(old[0], p.dkdv_smem), max(old[1], p.dq_smem))
    for t in ("float", "__nv_bfloat16"):
        add("K4", "flash_bwd.cu", "flash_bwd_delta", (t,), 0, "launch",
            "none (row dot products)")
        for (r, nj), (dkdv, dq) in sorted(fma.items()):
            add("K4", "flash_bwd.cu", "flash_bwd_dkdv", (t, str(r), str(nj)),
                dkdv, "launch_tiles", "flash_bwd_plan fma, dK / dV")
            add("K4", "flash_bwd.cu", "flash_bwd_dq", (t, str(r), str(nj)),
                dq, "launch_tiles", "flash_bwd_plan fma, dQ")
    for dp, (dkdv, dq) in sorted(wgmma.items()):
        add("K4", "flash_bwd.cu", "flash_bwd_dkdv_wgmma", (str(dp),), dkdv,
            "launch", "flash_bwd_plan wgmma, dK / dV", after="namespace tc")
        add("K4", "flash_bwd.cu", "flash_bwd_dq_wgmma", (str(dp),), dq,
            "launch", "flash_bwd_plan wgmma, dQ", after="namespace tc")
    for dp, (dkdv, dq) in sorted(tf32.items()):
        blocks = "2" if dp == 32 else "1"
        add("K4", "flash_bwd.cu", "flash_bwd_dkdv_tf32", (str(dp), blocks),
            dkdv, "launch", "flash_bwd_plan tf32, dK / dV",
            after="namespace tf32")
        add("K4", "flash_bwd.cu", "flash_bwd_dq_tf32", (str(dp), blocks), dq,
            "launch", "flash_bwd_plan tf32, dQ", after="namespace tf32")
    return rows


def check_budgets(rows: list[LaunchBudget] | None = None) -> list[Finding]:
    """Static + worst dynamic bytes of every instantiation against the
    limit its launcher's opt-in gives it."""
    findings = []
    for r in instantiations() if rows is None else rows:
        if r.total > r.limit:
            how = ("opted in" if r.opt_in
                   else "no cudaFuncSetAttribute in its launcher")
            findings.append(Finding(
                rule="smem-budget", path=f"src/repro_torch/csrc/{r.source}",
                line=0, scope=f"{r.kernel} {r.entry}",
                message=(f"{r.static} static + {r.dynamic} dynamic "
                         f"({r.where}) = {r.total} bytes > {r.limit} "
                         f"({how})"),
            ))
    return findings


# Python mirrors of source constants: (module, attribute, source, the
# source's value as a function of its constants).
MIRRORS = (
    ("repro_torch.kernels.deliver.fused", "_MAX_SPAN", "deliver_fused.cu",
     lambda c: c["kMaxSpan"]),
    ("repro_torch.kernels.deliver.fused", "_MAX_CLASSES",
     "deliver_fused.cu", lambda c: c["kMaxClasses"]),
    ("repro_torch.kernels.deliver.fused", "_THREADS", "deliver_fused.cu",
     lambda c: c["kThreads"]),
    ("repro_torch.kernels.deliver.fused", "_UNROLL", "deliver_fused.cu",
     lambda c: c["kUnroll"]),
    ("repro_torch.kernels.deliver.fused", "_WARP", "deliver_fused.cu",
     lambda c: c["kWarp"]),
    ("repro_torch.kernels.segsum.segsum", "K2A_FAN_IN", "segsum.cu",
     lambda c: c["kFan"]),
    ("repro_torch.kernels.segsum.segsum", "K2A_MAX_ROWS", "segsum.cu",
     lambda c: 32 * c["kMaxMaskWords"]),
    ("repro_torch.kernels.segsum.segsum", "K2B_THREADS", "segsum.cu",
     lambda c: c["kK2bThreads"]),
    ("repro_torch.kernels.segsum.segsum", "K2B_FAN_IN", "segsum.cu",
     lambda c: 1 << c["kLgFan"]),
    ("repro_torch.kernels.flash.flash", "MAX_HEAD_DIM", "flash.cu",
     lambda c: 16 * 16),
    ("repro_torch.kernels.flash.flash", "SMEM_LIMIT", "flash.cu",
     lambda c: OPTIN_BYTES),
    ("repro_torch.kernels.flash.flash", "MAX_HEAD_DIM", "flash_bwd.cu",
     lambda c: c["kMaxHeadDim"]),
    ("repro_torch.kernels.flash.flash", "TF32_MAX_HEAD_DIM", "flash.cu",
     lambda c: c["tf32::kMaxDim"]),
    ("repro_torch.kernels.flash.flash", "TF32_BWD_MAX_HEAD_DIM",
     "flash_bwd.cu", lambda c: c["tf32::kMaxDim"]),
)


def check_mirrors(mirrors=MIRRORS, constants=None) -> list[Finding]:
    """Each Python mirror equal to the source constant it copies, and
    the tilings ``flash_plan`` hard-codes equal to ``flash.cu``'s.
    ``constants``: ``{source: {name: value}}`` in place of the sources'
    (the mutation hook of the negative tests)."""
    import importlib

    import torch

    def consts(source):
        if constants is not None and source in constants:
            return constants[source]
        return source_constants(source)

    findings = []

    def mismatch(scope, got, want, source):
        findings.append(Finding(
            rule="smem-budget", path=f"src/repro_torch/csrc/{source}",
            line=0, scope=scope,
            message=f"Python mirror {got} != source {want}",
        ))

    for module, attr, source, value in mirrors:
        got = getattr(importlib.import_module(module), attr)
        want = value(consts(source))
        if got != want:
            mismatch(f"{module.rsplit('.', 1)[-1]}.{attr}", got, want,
                     source)
    from repro_torch.kernels.flash.flash import flash_bwd_plan, flash_plan
    from repro_torch.kernels.segsum.segsum import K2B_STATIC_BYTES

    # K2b's opt-in limit is 227 KB less its largest static arrays.
    k2b = max(static_bytes("segsum.cu", "k2b_kernel", t) for t in K2B_CASES)
    if K2B_STATIC_BYTES != k2b:
        mismatch("segsum.K2B_STATIC_BYTES", K2B_STATIC_BYTES, k2b,
                 "segsum.cu")
    c = consts("flash.cu")
    fma, wg = flash_plan(256, torch.float32), flash_plan(256, torch.bfloat16)
    tf = flash_plan(64, torch.float32)
    for scope, got, want in (
            ("flash_plan fma block_q", fma.block_q, c["f32::kBQ"]),
            ("flash_plan fma block_k", fma.block_k, c["f32::kBK"]),
            ("flash_plan wgmma block_q", wg.block_q, c["tc::kBQ"]),
            ("flash_plan wgmma stages", wg.stages, c["tc::kStages"]),
            ("flash_plan tf32 block_q", tf.block_q, c["tf32::kBQ"])):
        if got != want:
            mismatch(scope, got, want, "flash.cu")
    c = consts("flash_bwd.cu")
    bw = flash_bwd_plan(128, torch.bfloat16)
    bt = flash_bwd_plan(64, torch.float32)
    for scope, got, want in (
            ("flash_bwd_plan wgmma block_rows", bw.block_rows,
             c["tc::kRows"]),
            ("flash_bwd_plan wgmma block_cols", bw.block_cols,
             c["tc::kCols"]),
            ("flash_bwd_plan wgmma stages", bw.stages, c["tc::kStages"]),
            ("flash_bwd_plan tf32 block_rows", bt.block_rows,
             c["tf32::kRows"]),
            ("flash_bwd_plan tf32 block_cols", bt.block_cols,
             c["tf32::kCols"])):
        if got != want:
            mismatch(scope, got, want, "flash_bwd.cu")
    return findings


# The static arrays the model counts, per kernel: a new one in the
# source is a new number the budgets must see.
MODELED_ARRAYS = {
    "deliver_fused_kernel": ("range",),
    "k2a_count": ("bins",), "k2a_scatter": ("bins",),
    "k2a_plan": ("warp_sums", "carry", "first_item"),
    "k2a_accumulate": ("touched", "group_masks", "sorted_edge",
                       "sorted_row", "warp_sums", "last"),
    "k2b_kernel": ("s_i", "s_off_i0", "s_wkey", "s_ma", "s_wval",
                   "s_last"),
    "isect_cached": (), "isect_stream": (), "isect_loop": (),
    "flash_kernel": (), "flash_wgmma_kernel": (), "flash_tf32_kernel": (),
    "flash_bwd_delta": (), "flash_bwd_dkdv": (), "flash_bwd_dq": (),
    "flash_bwd_dkdv_wgmma": (), "flash_bwd_dq_wgmma": (),
    "flash_bwd_dkdv_tf32": (), "flash_bwd_dq_tf32": (),
}


def check_static_arrays(texts: dict | None = None) -> list[Finding]:
    """Every kernel of the sources is one the model covers, with the
    ``__shared__`` arrays it counts.  ``texts``: ``{source: text}`` in
    place of the files (the negative tests' hook)."""
    findings = []
    for source in SOURCES:
        text = (texts or {}).get(source)
        for name, k in source_kernels(source, text).items():
            have = tuple(a[1] for a in k.arrays)
            if MODELED_ARRAYS.get(name) != have:
                findings.append(Finding(
                    rule="smem-budget", path=f"src/repro_torch/csrc/{source}",
                    line=0, scope=name,
                    message=(f"static arrays {have} in the source, "
                             f"{MODELED_ARRAYS.get(name)} in the model"),
                ))
    return findings


def check_width_gate(*, width_budget_bytes: float | None = None
                     ) -> list[Finding]:
    """Every width the auto path can select fits at worst geometry: K2a
    at ``block_n`` 128 (the wrapper's default) and ``K2A_MAX_ROWS``
    within 48 KB beside its static arrays, K4 within its head dim and
    the opt-in limit.  K1's bytes do not depend on the width."""
    import torch

    from repro_torch.kernels.flash.flash import MAX_HEAD_DIM, flash_plan
    from repro_torch.kernels.segsum.segsum import K2A_MAX_ROWS, k2a_geometry

    if width_budget_bytes is None:
        from repro_torch.core.executor import FUSED_MAX_WIDTH_BYTES

        width_budget_bytes = FUSED_MAX_WIDTH_BYTES
    k2a_static = static_bytes("segsum.cu", "k2a_accumulate", ("float", "4"))
    findings = []
    for itemsize, dtype in ((4, torch.float32), (2, torch.bfloat16)):
        max_d = max(1, int(width_budget_bytes // itemsize))
        for bn in (128, K2A_MAX_ROWS):
            g = k2a_geometry(1 << 20, 1 << 20, max_d, itemsize, bn, 512)
            if g.smem_bytes + k2a_static > DEFAULT_BYTES:
                findings.append(Finding(
                    rule="smem-budget", path="<width-gate>", line=0,
                    scope=f"K2a[block_n={bn},D={max_d}x{itemsize}B]",
                    message=(f"{g.smem_bytes} + {k2a_static} bytes > "
                             f"{DEFAULT_BYTES}"),
                ))
        if max_d > MAX_HEAD_DIM or flash_plan(
                max_d, dtype).smem_bytes > OPTIN_BYTES:
            findings.append(Finding(
                rule="smem-budget", path="<width-gate>", line=0,
                scope=f"K4[D={max_d}x{itemsize}B]",
                message=(f"auto-selectable width {max_d} outside K4's "
                         f"head dims (at most {MAX_HEAD_DIM})"),
            ))
    return findings


# --------------------------------------------------------------------------
# the worst geometries, launched
# --------------------------------------------------------------------------

def worst_launches(device) -> list[tuple[str, str, object, object]]:
    """Each kernel at the worst geometry its budget admits, as ``(kernel
    id, label, kernel call, plain call)``: K1 through a one-class plan
    whose span is ``_MAX_SPAN``; K2a at ``block_n`` = ``K2A_MAX_ROWS``, at
    the widest tile ``K2A_SMEM_BYTES`` holds and, on the card, at the GNN
    side's largest call (``[61,859,140, 64]``); K2b at the largest
    ``block_e`` ``k2b_geometry`` admits for bfloat16 D = 8 (the template
    with the most static bytes); K3a at its widest rings (int4 and int
    units); K4 at head dim 256 in both types.  Payloads are integers
    wherever the sum is exact (K1, K2a, K2b, K3a: the calls must agree
    bitwise); K4 is held to a tolerance by the caller.  Every call
    returns a tensor on ``device``."""
    import ctypes

    import torch

    from repro_torch.kernels.deliver import build_delivery_layout, fused
    from repro_torch.kernels.flash.flash import flash_cuda, flash_plain
    from repro_torch.kernels.isect.isect import isect_cuda, isect_plain
    from repro_torch.kernels.segsum.segsum import (
        K2A_MAX_ROWS,
        K2A_SMEM_BYTES,
        k2b_geometry,
        segsum_cuda,
        segsum_plain,
        segsum_sorted_cuda,
        segsum_sorted_plain,
    )

    dev = torch.device(device)
    rng = np.random.default_rng(15)
    cases = []

    def ints(shape, dtype=torch.float32):
        return torch.as_tensor(rng.integers(-4, 5, shape).astype(
            np.float32), device=dev).to(dtype)

    n_src, n_dst, nnz = 5000, 9000, 60000
    lay = build_delivery_layout(rng.integers(0, n_src, nnz),
                                rng.integers(0, n_dst, nnz), None, n_src,
                                n_dst, device=dev)
    c = max(range(lay.n_classes), key=lambda i: lay.class_rows[i])
    args = (lay.class_src[c], lay.class_dst[c], lay.class_bounds[c],
            lay.class_rows[c])
    kw = dict(block_n=lay.block_n, block_e=lay.class_block_e[c])
    for d in (1, 4):
        msgs = ints((n_src + 1, d))
        msgs[-1] = 0

        def k1(msgs=msgs, d=d):
            # deliver_fused_cuda's one-class launch, its span forced
            if dev.type == "cpu":
                return fused.deliver_fused_plain(msgs, None, *args, "sum",
                                                 **kw)
            out = torch.empty((args[3], d), dtype=msgs.dtype, device=dev)
            words = fused._class_desc(*args, kw["block_e"], 0,
                                      fused._MAX_SPAN)
            fused._launch(msgs, None, (ctypes.c_longlong * len(words))(
                *words), 1, lay.block_n, None, None, 0, out, "sum")
            return out

        cases.append(("K1", f"span {fused._MAX_SPAN} D={d}", k1,
                      lambda msgs=msgs: fused.deliver_fused_plain(
                          msgs, None, *args, "sum", **kw)))

    e, n = 50_000, 10_000
    ids = torch.as_tensor(rng.integers(0, n, e).astype(np.int32), device=dev)
    widest = (K2A_SMEM_BYTES - 4 * 128) // (4 * 128)
    for bn, d in ((K2A_MAX_ROWS, 3), (128, widest)):
        m = ints((e, d))
        cases.append(("K2a", f"block_n {bn} D={d}",
                      lambda m=m, bn=bn: segsum_cuda(m, ids, n, block_n=bn),
                      lambda m=m: segsum_plain(m, ids, n)))

    if dev.type == "cuda":
        # The GNN side's largest K2a call: gat-cora's layer-1 messages
        # [E, 8 x 8] on ogb_products (61,859,140 edges into 2,449,029
        # rows; chip_smoke.py phase 18 (b)), whose partials and int32
        # scratch are the largest k2a_geometry sizes on a system path
        # (7.9 GB and 0.5 GB).  Drawn on the card (15.8 GB of messages);
        # the CPU's callers never reach this size.
        gen = torch.Generator(device=dev).manual_seed(15)
        e_gnn, n_gnn = 61_859_140, 2_449_029
        ids_gnn = torch.randint(0, n_gnn, (e_gnn,), generator=gen,
                                device=dev, dtype=torch.int32)
        m_gnn = torch.randint(-4, 5, (e_gnn, 64), generator=gen, device=dev,
                              dtype=torch.int8).float()
        cases.append(("K2a", f"GNN E={e_gnn} D=64",
                      lambda: segsum_cuda(m_gnn, ids_gnn, n_gnn),
                      lambda: segsum_plain(m_gnn, ids_gnn, n_gnn)))

    sorted_ids = torch.sort(ids).values
    offsets = torch.searchsorted(
        sorted_ids, torch.arange(n + 1, dtype=torch.int32, device=dev)
    ).to(torch.int32)
    m = ints((e, 8), torch.bfloat16)
    be = _largest_admitted(lambda b: k2b_geometry(e, n, 8, 2, b, True))
    cases.append(("K2b", f"bfloat16 D=8 block_e {be}",
                  lambda: segsum_sorted_cuda(m, offsets, n, block_e=be),
                  lambda: segsum_sorted_plain(m, offsets, n)))

    for w in (128, 101):
        a, b = (torch.as_tensor(rng.integers(-2**31, 2**31, (20_000, w))
                                .astype(np.int32), device=dev)
                for _ in range(2))
        cases.append(("K3a", f"W={w}", lambda a=a, b=b: isect_cuda(a, b),
                      lambda a=a, b=b: isect_plain(a, b)))

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.as_tensor(rng.standard_normal((1, 2, 192, 256))
                                   .astype(np.float32), device=dev).to(dtype)
                   for _ in range(3))
        cases.append(("K4", f"D=256 {str(dtype).removeprefix('torch.')}",
                      lambda q=q, k=k, v=v: flash_cuda(q, k, v),
                      lambda q=q, k=k, v=v: flash_plain(q, k, v)))
    return cases


# --------------------------------------------------------------------------
# reading ptxas
# --------------------------------------------------------------------------

_DEMANGLE = {"f": "float", "i": "int", "j": "unsigned", "b": "bool",
             "d": "double", "l": "long", "c": "char"}


def parse_entry(mangled: str) -> tuple[str, tuple]:
    """``(kernel, template arguments)`` of an Itanium-mangled entry
    function name, as ``entry_name`` spells them."""
    s, i = mangled, 0
    nested = s.startswith("_ZN")
    i = 3 if nested else 2
    names = []
    while i < len(s) and s[i].isdigit():
        m = re.match(r"\d+", s[i:])
        n = int(m.group())
        i += len(m.group())
        names.append(s[i:i + n])
        i += n
        if not nested:
            break
    args: list[str] = []
    if s[i:i + 1] == "I":
        i += 1
        while s[i] != "E":
            if s[i] == "L":
                j = s.index("E", i)
                typ, val = s[i + 1], s[i + 2:j].replace("n", "-")
                args.append(("true" if val == "1" else "false")
                            if typ == "b" else str(int(val)))
                i = j + 1
            elif s[i].isdigit():
                m = re.match(r"\d+", s[i:])
                n = int(m.group())
                i += len(m.group())
                args.append(s[i:i + n])
                i += n
            else:
                args.append(_DEMANGLE[s[i]])
                i += 1
    return names[-1] if names else mangled, tuple(args)


def ptxas_static_smem(log: str) -> dict[str, int]:
    """Static shared memory per entry function in ``nvcc -Xptxas -v``
    output, keyed by ``entry_name``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = entry_name(*parse_entry(m.group(1)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name is not None:
            out[name] = int(m.group(2) or 0)
            name = None
    return out


def check_ptxas(logs: dict[str, str]) -> list[Finding]:
    """Every entry function of the builds (``{source: log}``) is one the
    model has, with ``ptxas``'s static bytes equal to the model's."""
    model = {(r.source, r.entry): r.static for r in instantiations()}
    findings = []
    for source, log in logs.items():
        got = ptxas_static_smem(log)
        want = {e: b for (s, e), b in model.items() if s == source}
        for entry in sorted(set(got) | set(want)):
            if got.get(entry) != want.get(entry):
                findings.append(Finding(
                    rule="smem-budget", path=f"src/repro_torch/csrc/{source}",
                    line=0, scope=entry,
                    message=(f"ptxas {got.get(entry)} static bytes, "
                             f"model {want.get(entry)}"),
                ))
    return findings


def device_limits(device=None) -> tuple[int, int]:
    """``(per block without opt-in, per block opted in)`` of a card, from
    ``torch.cuda.get_device_properties``."""
    import torch

    props = torch.cuda.get_device_properties(
        torch.device("cuda") if device is None else device)
    return (int(props.shared_memory_per_block),
            int(props.shared_memory_per_block_optin))


# --------------------------------------------------------------------------
# shape agreement between the two lowerings
# --------------------------------------------------------------------------

def _build_layouts(device):
    """Two small real layouts covering the skew regimes (uniform and a
    hub-heavy draw that forces multiple degree classes): the reference's
    draws, onto ``device``."""
    from repro_torch.kernels.deliver import build_delivery_layout

    rng = np.random.default_rng(0)
    out = []
    nnz, n_src, n_dst = 600, 128, 96
    src = rng.integers(0, n_src, nnz)
    dst = rng.integers(0, n_dst, nnz)
    dst_skew = np.where(
        rng.random(nnz) < 0.6, rng.integers(0, 4, nnz), dst
    )
    for name, d in (("uniform", dst), ("skewed", dst_skew)):
        out.append((name, build_delivery_layout(
            src, d, None, n_src, n_dst, device=device)))
    return out


SHAPE_DTYPES = {"or": ("bool",), "sum": ("float32", "int32"),
                "min": ("float32", "int32"), "max": ("float32", "int32")}


def shape_grid(device, *, fused_leaf=None, widths=(1, 8),
               monoids=("sum", "min", "max", "or")):
    """``(point, (xla shape, dtype), (fused shape, dtype))`` over every
    layout x monoid x width x dtype."""
    import torch

    from repro_torch.kernels.deliver import _pallas_leaf
    from repro_torch.kernels.deliver.xla import deliver_ell_leaf
    from repro_torch.sparse.segment import MONOIDS

    device = torch.device(device)
    lowering = "cuda" if device.type == "cuda" else "plain"
    fused = fused_leaf or (
        lambda m, layout, monoid, active: _pallas_leaf(
            m, layout, monoid, active, lowering=lowering))
    out = []
    for lname, layout in _build_layouts(device):
        for mname in monoids:
            monoid = MONOIDS[mname]
            for d in widths:
                for dt in SHAPE_DTYPES[mname]:
                    msgs = torch.zeros((layout.n_src, d),
                                       dtype=getattr(torch, dt),
                                       device=device)
                    ref = deliver_ell_leaf(msgs, layout, monoid)
                    got = fused(msgs, layout, monoid, None)
                    out.append((f"{lname}/{mname}/D={d}/{dt}",
                                (tuple(ref.shape), ref.dtype),
                                (tuple(got.shape), got.dtype)))
    return out


def check_shapes(device=None, *, fused_leaf=None, widths=(1, 8),
                 monoids=("sum", "min", "max", "or")) -> list[Finding]:
    """Output shape/dtype agreement of the two lowerings over the grid.
    ``fused_leaf`` is the mutation hook for the negative tests."""
    findings = []
    for point, ref, got in shape_grid(
            "cuda" if device is None else device, fused_leaf=fused_leaf,
            widths=widths, monoids=monoids):
        if ref != got:
            findings.append(Finding(
                rule="shape-mismatch", path="<shape-audit>", line=0,
                scope=point,
                message=(f"xla {ref[0]}:{ref[1]} vs fused "
                         f"{got[0]}:{got[1]}"),
            ))
    return findings


def shape_budget_audit(device=None) -> list[Finding]:
    """The CLI pass: shape agreement over the grid (on the card unless
    ``device`` says otherwise), every instantiation's shared memory at
    its worst geometry, the mirrors, the modeled arrays and the width
    gate."""
    return (check_shapes(device) + check_budgets() + check_mirrors()
            + check_static_arrays() + check_width_gate())
