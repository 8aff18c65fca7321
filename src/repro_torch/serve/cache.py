"""Executable-cache digests and replica-boot warmup (the part of the
JAX package's ``repro.serve.cache`` that needs no disk store).

* ``stable_digest(key)`` maps a ``repro_torch.core.serving.signature``
  tuple — which keys programs by *object identity* in memory — onto a
  digest that is stable ACROSS processes running the same code:
  functions contribute their qualified name, bytecode and closure
  values instead of their id.
* ``warm(engine, specs)`` is the boot API: compile every spec and make
  its executables ready before the first request — on the card, capture
  every batch bucket's CUDA graph, so that a serving front-end started
  afterwards only replays.
* ``cache_root`` names where a persistent store would live.

The JAX package's ``DiskExecutableCache`` persists serialized XLA
executables; a CUDA graph cannot be saved, and the port's store (digests
and checksummed records) comes with the multi-process tier (ROADMAP.md
queue 1, item 9b).  Until then every executable is made in-process and
``warm`` reports its source as ``jit``, as the JAX package does for an
Engine without a disk cache.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import types
from functools import partial
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch

DEFAULT_CACHE_DIR = ".repro_cache"


def cache_root(path: str | os.PathLike | None = None) -> Path:
    """The on-disk cache location: explicit path, else ``$REPRO_CACHE_DIR``,
    else ``.repro_cache/`` under the working directory (gitignored)."""
    return Path(
        path or os.environ.get("REPRO_CACHE_DIR") or DEFAULT_CACHE_DIR
    )


# --------------------------------------------------------------------------
# stable signature digests
# --------------------------------------------------------------------------

def _hash_code(code: types.CodeType, h) -> None:
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    h.update(repr(code.co_varnames).encode())
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _hash_code(const, h)
        else:
            h.update(repr(const).encode())


def _hash_function(fn, h) -> None:
    """Qualified name + bytecode + closure values: two processes running
    the same source produce the same token; an edited algorithm (or a
    different closed-over constant, e.g. ``alpha``) changes it."""
    h.update(f"fn:{fn.__module__}:{fn.__qualname__}".encode())
    code = getattr(fn, "__code__", None)
    if code is not None:
        _hash_code(code, h)
    for cell in fn.__closure__ or ():
        try:
            _token(cell.cell_contents, h)
        except ValueError:  # an unhashable self-reference: name only
            h.update(b"cell:opaque")
    defaults = getattr(fn, "__defaults__", None)
    if defaults:
        _token(defaults, h)


def _token(obj: Any, h) -> None:
    """Fold one signature component into the hash, by value."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        h.update(f"{type(obj).__name__}:{obj!r}".encode())
    elif isinstance(obj, partial):
        h.update(b"partial")
        _hash_function(obj.func, h)
        _token(obj.args, h)
        _token(tuple(sorted(obj.keywords.items())), h)
    elif isinstance(obj, types.FunctionType) or isinstance(
        obj, types.MethodType
    ):
        _hash_function(
            obj.__func__ if isinstance(obj, types.MethodType) else obj, h
        )
    elif isinstance(obj, dict):
        h.update(b"dict")
        for k in sorted(obj, key=repr):
            _token(k, h)
            _token(obj[k], h)
    elif isinstance(obj, (tuple, list)):
        h.update(f"seq:{len(obj)}".encode())
        for item in obj:
            _token(item, h)
    elif isinstance(obj, np.ndarray):
        h.update(f"nd:{obj.dtype}:{obj.shape}".encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:  # no numpy dtype: by its bits
            h.update(b"bf16")
            t = t.view(torch.int16)
        _token(t.numpy(), h)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # Program / Monoid / spec-level containers: field-by-field, so
        # function-valued fields hash by bytecode, not memory address.
        h.update(
            f"dc:{type(obj).__module__}.{type(obj).__qualname__}".encode()
        )
        for field in dataclasses.fields(obj):
            h.update(field.name.encode())
            _token(getattr(obj, field.name), h)
    elif callable(obj) and hasattr(obj, "__qualname__"):
        # builtins / callables without python code objects
        h.update(
            f"call:{getattr(obj, '__module__', '?')}:"
            f"{obj.__qualname__}".encode()
        )
    else:
        # treedefs, enums, misc hashables: their repr is stable for the
        # types the serving signature actually contains.
        h.update(
            f"obj:{type(obj).__module__}.{type(obj).__qualname__}:"
            f"{obj!r}".encode()
        )


def stable_digest(key: Any) -> str:
    """A cross-process digest of an executable-cache signature tuple."""
    h = hashlib.sha256()
    _token(key, h)
    return h.hexdigest()


# --------------------------------------------------------------------------
# replica-boot warmup
# --------------------------------------------------------------------------

def warm(
    engine,
    specs: Iterable[Any],
    *,
    batch_sizes: tuple[int, ...] = (),
    queries: list[Any] | None = None,
    hg=None,
    require_no_retrace: bool = False,
) -> dict:
    """Boot-time warmup: bring ``engine`` to warm-path q/s before the
    first request.

    For each spec (an ``AlgorithmSpec``, or an already-compiled
    ``CompiledAlgorithm``) make the unbatched executable ready plus one
    per batch bucket in ``batch_sizes`` (``CompiledAlgorithm.warmup``:
    on the card a captured CUDA graph, on the CPU an eager build).

    ``queries``: per-spec example query for specs whose ``query0`` is
    unset (e.g. an unseeded ``random_walk_spec``); ignored where the
    spec carries its own.  Returns a report::

        {"boot_s": ..., "traces": ..., "from_disk": 0, "compiled": 0,
         "paths": {name: {path: {"source": "jit", "executable": ...}}}}

    where each source is ``jit`` (made in this process: no disk store is
    attached) and ``executable`` is ``warmup``'s ``graph`` or ``eager``;
    ``traces`` counts the captures (card) or builds (CPU) it made.

    ``require_no_retrace=True`` needs the capture sentinel of the
    analysis layer, which is not ported (ROADMAP.md queue 1, item 11).
    """
    if require_no_retrace:
        raise NotImplementedError(
            "warm(require_no_retrace=True) is not ported to repro_torch "
            "yet (ROADMAP.md queue 1, item 11: the capture sentinel)"
        )
    t0 = time.perf_counter()
    before = engine.cache_stats()["traces"]
    paths: dict[str, dict] = {}
    for i, item in enumerate(specs):
        compiled = item if hasattr(item, "warmup") else engine.compile(item)
        example = None
        if queries is not None and i < len(queries):
            example = queries[i]
        name = getattr(compiled.spec, "name", f"spec{i}")
        report = compiled.warmup(
            query=example, batch_sizes=batch_sizes, hg=hg
        )
        paths[f"{i}:{name}"] = {
            path: {"source": "jit", "executable": rep["source"]}
            for path, rep in report.items()
        }
    sources = [
        rep.get("source") for per in paths.values() for rep in per.values()
    ]
    return {
        "boot_s": time.perf_counter() - t0,
        "traces": engine.cache_stats()["traces"] - before,
        "from_disk": sum(1 for s in sources if s == "disk"),
        "compiled": sum(1 for s in sources if s == "aot"),
        "paths": paths,
    }
