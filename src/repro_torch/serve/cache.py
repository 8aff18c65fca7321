"""The cross-process executable store and replica-boot warmup (the
port's counterpart of the JAX package's ``repro.serve.cache``).

The Engine's executable LRU (``Engine._exec_cache``) is per-process:
every replica of a serving fleet makes its own executables.  This
module is what replicas share:

* ``stable_digest(key)`` maps a ``repro_torch.core.serving.signature``
  tuple — which keys programs by *object identity* in memory — onto a
  digest that is stable ACROSS processes running the same code:
  functions contribute their qualified name, bytecode and closure
  values instead of their id.
* ``DiskExecutableCache`` is the on-disk store under
  ``$REPRO_CACHE_DIR`` (default ``.repro_cache/``), namespaced by the
  card's name, the device count, the torch and CUDA versions and the
  schema, so an entry is only read by the environment that wrote it.
  A CUDA graph cannot be saved, so the store holds only the JAX
  package's fallback format, the **warmup record**: a checksummed
  marker saying that making this signature's executable at boot "is
  expected and intentional".  The flock per signature, the quarantine
  and the ``disk.*`` fault points are the JAX package's.
* ``warm(engine, specs)`` is the replica-boot API: compile every spec
  and make its executables ready (on the card, capture every batch
  bucket's CUDA graph) so that a front-end started afterwards only
  replays; ``require_no_retrace=True`` refuses a boot whose store holds
  no record of a signature it has to make.

The Engine integration is one seam: when ``Engine.disk_cache`` is set,
``Engine._executable_for`` wraps each freshly built executable in
``_DiskBackedExecutable``, which makes it (captures it, on the card)
under the signature's lock on first use and writes its record after.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import pickle
import re
import tempfile
import time
import types
import weakref
from functools import partial
from pathlib import Path
from typing import Any, Iterable

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX: publish stays atomic
    fcntl = None

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.obs.metrics import default_registry, weak_provider
from repro_torch.obs.trace import maybe_span

_SCHEMA = 1
_FORMAT_EXECUTABLE = "xla-executable"  # the JAX package's; never read here
_FORMAT_WARMUP = "warmup-record"
_SUFFIX = ".record"
DEFAULT_CACHE_DIR = ".repro_cache"


def _checksum(data: bytes) -> str:
    """Content checksum over a record's body: detects truncation and
    bit-rot that still unpickle cleanly."""
    return hashlib.sha256(data).hexdigest()


def cache_root(path: str | os.PathLike | None = None) -> Path:
    """The on-disk cache location: explicit path, else ``$REPRO_CACHE_DIR``,
    else ``.repro_cache/`` under the working directory (gitignored)."""
    return Path(
        path or os.environ.get("REPRO_CACHE_DIR") or DEFAULT_CACHE_DIR
    )


def _environment_tag(device: torch.device) -> str:
    """The store's namespace for ``device``: the card's name and the
    device count, the torch and CUDA versions, and the schema."""
    if device.type == "cuda":
        name = re.sub(r"[^A-Za-z0-9.]+", "_",
                      torch.cuda.get_device_name(device)).strip("_")
        where = f"{name}-{torch.cuda.device_count()}dev"
    else:
        where = f"{device.type}-1dev"
    return (f"{where}-torch{torch.__version__}-cuda{torch.version.cuda}"
            f"-v{_SCHEMA}").replace("+", "_")


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
# the disk store
# --------------------------------------------------------------------------

class DiskExecutableCache:
    """Warmup records of the signatures a boot makes, on disk.

    >>> engine = Engine(disk_cache=DiskExecutableCache())
    >>> warm(engine, [spec], batch_sizes=(8,))   # boot: capture + record
    >>> engine.compile(spec).run_batch(queries)  # replays, no capture

    Records live under ``<root>/<card>-<ndev>dev-torch<v>-cuda<v>-v<N>/``
    (``_environment_tag``) as ``<digest>.record``.  A record is a pickled
    dict — format, schema, the signature's ``stable_digest``, a body and
    the sha256 of the body — published atomically (``mkstemp`` +
    ``os.replace``).  ``device``: the device whose environment names
    the namespace (default the card).

    Counters (``stats()``) keep the JAX package's keys, counted as its
    record fallback counts them, except where a record is the port's
    only format:

    * a load that finds a record counts ``warm_records`` and a
      ``disk_misses`` (no executable is loaded: the capture still
      runs), as the JAX package counts one; ``disk_hits`` stays 0;
    * a record written counts ``disk_stores``; the JAX package's
      fallback counts a ``disk_errors`` there (its serialize failed);
    * ``disk_errors`` counts loads that failed (a read, a parse, a
      foreign or corrupt entry: each quarantined) and writes that
      failed; ``disk_migrated`` stays 0 (no legacy entries).
    """

    def __init__(self, path: str | os.PathLike | None = None, *,
                 device=None):
        self.root = cache_root(path)
        self.device = resolve_device(device)
        self.dir = self.root / _environment_tag(self.device)
        self._stats = {
            "disk_hits": 0,
            "disk_misses": 0,
            "disk_stores": 0,
            "disk_errors": 0,
            "warm_records": 0,
            "disk_quarantined": 0,
            "disk_migrated": 0,
            "disk_lock_waits": 0,
        }
        # Duck-typed like Engine.tracer: Engine(fault_injector=...)
        # forwards its injector here so the disk.read / disk.write /
        # disk.deserialize points fire inside the real try blocks.
        self.fault_injector = None
        default_registry().register_provider(
            "serve.disk_cache", weak_provider(self.stats)
        )

    # -- paths -------------------------------------------------------------

    def _path(self, digest: str) -> Path:
        return self.dir / f"{digest}{_SUFFIX}"

    def _write(self, digest: str, payload: dict) -> None:
        """Atomic publish: a concurrently booting replica never reads a
        torn record."""
        self.dir.mkdir(parents=True, exist_ok=True)
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._path(digest))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @contextlib.contextmanager
    def lock(self, key: Any):
        """Advisory cross-process claim on one signature.

        Holding the signature's ``flock`` while making its executable
        serializes concurrently booting replicas on one signature: the
        loser blocks (counted as a ``disk_lock_waits``), then finds the
        winner's record on its re-check load.  The lock lives next to
        the record (``<digest>.lock``) and the kernel releases it on
        process death, so a replica killed -9 mid-capture never wedges
        its peers.  No-op where ``fcntl`` is unavailable (the atomic
        publish is the only guarantee there)."""
        if fcntl is None:
            yield
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        with open(self.dir / f"{stable_digest(key)}.lock", "ab") as f:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                self._stats["disk_lock_waits"] += 1
                fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def _quarantine(self, path: Path, err: Exception) -> None:
        """Move a bad entry aside (``<name>.corrupt``, never deleted —
        post-mortem evidence) so the next boot makes the executable
        again instead of re-tripping over the same file."""
        try:
            os.replace(path, str(path) + ".corrupt")
            self._stats["disk_quarantined"] += 1
        except OSError:
            pass

    # -- load / store ------------------------------------------------------

    def load(self, key: Any) -> dict | None:
        """The record's body for ``key``, or ``None``.

        A record never stands in for an executable: the caller still
        makes it, and the record says that doing so at boot is expected.
        Verification: the ``disk.read`` point fires before the file is
        read, ``disk.deserialize`` before it is parsed; an entry that
        does not unpickle, is not a record of this schema and digest
        (an executable entry of the JAX package's format included), or
        fails its checksum, is quarantined (renamed ``.corrupt``) and
        reported as a miss."""
        from repro_torch.faults.errors import CorruptCacheEntry

        digest = stable_digest(key)
        path = self._path(digest)
        if not path.exists():
            self._stats["disk_misses"] += 1
            return None
        try:
            if self.fault_injector is not None:
                self.fault_injector.maybe_raise(
                    "disk.read", digest=digest[:16]
                )
            with open(path, "rb") as f:
                raw = f.read()
            if self.fault_injector is not None:
                self.fault_injector.maybe_raise(
                    "disk.deserialize", digest=digest[:16]
                )
            payload = pickle.loads(raw)
            fmt = (
                payload.get("format") if isinstance(payload, dict) else None
            )
            if fmt == _FORMAT_EXECUTABLE:
                raise CorruptCacheEntry(
                    f"{path.name} holds an XLA executable: this store "
                    "reads warmup records only"
                )
            if fmt != _FORMAT_WARMUP:
                raise CorruptCacheEntry(
                    f"unrecognized cache entry format {fmt!r}"
                )
            if payload.get("schema") != _SCHEMA or \
                    payload.get("digest") != digest:
                raise CorruptCacheEntry(
                    f"{path.name} is a record of another schema or "
                    "signature"
                )
            body = payload["body"]
            if _checksum(body) != payload.get("checksum"):
                raise CorruptCacheEntry(
                    f"checksum mismatch for {path.name}"
                )
            record = pickle.loads(body)
        except Exception as err:  # corrupt / foreign / unreadable
            self._stats["disk_errors"] += 1
            self._stats["disk_misses"] += 1
            self._quarantine(path, err)
            return None
        self._stats["warm_records"] += 1
        self._stats["disk_misses"] += 1
        return record

    def store(self, key: Any, record: dict) -> bool:
        """Publish ``record`` (a small picklable dict) as the warmup
        record of ``key``.  The ``disk.write`` point fires first; a
        failed write counts ``disk_errors`` and leaves no record (the
        next boot makes the executable unrecorded).  Returns True when
        the record was written."""
        digest = stable_digest(key)
        try:
            if self.fault_injector is not None:
                self.fault_injector.maybe_raise(
                    "disk.write", digest=digest[:16]
                )
            body = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
            self._write(digest, {
                "format": _FORMAT_WARMUP,
                "schema": _SCHEMA,
                "digest": digest,
                "body": body,
                "checksum": _checksum(body),
            })
        except Exception:
            self._stats["disk_errors"] += 1
            return False
        self._stats["disk_stores"] += 1
        return True

    def wrap(self, engine, key: Any, exe):
        """Engine seam: wrap a freshly built executable so its first use
        makes it under the signature's lock and records it (see
        ``Engine._executable_for``)."""
        return _DiskBackedExecutable(self, key, exe, engine=engine)

    def stats(self) -> dict:
        entries = 0
        if self.dir.is_dir():
            entries = sum(1 for _ in self.dir.glob(f"*{_SUFFIX}"))
        return {**self._stats, "entries": entries, "dir": str(self.dir)}


class _DiskBackedExecutable:
    """An Engine LRU entry backed by the disk store.

    Wraps the ``serving._Executable`` the Engine built; every attribute
    it does not define is the executable's (``nbytes``, ``replay``,
    ``state``, ...).  First use (``capture``, which ``_execute`` calls
    while ``needs_capture``) looks the signature up, then under its
    lock looks again, fires ``compile.aot``, makes the executable (the
    CUDA graph's capture on the card; the CPU built it already) and
    writes its record.  ``source`` records what the store held:
    ``disk`` (a record: the capture was expected), ``aot`` (no record:
    one was written), ``jit`` (no record, and an injected
    ``compile.aot`` fault on the CPU, whose eager build stands: nothing
    is written).  On the card every failure, ``compile.aot`` included,
    raises: there is no plain fallback.
    """

    __slots__ = ("cache", "key", "exe", "source", "_engine_ref")

    def __init__(self, cache: DiskExecutableCache, key, exe, engine=None):
        self.cache = cache
        self.key = key
        self.exe = exe
        self.source = None
        # weak: the Engine's LRU owns this object, never the reverse
        self._engine_ref = weakref.ref(engine) if engine is not None else None

    def __getattr__(self, name):
        return getattr(self.exe, name)

    def _engine_attr(self, name: str):
        engine = self._engine_ref() if self._engine_ref is not None else None
        return getattr(engine, name, None)

    @property
    def needs_capture(self) -> bool:
        return self.source is None or self.exe.needs_capture

    def capture(self) -> None:
        if self.source is None:
            self._materialize()
        elif self.exe.needs_capture:
            self.exe.capture()

    def _materialize(self) -> None:
        tracer = self._engine_attr("tracer")
        with maybe_span(tracer, "serve.disk_load", cat="compile") as sp:
            recorded = self.cache.load(self.key) is not None
            if sp is not None:
                sp.args["recorded"] = recorded
        # Claim the signature before making it, so that concurrently
        # booting replicas make one signature one at a time; the
        # re-check finds a record a peer wrote meanwhile.
        with self.cache.lock(self.key):
            with maybe_span(tracer, "serve.disk_load", cat="compile") as sp:
                recorded = self.cache.load(self.key) is not None or recorded
                if sp is not None:
                    sp.args["recorded"] = recorded
            source = "disk" if recorded else "aot"
            write = True
            with maybe_span(tracer, "serve.aot_compile", cat="compile") as sp:
                try:
                    inj = self._engine_attr("fault_injector")
                    if inj is not None:
                        inj.maybe_raise("compile.aot")
                except Exception:
                    if self.exe.device.type == "cuda":
                        raise
                    # The CPU's eager build stands; nothing is written.
                    write = False
                    if not recorded:
                        source = "jit"
                if self.exe.needs_capture:
                    self.exe.capture()
                if sp is not None:
                    sp.args["source"] = source
            if write:
                self.cache.store(self.key, {
                    "executable": "eager" if self.exe.graph is None
                    else "graph",
                    "launches": self.exe.recorded,
                    "device": self.exe.device.type,
                })
        self.source = source


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
    on the card a captured CUDA graph, on the CPU an eager build),
    recording each in the engine's ``disk_cache`` when one is attached.

    ``queries``: per-spec example query for specs whose ``query0`` is
    unset (e.g. an unseeded ``random_walk_spec``); ignored where the
    spec carries its own.  Returns a report::

        {"boot_s": ..., "traces": ..., "from_disk": ..., "compiled": ...,
         "paths": {name: {path: {"source": ..., "executable": ...}}}}

    where each source is ``disk`` (the store held the signature's
    record), ``aot`` (it did not: a record was written) or ``jit`` (no
    store attached), and ``executable`` is ``graph`` (a captured CUDA
    graph) or ``eager`` (the CPU); ``traces`` counts the captures (card)
    or builds (CPU) it made, recorded ones included: a CUDA graph
    cannot be loaded, so a boot always captures.

    ``require_no_retrace=True`` is the fleet's boot contract: the store
    was prepared for this boot, so having to make an executable whose
    signature it holds no record of (or with no store attached) raises
    the capture sentinel's ``RetraceError`` instead of silently paying
    the capture on first requests.  The JAX package's sentinel asserts
    zero traces, because it loads executables.
    """
    if require_no_retrace:
        from repro_torch.analysis.retrace import RetraceError

        report = warm(
            engine, specs, batch_sizes=batch_sizes, queries=queries, hg=hg,
        )
        unrecorded = sorted(
            f"{name}/{path}"
            for name, per in report["paths"].items()
            for path, rep in per.items() if rep["source"] != "disk"
        )
        if report["traces"] and unrecorded:
            raise RetraceError(
                len(unrecorded), 0,
                "serve.warm (no record in the store for "
                + ", ".join(unrecorded) + ")",
            )
        return report
    t0 = time.perf_counter()
    before = engine.cache_stats()["traces"]
    paths: dict[str, dict] = {}
    for i, item in enumerate(specs):
        compiled = item if hasattr(item, "warmup") else engine.compile(item)
        example = None
        if queries is not None and i < len(queries):
            example = queries[i]
        name = getattr(compiled.spec, "name", f"spec{i}")
        paths[f"{i}:{name}"] = compiled.warmup(
            query=example, batch_sizes=batch_sizes, hg=hg
        )
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
