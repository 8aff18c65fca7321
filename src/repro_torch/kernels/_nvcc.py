"""Build and load the port's CUDA kernels: ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``.

A kernel is built at its first use, from the sources in the package's
``csrc/``, into ``build/kernels/`` at the root of the checkout; the
library's file name carries a hash of its sources, the local headers
they include (``#include "..."``, followed through headers) and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.
``nvcc``'s output, with ``ptxas``'s registers, spills and shared memory
per kernel, is kept beside the library (``build_log``).  Processes
that start at once on a cold build directory (the replicas of a serving
pool) build each library once: the builder holds an ``flock`` on
``<name>-<hash>.lock`` beside the target, and the others wait on it and
then load what it built.  Nothing is built when a module is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str | None:
    """The ``nvcc`` on ``PATH``, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    return str(default) if default.exists() else None


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def included(paths: list[Path]) -> list[Path]:
    """``paths`` and every local ``#include "..."`` they reach, each once,
    in the order first met (a header's path is relative to its
    includer's directory)."""
    seen: list[Path] = []
    todo = [Path(os.path.realpath(p)) for p in paths]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        for m in _INCLUDE.finditer(p.read_bytes()):
            dep = Path(os.path.realpath(p.parent / m.group(1).decode()))
            if dep.exists():
                todo.append(dep)
    return seen


def source_hash(paths: list[Path]) -> str:
    """The hash a library's file name carries: its sources, the headers
    they include and the flags."""
    h = hashlib.sha256()
    for p in included(paths):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str, sources: tuple[str, ...]) -> Path:
    """Compile ``csrc/<sources>`` into ``build/kernels/<name>-<hash>.so``
    unless that file exists; returns its path."""
    paths = [CSRC / s for s in sources]
    out = BUILD_DIR / f"{name}-{source_hash(paths)}.so"
    if out.exists():
        return out
    with _claim(out.with_suffix(".lock")):
        if not out.exists():  # a peer may have built it meanwhile
            _compile(name, paths, out)
    return out


@contextlib.contextmanager
def _claim(lock: Path):
    """Hold an exclusive ``flock`` on ``lock`` (released by the kernel
    if this process dies)."""
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "ab") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(name: str, paths: list[Path], out: Path) -> None:
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found: cannot build the {name!r} kernel (needs the "
            "CUDA toolkit on PATH or under CUDA_HOME)"
        )
    # Build beside the target and rename into place, so a concurrent
    # build never loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, paths)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name!r} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_log(name: str, sources: tuple[str, ...]) -> str:
    """``nvcc``'s output from building ``name`` (built if needed)."""
    log = build(name, sources).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build (if needed) and load a kernel library once per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            _LOADED[name] = lib
        return lib
