"""The port's shared store, capture sentinel and replica pool, held
against the JAX package on the CPU:

* ``DiskExecutableCache``: the namespace directory, ``REPRO_CACHE_DIR``,
  quarantine of a corrupt / foreign / tampered entry (a miss, never a
  crash), lock contention, each ``disk.*`` and ``compile.aot`` point
  and how it degrades; ``warm``'s report and the store's counters
  against the JAX package's record fallback (reached, as its own suite
  does, by making ``serialize_executable.serialize`` raise), with each
  divergence named;
* the sentinel: ``warm(require_no_retrace=True)`` refuses an
  unprepared store and passes a recorded one, no capture after a
  recorded boot (``assert_no_retrace``), ``retrace_smoke`` equal to the
  reference's;
* ``kernels._nvcc``: two processes on a cold build directory compile
  once;
* two tests with real ``spawn`` processes: a pool of two replicas
  killed -9 mid-replay, its values equal to the JAX package's
  sequential runs; the launcher's pool under a plan naming every fault
  point, which fires each one across the parent's, the router's and
  the replicas' injectors.

Every wait is bounded, and every child is killed in ``finally``.
"""
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.algorithms as talg
from repro_torch.analysis import RetraceError, assert_no_retrace
from repro_torch.core import Engine, HyperGraph
from repro_torch.faults import FAULT_POINTS, FaultInjector
from repro_torch.launch import serve_hypergraph as launcher
from repro_torch.serve import DiskExecutableCache, warm
from repro_torch.serve.cache import stable_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _small(seed=1, nv=61, ne=37):
    from repro.data import powerlaw_hypergraph

    j = powerlaw_hypergraph(nv, ne, mean_cardinality=4, seed=seed)
    return j, HyperGraph.from_numpy(j.src, j.dst, j.n_vertices,
                                    j.n_hyperedges, device="cpu")


def _store(path, **kw):
    return DiskExecutableCache(path, device="cpu", **kw)


def _engine(path=None, **kw):
    return Engine(device="cpu",
                  disk_cache=_store(path) if path is not None else None,
                  **kw)


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------

def test_store_namespace_and_env_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "envroot"))
    cache = DiskExecutableCache(device="cpu")
    assert str(cache.root) == str(tmp_path / "envroot")
    # namespaced by device, device count, torch and CUDA versions, schema
    name = cache.dir.name
    assert name.startswith("cpu-1dev-torch") and name.endswith("-v1")
    assert f"cuda{torch.version.cuda}" in name
    monkeypatch.delenv("REPRO_CACHE_DIR")
    assert str(DiskExecutableCache(device="cpu").root) == ".repro_cache"
    with pytest.raises(ValueError, match="disk_cache records cpu"):
        Engine(device="meta", disk_cache=cache)


def test_digest_of_served_signatures_is_stable_across_builds():
    """Two ``build_paths`` calls (fresh hypergraphs, fresh spec objects)
    give Engine cache keys that differ by identity and digest the
    same: what a replica process needs to find the parent's records."""
    digests = []
    for _ in range(2):
        paths = launcher.build_paths(device="cpu")
        eng = Engine(device="cpu")
        warm(eng, list(paths["specs"].values()), batch_sizes=(8,),
             queries=[0, 0])
        digests.append(sorted(stable_digest(k) for k in eng._exec_cache))
    assert len(digests[0]) == 4 and digests[0] == digests[1]


@pytest.mark.parametrize("entry", ["not a pickle", "foreign", "checksum",
                                   "other digest"])
def test_bad_entry_is_quarantined_and_misses(tmp_path, entry):
    cache = _store(tmp_path)
    key = ("k",)
    digest = stable_digest(key)
    assert cache.store(key, {"executable": "eager"})
    path = cache._path(digest)
    payload = pickle.loads(path.read_bytes())
    if entry == "not a pickle":
        path.write_bytes(b"not a pickle")
    elif entry == "foreign":   # the JAX package's executable format
        path.write_bytes(pickle.dumps({"format": "xla-executable",
                                       "schema": 1, "serialized": b"x"}))
    elif entry == "checksum":
        payload["body"] = payload["body"][:-1] + b"\0"
        path.write_bytes(pickle.dumps(payload))
    else:
        payload["digest"] = stable_digest(("other",))
        path.write_bytes(pickle.dumps(payload))
    assert cache.load(key) is None
    s = cache.stats()
    assert s["disk_errors"] == 1 and s["disk_quarantined"] == 1
    assert s["disk_misses"] == 1 and s["entries"] == 0
    assert os.path.exists(str(path) + ".corrupt")  # never deleted
    assert cache.load(key) is None                 # now a plain miss
    assert cache.stats()["disk_errors"] == 1


def test_corrupt_blob_degrades_as_the_reference(tmp_path):
    from repro.serve import DiskExecutableCache as JCache
    from repro.serve.cache import stable_digest as j_digest

    got = []
    for cache, digest in ((_store(tmp_path / "t"), stable_digest),
                          (JCache(tmp_path / "j"), j_digest)):
        cache.dir.mkdir(parents=True, exist_ok=True)
        cache._path(digest(("k",))).write_bytes(b"not a pickle")
        assert cache.load(("k",)) is None
        got.append({k: v for k, v in cache.stats().items() if k != "dir"})
    assert got[0] == got[1]


def test_lock_contention_counts_waits(tmp_path):
    from repro.serve import DiskExecutableCache as JCache

    for cache in (_store(tmp_path / "t"), JCache(tmp_path / "j")):
        inside, release, entered = (threading.Event(), threading.Event(),
                                    [])

        def holder():
            with cache.lock("k"):
                inside.set()
                release.wait(5)

        def contender():
            inside.wait(5)
            with cache.lock("k"):
                entered.append(True)

        t1 = threading.Thread(target=holder)
        t2 = threading.Thread(target=contender)
        t1.start()
        t2.start()
        inside.wait(5)
        time.sleep(0.05)                 # let the contender hit the lock
        release.set()
        t1.join(5)
        t2.join(5)
        assert entered == [True]
        assert cache.stats()["disk_lock_waits"] >= 1


def _boot(path, spec, require_no_retrace=False, **kw):
    eng = _engine(path, **kw)
    return eng, warm(eng, [spec], batch_sizes=(4,), queries=[0],
                     require_no_retrace=require_no_retrace)


def test_warm_matches_the_reference_record_fallback(tmp_path, monkeypatch):
    """Two boots on one store, in each package.  The JAX package cannot
    serialize here (as on platforms that cannot round-trip executables)
    and writes warmup records, the port's only format.  Named
    divergences: a record write counts ``disk_stores`` where the
    reference counts ``disk_errors``, and a path whose record was found
    reports ``disk`` (the reference ``aot``: it recompiles)."""
    from jax.experimental import serialize_executable as se

    from repro.algorithms import shortest_paths_spec as j_sssp
    from repro.core import Engine as JEngine
    from repro.serve import DiskExecutableCache as JCache
    from repro.serve import warm as j_warm

    def boom(compiled):
        raise RuntimeError("platform cannot serialize executables")

    monkeypatch.setattr(se, "serialize", boom)
    j, hg = _small()
    jspec, spec = j_sssp(j, 0, 6), talg.shortest_paths_spec(hg, 0, 6)
    for boot in (1, 2):
        jeng = JEngine(disk_cache=JCache(tmp_path / "j"))
        jrep = j_warm(jeng, [jspec], batch_sizes=(4,), queries=[0])
        eng, rep = _boot(tmp_path / "t", spec)
        assert set(rep) == set(jrep)
        assert rep["traces"] == jrep["traces"] == 2
        assert set(rep["paths"]["0:sssp"]) == set(jrep["paths"]["0:sssp"])
        want = "aot" if boot == 1 else "disk"
        assert {p["source"] for p in rep["paths"]["0:sssp"].values()} == {
            want}
        assert {p["source"] for p in jrep["paths"]["0:sssp"].values()} == {
            "aot"}
        assert rep["from_disk"] == (0 if boot == 1 else 2)
        assert rep["compiled"] == (2 if boot == 1 else 0)
        s, js = eng.disk_cache.stats(), jeng.disk_cache.stats()
        assert set(s) == set(js)
        assert s["disk_stores"] == js["disk_errors"] == 2
        assert s["disk_errors"] == js["disk_stores"] == 0
        for k in ("disk_hits", "disk_misses", "warm_records",
                  "disk_quarantined", "disk_migrated", "disk_lock_waits",
                  "entries"):
            assert s[k] == js[k], k
        assert eng.cache_stats()["disk"]["entries"] == 2
        want_value = jeng.compile(jspec).run_batch(
            np.asarray([0, 1], np.int32)).value
        got_value = eng.compile(spec).run_batch(np.asarray([0, 1])).value
        for a, b in zip(got_value, want_value):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------------------
# the fault points of the store and how each degrades
# --------------------------------------------------------------------------

@pytest.mark.parametrize("point", ["disk.read", "disk.deserialize",
                                   "disk.write", "compile.aot"])
def test_store_fault_point_fires_and_degrades(tmp_path, point):
    _, hg = _small()
    spec = talg.shortest_paths_spec(hg, 0, 6)
    clean, _ = _boot(tmp_path, spec)                 # 2 records
    want = clean.compile(spec).run(query=3).value
    inj = FaultInjector.from_json({"rules": [
        {"point": point, "trigger": "nth", "n": 1, "error": "corrupt"}]})
    if point == "disk.write":                        # a write on a fresh store
        eng, rep = _boot(tmp_path / "fresh", spec, fault_injector=inj)
    else:
        eng, rep = _boot(tmp_path, spec, fault_injector=inj)
    assert inj.snapshot()["never_fired"] == []
    s = eng.disk_cache.stats()
    sources = [p["source"] for p in rep["paths"]["0:sssp"].values()]
    if point in ("disk.read", "disk.deserialize"):
        # the first look fails: quarantined, a miss, made and recorded
        assert sources == ["aot", "disk"]
        assert s["disk_errors"] == 1 and s["disk_quarantined"] == 1
        assert s["entries"] == 2
    elif point == "disk.write":
        # the first record is not written: the next boot is unrecorded
        assert sources == ["aot", "aot"] and s["disk_errors"] == 1
        assert s["disk_stores"] == 1 and s["entries"] == 1
        with pytest.raises(RetraceError, match="0:sssp/single"):
            _boot(tmp_path / "fresh", spec, require_no_retrace=True)
    else:
        # the CPU's eager build stands; nothing is (re)written for it,
        # and the record a peer wrote still stands for it
        assert sources == ["disk", "disk"] and s["disk_stores"] == 1
        assert s["entries"] == 2
    got = eng.compile(spec).run(query=3).value
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_compile_aot_fault_on_a_fresh_store_serves_unrecorded(tmp_path):
    _, hg = _small()
    spec = talg.shortest_paths_spec(hg, 0, 6)
    inj = FaultInjector.from_json({"rules": [
        {"point": "compile.aot", "trigger": "always"}]})
    eng, rep = _boot(tmp_path, spec, fault_injector=inj)
    assert rep["from_disk"] == rep["compiled"] == 0
    assert {p["source"] for p in rep["paths"]["0:sssp"].values()} == {"jit"}
    assert eng.disk_cache.stats()["entries"] == 0
    assert eng.compile(spec).run(query=2).value[0].isfinite().any()


# --------------------------------------------------------------------------
# the capture sentinel
# --------------------------------------------------------------------------

def test_require_no_retrace_refuses_an_unprepared_store(tmp_path):
    _, hg = _small()
    spec = talg.shortest_paths_spec(hg, 0, 6)
    with pytest.raises(RetraceError) as err:
        _boot(tmp_path, spec, require_no_retrace=True)
    assert err.value.traces == 2 and "0:sssp/batch8" in str(err.value)
    # the refused boot recorded what it made: the next one is prepared
    eng, rep = _boot(tmp_path, spec)
    assert rep["from_disk"] == 2


def test_recorded_boot_passes_and_serving_captures_nothing(tmp_path):
    _, hg = _small()
    specs = [talg.shortest_paths_spec(hg, 0, 6),
             talg.random_walk_spec(hg, iters=6)]
    parent = _engine(tmp_path)
    warm(parent, specs, batch_sizes=(8,), queries=[0, 0])
    eng = _engine(tmp_path)
    rep = warm(eng, specs, batch_sizes=(8,), queries=[0, 0],
               require_no_retrace=True)
    assert rep["traces"] == 4 and rep["from_disk"] == 4
    assert eng.disk_cache.stats()["warm_records"] == 8
    with assert_no_retrace(eng, label="first replays after a recorded boot"):
        for spec in specs:
            compiled = eng.compile(spec)
            compiled.run(query=5)
            compiled.run_batch(np.arange(6))
    for spec in specs:
        a = eng.compile(spec).run_batch(np.arange(3)).value
        b = parent.compile(spec).run_batch(np.arange(3)).value
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_retrace_smoke_finds_nothing_as_the_reference():
    from repro.analysis.retrace import retrace_smoke as j_smoke
    from repro_torch.analysis import retrace_smoke

    assert retrace_smoke(device="cpu") == [] == j_smoke()


def test_assert_no_retrace_counts_like_the_reference():
    from repro.analysis.retrace import RetraceError as JRetraceError

    _, hg = _small()
    eng = Engine(device="cpu")
    with pytest.raises(RetraceError) as err:
        with assert_no_retrace(eng, allow=1, label="two builds") as delta:
            eng.compile(talg.shortest_paths_spec(hg, 0, 6)).run()
            eng.compile(talg.shortest_paths_spec(hg, 0, 7)).run()
            assert delta() == 2
    want = JRetraceError(2, 1, "two builds")
    assert str(err.value) == str(want)
    assert (err.value.traces, err.value.allow) == (2, 1)


# --------------------------------------------------------------------------
# kernels._nvcc: one build across processes
# --------------------------------------------------------------------------

FAKE_NVCC = """#!{python}
import sys, time
with open({count!r}, "a") as f:
    f.write("built\\n")
time.sleep(0.5)
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "w").write("a library")
"""

BUILD_CHILD = """
import sys
from pathlib import Path
from repro_torch.kernels import _nvcc
_nvcc.BUILD_DIR = Path(sys.argv[1])
print(_nvcc.build("deliver_fused", ("deliver_fused.cu",)))
"""


def test_nvcc_builds_once_across_processes(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    count = tmp_path / "count"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable,
                                     count=str(count)))
    nvcc.chmod(0o755)
    env = {**os.environ, "PYTHONPATH": SRC,
           "PATH": f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_CHILD, str(tmp_path / "kernels")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] and outs[0][0].strip().endswith(".so")
    assert count.read_text() == "built\n"


def test_nvcc_hash_follows_local_includes(tmp_path):
    """A library's hash covers the headers its sources include, through
    headers, so that a change to a header alone rebuilds it; a header it
    does not reach changes nothing.  No nvcc is needed."""
    from repro_torch.kernels import _nvcc

    (tmp_path / "sub").mkdir()
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#include "sub/c.cuh"\nint b;\n')
    (tmp_path / "sub" / "c.cuh").write_text('#include "../b.cuh"\nint c;\n')
    (tmp_path / "other.cuh").write_text("int o;\n")
    src = [tmp_path / "a.cu"]
    assert [p.name for p in _nvcc.included(src)] == ["a.cu", "b.cuh",
                                                     "c.cuh"]
    before = _nvcc.source_hash(src)
    (tmp_path / "other.cuh").write_text("int o2;\n")
    assert _nvcc.source_hash(src) == before
    (tmp_path / "sub" / "c.cuh").write_text('#include "../b.cuh"\nint d;\n')
    assert _nvcc.source_hash(src) != before
    for source in ("flash.cu", "flash_bwd.cu"):
        assert [p.name for p in _nvcc.included([_nvcc.CSRC / source])] == [
            source, "flash_tc.cuh"]


# --------------------------------------------------------------------------
# real processes: the pool, kill -9, the launcher under every point
# --------------------------------------------------------------------------

def _jax_values(regime, scale, iters, queries):
    """The JAX package's sequential runs of the served paths."""
    import repro.algorithms as jalg
    from repro.core import Engine as JEngine
    from repro.data import make_dataset as j_dataset

    hg = j_dataset(regime, scale=scale, seed=0)
    eng = JEngine()
    compiled = {
        "sssp": eng.compile(jalg.shortest_paths_spec(hg, source=0,
                                                     max_iters=iters)),
        "ppr": eng.compile(jalg.random_walk_spec(hg, iters=iters)),
    }
    out = {}
    for k, q in queries:
        value = compiled[k].run(query=q).value
        out[(k, q)] = tuple(np.array(x) for x in (
            value if isinstance(value, tuple) else (value,)))
    return out


def test_pool_survives_kill9_midreplay(tmp_path):
    """Kill -9 one of two real replicas mid-replay: every request
    resolves, served values equal the JAX package's sequential runs
    (SSSP bitwise, PPR within 1e-5), results reach the router as numpy
    without CUDA, the respawn boots from the records (which is also the
    digests' agreement across ``spawn`` children: a record is found by
    ``stable_digest``) with the sentinel armed, and no replica makes an
    executable after its warm."""
    from repro_torch.faults import FrontendClosed, ReplicaLost
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import (
        MAX_FAILOVERS,
        ProcessReplica,
        ReplicaConfig,
        Router,
    )

    store = str(tmp_path / "store")
    kwargs = {"regime": "dblp", "scale": 0.003, "seed": 0, "iters": 12}
    paths = launcher.build_paths(**kwargs, device="cpu")
    parent = Engine(device="cpu", disk_cache=_store(store))
    boot = warm(parent, list(paths["specs"].values()),
                batch_sizes=launcher.batch_buckets(8), queries=[0, 0])
    assert boot["compiled"] == 4        # two paths, unbatched and at 8
    cfg = ReplicaConfig(
        builder="repro_torch.launch.serve_hypergraph:build_paths",
        kwargs=kwargs, cache_dir=store, max_batch=8, device="cpu",
        require_no_retrace=True)
    spawned = []

    def factory(i):
        spawned.append(ProcessReplica(i, cfg))
        return spawned[-1]

    router = Router(factory, 2, heartbeat_timeout_ms=2000.0,
                    max_in_flight=8, registry=MetricsRegistry()).start()
    try:
        router.wait_ready(timeout_s=60)
        first = [s["boot"] for s in router.stats()["per_replica"]]
        for b in first:
            assert b["from_disk"] == 4 and b["compiled"] == 0
            assert b["warm_records"] == 8 and b["traces"] == 4
        n = paths["hg"].n_vertices
        trace = [("sssp" if q % 2 else "ppr", (q * 37) % n)
                 for q in range(40)]
        futs = [(k, q, router.submit(k, query=q)) for k, q in trace]
        victim = router.slots[0].handle
        os.kill(victim.pid, 9)                        # mid-replay
        values, lost = {}, 0
        for k, q, f in futs:
            try:
                values[(k, q)] = f.result(timeout=60)
            except (ReplicaLost, FrontendClosed):
                lost += 1
        assert len(values) + lost == len(trace)
        assert lost <= MAX_FAILOVERS
        stats = router.stats()
        assert stats["in_flight"] == 0 and stats["pending"] == 0
        assert stats["deaths"] >= 1 and stats["respawns"] >= 1
        router.wait_ready(timeout_s=60)
        reborn = router.stats()["per_replica"][0]["boot"]
        assert reborn["pid"] != victim.pid
        assert reborn["from_disk"] == 4 and reborn["warm_records"] > 0
        time.sleep(0.3)                               # one more heartbeat
        for p in router.stats()["per_replica"]:
            assert p["replica_counts"]["traces"] == p["boot"]["engine_traces"]
        assert victim.process.exitcode == -9
        want = _jax_values("dblp", 0.003, 12, values)
        for (k, q), served in values.items():
            leaves = served.value if isinstance(served.value, tuple) else (
                served.value,)
            assert all(isinstance(x, np.ndarray) for x in leaves)
            assert launcher.agrees(k, leaves, want[(k, q)]), (k, q)
        assert not torch.cuda.is_initialized()
    finally:
        router.close()
        for handle in spawned:
            handle.stop(force=True)


# One plan naming every fault point.  In the launcher's pool the router
# fires router.route and each replica fires replica.crash (the first
# instance, at its 6th request), replica.hang (the second, at its 11th)
# and the serving points, which the front-end retries; the store's
# points are scheduled past the 12 loads, 6 writes and 6 makes of a
# replica's boot, so they fire in the parent's three boots below.
EVERY_POINT_PLAN = {"rules": [
    {"point": "router.route", "trigger": "nth", "n": 3, "error": "fatal"},
    {"point": "replica.crash", "trigger": "prob", "p": 0.03, "seed": 1428},
    {"point": "replica.hang", "trigger": "prob", "p": 0.05, "seed": 1420},
    {"point": "execute", "trigger": "nth", "n": 2},
    {"point": "serve.flush", "trigger": "nth", "n": 3},
    {"point": "serve.worker", "trigger": "nth", "n": 2},
    {"point": "layout.build", "trigger": "nth", "n": 3},
    {"point": "disk.read", "trigger": "nth", "n": 13, "error": "corrupt"},
    {"point": "disk.deserialize", "trigger": "nth", "n": 13,
     "error": "corrupt"},
    {"point": "disk.write", "trigger": "nth", "n": 7},
    {"point": "compile.aot", "trigger": "nth", "n": 7},
    {"point": "checkpoint.chunk", "trigger": "nth", "n": 1,
     "error": "fatal"},
]}


def test_launcher_pool_fires_every_point_and_resolves_every_request(
        tmp_path):
    from repro_torch.faults import InjectedFault

    assert sorted(r["point"] for r in EVERY_POINT_PLAN["rules"]) == sorted(
        FAULT_POINTS)
    plan = json.dumps(EVERY_POINT_PLAN)
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_hypergraph",
         "--device", "cpu", "--scale", "0.003", "--requests", "40",
         "--replicas", "2", "--cache-dir", str(tmp_path / "store"),
         "--warm", "--verify", "8", "--heartbeat-timeout-ms", "1000",
         "--log-every-s", "1000", "--fault-plan", plan],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.communicate()
    assert proc.returncode == 0, f"{out}\n{err}"
    assert "ROUTER LEAK" not in out + err
    assert "served " in out and "/40 requests" in out
    assert "verified 8 pool-served results" in out
    fired = {}
    for line in out.splitlines():
        line = line.strip()
        if "calls=" in line and "fired=" in line and line.endswith(
                tuple("0123456789")):
            point, rest = line.split(": calls=")
            fired[point] = int(rest.split("fired=")[1])
    for point in ("router.route", "replica.crash", "replica.hang",
                  "execute", "serve.flush", "serve.worker", "layout.build"):
        assert fired.get(point, 0) >= 1, (point, out)

    # The parent's injector, same plan: three boots of one store, then a
    # checkpointed run.
    inj = FaultInjector.from_json(EVERY_POINT_PLAN)
    paths = launcher.build_paths(device="cpu")
    for _ in range(3):
        eng = Engine(device="cpu", delivery="xla",
                     disk_cache=_store(tmp_path / "parent"),
                     fault_injector=inj)
        warm(eng, list(paths["specs"].values()), batch_sizes=(8,),
             queries=[0, 0])
    with pytest.raises(InjectedFault):
        eng.run(paths["specs"]["sssp"], checkpoint_every=2,
                checkpoint_dir=str(tmp_path / "ckpt"))
    snap = inj.snapshot()
    merged = launcher.pool_faults(
        [snap, {"calls": fired, "fired": fired}],
        [r["point"] for r in EVERY_POINT_PLAN["rules"]])
    assert merged["never_fired"] == []
    for point in ("disk.read", "disk.deserialize", "disk.write",
                  "compile.aot", "checkpoint.chunk"):
        assert snap["fired"].get(point) == 1, (point, snap)
