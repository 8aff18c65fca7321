"""The port's in-process serving tier, held against the JAX package's
``repro.serve`` on the same inputs, on the CPU:

* ``CoalescingBatcher``: the same events and clock give the same flush
  sequence as the reference's (group, reason, requests), and every
  request is flushed exactly once, FIFO within its group;
* ``AdaptiveDelay``: the same observations give the same delay trace;
* ``LatencyHistogram`` quantiles and ``ServeMetrics.snapshot()`` equal;
* ``stable_digest`` is stable across spec instances and moves with a
  closed-over constant; ``warm``'s report;
* the ``Frontend`` over fakes coalesces as the reference's does, and a
  threaded ``Frontend`` on a real CPU Engine serves values equal to
  sequential compiled runs and to the JAX package's ``Frontend`` on the
  same trace (SSSP bitwise, the personalized walk within 1e-5);
* the launcher ``repro_torch.launch.serve_hypergraph`` on the CPU, with
  and without a fault plan, prints the reference's summary lines and
  verifies its sample.

Every wait has a timeout; nothing sleeps on the wall clock.
"""
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.algorithms as jalg
import repro.serve as jserve
from repro.core import Engine as JEngine
from repro.data import powerlaw_hypergraph as j_powerlaw
import repro_torch.algorithms as talg
import repro_torch.serve as tserve
from repro_torch.core import Engine, HyperGraph, tree_leaves
from repro_torch.launch import serve_hypergraph as launcher
from repro_torch.serve.frontend import _stack, _unstack


def _carry(jhg):
    return HyperGraph.from_numpy(jhg.src, jhg.dst, jhg.n_vertices,
                                 jhg.n_hyperedges, device="cpu")


def _small(seed=0, nv=47, ne=33):
    return j_powerlaw(nv, ne, mean_cardinality=4, seed=seed)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_exports():
    assert set(tserve.__all__) == {
        "CoalescingBatcher", "AdaptiveDelay", "Flush", "Request",
        "Frontend", "ServedResult", "LatencyHistogram", "ServeMetrics",
        "stable_digest", "warm", "DiskExecutableCache", "ReplicaConfig",
        "ProcessReplica", "Router", "MAX_FAILOVERS"}
    assert set(tserve.__all__) <= set(jserve.__all__)


# --------------------------------------------------------------------------
# the batcher
# --------------------------------------------------------------------------

_EVENTS = st.lists(
    st.tuples(
        st.sampled_from(["a", "b", "c"]),     # group
        st.integers(0, 99),                   # query (duplicates likely)
        st.floats(0.0, 4.0),                  # inter-arrival delta
        st.floats(0.001, 2.0),                # deadline_s
        st.booleans(),                        # poll after this arrival?
    ),
    min_size=1, max_size=60,
)


def _flush_sequence(module, events, capacity=4):
    b = module.CoalescingBatcher(capacity=capacity)
    now = 0.0
    submitted, flushes = [], []
    for group, query, dt, deadline_s, do_poll in events:
        now += dt
        submitted.append(b.submit(group, query, now=now,
                                  deadline_s=deadline_s))
        if do_poll:
            while (f := b.poll(now)) is not None:
                flushes.append(f)
    flushes.extend(b.drain())
    assert b.pending_count() == 0 and b.next_deadline() is None
    return submitted, [
        (f.group, f.reason, [(r.seq, r.query, r.deadline)
                             for r in f.requests])
        for f in flushes]


@given(_EVENTS)
@settings(max_examples=100, deadline=None)
def test_batcher_flushes_as_the_reference(events):
    submitted, got = _flush_sequence(tserve, events)
    assert got == _flush_sequence(jserve, events)[1]
    seqs = [s for _, _, reqs in got for s, _, _ in reqs]
    assert sorted(seqs) == [r.seq for r in submitted]   # exactly once
    per_group: dict = {}
    for group, reason, reqs in got:
        assert 1 <= len(reqs) <= 4 and reason in ("full", "deadline",
                                                   "drain")
        per_group.setdefault(group, []).extend(s for s, _, _ in reqs)
    for seqs in per_group.values():
        assert seqs == sorted(seqs)  # FIFO within a group


def test_batcher_full_deadline_and_mixed_hypergraph():
    for m in (tserve, jserve):
        b = m.CoalescingBatcher(capacity=4)
        for i in range(6):
            b.submit("g", i, now=0.0, deadline_s=10.0)
        f = b.poll(0.0)
        assert f.reason == "full" and [r.query for r in f.requests] == [
            0, 1, 2, 3]
        assert b.poll(1.0) is None
        assert b.poll(10.5).reason == "deadline"
        b.submit("late", 0, now=0.0, deadline_s=5.0)
        b.submit("early", 1, now=0.0, deadline_s=1.0)
        assert b.next_deadline() == 1.0
        assert b.poll(6.0).group == "early" and b.poll(6.0).group == "late"
        hg1, hg2 = object(), object()
        b.submit("h", 0, now=0.0, deadline_s=1.0, hg=hg1)
        with pytest.raises(ValueError, match="different hypergraph"):
            b.submit("h", 1, now=0.0, deadline_s=1.0, hg=hg2)
        with pytest.raises(ValueError, match="must be >= 1"):
            m.CoalescingBatcher(capacity=0).capacity("g")


def test_batcher_requeue_goes_to_the_head():
    out = []
    for m in (tserve, jserve):
        b = m.CoalescingBatcher(capacity=8)
        for i in range(3):
            b.submit("g", i, now=0.0, deadline_s=1.0)
        f = b.poll(2.0)
        b.submit("g", 9, now=2.0, deadline_s=1.0)
        b.requeue(f)
        out.append([r.query for r in b.drain()[0].requests])
    assert out[0] == out[1] == [0, 1, 2, 9]


# --------------------------------------------------------------------------
# the adaptive delay, the histogram, the metrics
# --------------------------------------------------------------------------

@given(
    st.lists(
        st.tuples(
            st.floats(0.0, 0.2),                      # execute_s
            st.floats(0.0, 1.0),                      # occupancy
            st.sampled_from(["full", "deadline", "drain"]),
        ),
        min_size=1, max_size=60,
    ),
    st.floats(1e-5, 1.0),                             # initial delay
)
@settings(max_examples=80, deadline=None)
def test_adaptive_delay_traces_equal_the_reference(stream, d0):
    t = tserve.AdaptiveDelay(d0, lo_s=1e-3, hi_s=2e-2)
    j = jserve.AdaptiveDelay(d0, lo_s=1e-3, hi_s=2e-2)
    for execute_s, occupancy, reason in stream:
        d = t.observe(execute_s=execute_s, occupancy=occupancy,
                      reason=reason)
        assert d == j.observe(execute_s=execute_s, occupancy=occupancy,
                              reason=reason)
        assert 1e-3 <= d <= 2e-2
    assert t.snapshot() == j.snapshot()


@pytest.mark.parametrize("kwargs", [{"lo_s": 0.0}, {"lo_s": 0.1, "hi_s": 0.01},
                                    {"gain": 0.0}])
def test_adaptive_delay_checks_match_the_reference(kwargs):
    with pytest.raises(ValueError) as want:
        jserve.AdaptiveDelay(0.01, **kwargs)
    with pytest.raises(ValueError) as got:
        tserve.AdaptiveDelay(0.01, **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("samples", [
    [],
    [1e-3] * 98 + [0.1, 1.0],
    list(np.random.default_rng(0).lognormal(-6, 2, 500)),
])
def test_latency_histogram_equals_the_reference(samples):
    t, j = tserve.LatencyHistogram(), jserve.LatencyHistogram()
    for s in samples:
        t.record(s)
        j.record(s)
    assert t.snapshot() == j.snapshot()
    for q in (0.1, 0.5, 0.9, 0.99, 0.999):
        assert t.quantile(q) == j.quantile(q)


def test_serve_metrics_snapshot_equals_the_reference():
    snaps = []
    for m in (tserve, jserve):
        sm = m.ServeMetrics(log_every_s=0.0)
        sm.note_submit(9)
        sm.note_flush("sssp", "full", 4, 4, [0.001] * 4, 0.010)
        sm.note_flush("sssp", "deadline", 2, 4, [0.005] * 2, 0.010)
        sm.note_flush("ppr", "drain", 2, 8, [0.002] * 2, 0.020, error=True)
        sm.note_error(1)
        line = sm.maybe_log(1.0)
        assert line.startswith("serve: 6 done / 0 in-flight")
        assert sm.maybe_log(1.0) is None or sm.log_every_s == 0.0
        snaps.append(sm.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["buckets"]["sssp/b4"]["mean_occupancy"] == \
        pytest.approx(0.75)


# --------------------------------------------------------------------------
# digests and warm
# --------------------------------------------------------------------------

def test_stable_digest_is_stable_across_spec_instances():
    hg = _carry(_small())
    s1 = talg.shortest_paths_spec(hg, 0, 12)
    s2 = talg.shortest_paths_spec(hg, 0, 12)
    assert s1.v_program is not s2.v_program
    assert tserve.stable_digest(s1.v_program) == \
        tserve.stable_digest(s2.v_program)
    assert tserve.stable_digest(s1.he_program) == \
        tserve.stable_digest(s2.he_program)
    s3 = talg.random_walk_spec(hg, iters=12, alpha=0.2)
    s4 = talg.random_walk_spec(hg, iters=12, alpha=0.15)
    assert tserve.stable_digest(s3.v_program) != \
        tserve.stable_digest(s4.v_program)
    # tensors by value, bf16 by its bits
    x = torch.arange(6, dtype=torch.float32)
    assert tserve.stable_digest((x, 1)) == tserve.stable_digest((x.clone(), 1))
    assert tserve.stable_digest(x) != tserve.stable_digest(x + 1)
    b = x.to(torch.bfloat16)
    assert tserve.stable_digest(b) == tserve.stable_digest(b.clone())
    assert tserve.stable_digest(b) != tserve.stable_digest(x)


def test_stable_digest_of_plain_values_equals_the_reference():
    from repro.serve.cache import stable_digest as j_digest

    for key in [(1, 2.5, "a", None, True), {"b": (1, 2), "a": [3.0]},
                np.arange(5, dtype=np.int32), ("k", 0)]:
        assert tserve.stable_digest(key) == j_digest(key)


def test_warm_reports_every_path_and_bucket():
    hg = _carry(_small())
    eng = Engine(device="cpu")
    rep = tserve.warm(eng, [talg.shortest_paths_spec(hg, 0, 12),
                            talg.random_walk_spec(hg, iters=4)],
                      batch_sizes=(8, 16), queries=[0, 0])
    assert rep["traces"] == 6 and rep["from_disk"] == 0
    assert rep["compiled"] == 0 and rep["boot_s"] >= 0
    assert rep["paths"] == {
        name: {path: {"source": "jit", "executable": "eager"}
               for path in ("single", "batch8", "batch16")}
        for name in ("0:sssp", "1:random_walk")}
    again = tserve.warm(eng, [talg.shortest_paths_spec(hg, 0, 12)])
    assert again["traces"] == 1  # a new spec object: new programs
    jrep = jserve.warm(JEngine(), [jalg.shortest_paths_spec(_small(), 0, 12)],
                       batch_sizes=(8,))
    assert set(jrep) == set(rep)
    with pytest.raises(ValueError, match="query"):
        tserve.warm(eng, [talg.random_walk_spec(hg, iters=4)],
                    batch_sizes=(8,))
    # the capture sentinel: nothing made, nothing to refuse; with no
    # store attached, every capture is unrecorded
    assert tserve.warm(eng, [], require_no_retrace=True)["traces"] == 0
    from repro_torch.analysis import RetraceError

    with pytest.raises(RetraceError, match="serve.warm"):
        tserve.warm(eng, [talg.shortest_paths_spec(hg, 0, 12)],
                    require_no_retrace=True)


# --------------------------------------------------------------------------
# the front-end on fakes (fake clock, no threads)
# --------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeResult:
    def __init__(self, value):
        self.value = value
        self.supersteps_executed = None


class FakeCompiled:
    """``run_batch`` double: value rows are a pure function of the query
    (plus a per-instance salt, so mixed signatures can't alias)."""

    def __init__(self, salt):
        self.salt = salt
        self.batch_sizes = []

    def _one(self, q):
        return {"out": np.asarray([q * 2 + self.salt, q], np.int64)}

    def run(self, query=None, hg=None):
        return FakeResult(self._one(int(query)))

    def run_batch(self, queries, hg=None):
        qs = np.asarray(queries)
        self.batch_sizes.append(len(qs))
        rows = [self._one(int(q)) for q in qs]
        return FakeResult({"out": np.stack([r["out"] for r in rows])})


def _coalesce(front, engine, events, adaptive=False):
    clock = FakeClock()
    fe = front(engine, max_batch=4, max_delay_ms=5.0, clock=clock,
               adaptive_delay=adaptive)
    fakes = {"sssp": FakeCompiled(1000), "ppr": FakeCompiled(7000)}
    for key, fake in fakes.items():
        fe.register(key, fake)
    futs = []
    for key, query, dt, do_pump in events:
        clock.t += dt
        futs.append((key, query, fe.submit(key, query=query)))
        if do_pump:
            fe.pump()
    clock.t += 10.0  # expire every deadline
    fe.pump(drain=True)
    out = []
    for key, query, fut in futs:
        served = fut.result(timeout=0)
        np.testing.assert_array_equal(served.value["out"],
                                      fakes[key].run(query=query).value["out"])
        out.append((served.value["out"].tolist(), served.flush_reason,
                    served.batch_size, served.batch_bucket, served.group,
                    served.queue_wait_s))
    snap = fe.stats()
    assert snap["submitted"] == snap["completed"] == len(futs)
    return out, {k: f.batch_sizes for k, f in fakes.items()}, {
        k: snap[k] for k in ("flush_reasons", "buckets", "errors",
                             "in_flight")}


@given(st.lists(
    st.tuples(
        st.sampled_from(["sssp", "ppr"]),   # signature
        st.integers(0, 30),                 # query (duplicates likely)
        st.floats(0.0, 0.01),               # inter-arrival
        st.booleans(),                      # pump mid-stream?
    ),
    min_size=1, max_size=50,
), st.booleans())
@settings(max_examples=40, deadline=None)
def test_frontend_coalesces_as_the_reference(events, adaptive):
    got = _coalesce(tserve.Frontend, Engine(device="cpu"), events, adaptive)
    assert got == _coalesce(jserve.Frontend, JEngine(), events, adaptive)
    assert all(b <= 4 for sizes in got[1].values() for b in sizes)


def test_frontend_unknown_key_queryless_spec_and_adaptive():
    fe = tserve.Frontend(Engine(device="cpu"), clock=FakeClock(),
                         max_delay_ms=7.0)
    with pytest.raises(KeyError, match="register"):
        fe.submit("nope", query=0)
    with pytest.raises(ValueError, match="bind_query"):
        fe.register("pr", talg.pagerank_spec(_carry(_small()), iters=4))
    assert fe.stats()["adaptive_delay"] is None
    assert fe.current_delay_ms == pytest.approx(7.0)
    assert fe.stats()["disk_cache"] is None
    fe.register("sssp", FakeCompiled(1))
    with pytest.raises(ValueError, match="already registered"):
        fe.register("sssp", FakeCompiled(1))

    clock = FakeClock()
    fe = tserve.Frontend(Engine(device="cpu"), max_batch=4,
                         max_delay_ms=20.0, clock=clock,
                         adaptive_delay=True, min_delay_ms=1.0)
    fe.register("sssp", FakeCompiled(1000))
    for _ in range(20):  # every flush full: waiting buys nothing
        for q in range(4):
            fe.submit("sssp", query=q)
        fe.pump(drain=True)
    assert fe.current_delay_ms < 2.0
    assert fe.stats()["adaptive_delay"]["observations"] == 20


def test_stack_and_unstack_over_the_ports_trees():
    q = _stack([{"s": 1, "w": np.ones(2)}, {"s": 2, "w": np.zeros(2)}])
    assert q["s"].tolist() == [1, 2] and q["w"].shape == (2, 2)
    value = (torch.arange(6.0).reshape(2, 3),
             {"n": np.arange(4).reshape(2, 2)})
    rows = _unstack(value, 2)
    assert torch.equal(rows[1][0], torch.tensor([3.0, 4.0, 5.0]))
    assert rows[0][1]["n"].tolist() == [0, 1]
    # a row is a view of the flush's own tensor, not a copy
    assert rows[1][0].untyped_storage().data_ptr() == \
        value[0].untyped_storage().data_ptr()


def test_frontend_under_many_submitting_threads():
    """More submitters than cores against one worker, with a short
    switch interval: every future resolves once with its own row, and
    the counters balance (a lost update would break either)."""
    import sys
    import threading

    fe = tserve.Frontend(Engine(device="cpu"), max_batch=4,
                         max_delay_ms=0.5)
    fake = FakeCompiled(3)
    fe.register("k", fake)
    n_threads, per_thread = 16, 40
    futs = [[] for _ in range(n_threads)]

    def submit(i):
        for j in range(per_thread):
            futs[i].append((i * 1000 + j,
                            fe.submit("k", query=i * 1000 + j)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        fe.start()
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for per in futs:
            for q, f in per:
                assert f.result(timeout=120).value["out"].tolist() == [
                    2 * q + 3, q]
    finally:
        sys.setswitchinterval(interval)
        fe.close()
    snap = fe.stats()
    total = n_threads * per_thread
    assert snap["submitted"] == snap["completed"] == total
    assert snap["in_flight"] == 0 and snap["queue_wait"]["count"] == total
    assert sum(fake.batch_sizes) == total and max(fake.batch_sizes) <= 4


# --------------------------------------------------------------------------
# a threaded front-end on a real CPU Engine, against both oracles
# --------------------------------------------------------------------------

def _trace(n_vertices, n=24, seed=0):
    rng = np.random.default_rng(seed)
    return [("sssp" if rng.random() < 0.6 else "ppr",
             int(rng.integers(0, n_vertices))) for _ in range(n)]


def _serve(front, engine, specs, trace, warm=None):
    fe = front(engine, max_batch=8, max_delay_ms=2.0)
    for key, spec in specs.items():
        fe.register(key, spec)
    if warm is not None:
        warm(engine, [fe.compiled(k) for k in specs], batch_sizes=(8,),
             queries=[0, 0])
    try:
        fe.start()
        futs = [fe.submit(key, query=q) for key, q in trace]
        results = [f.result(timeout=300) for f in futs]
    finally:
        fe.close()
    return fe, results


@pytest.mark.parametrize("delivery", ["xla", "pallas_fused"])
def test_threaded_frontend_matches_sequential_and_the_reference(delivery):
    jhg = _small(seed=1, nv=60, ne=40)
    thg = _carry(jhg)
    trace = _trace(jhg.n_vertices)
    eng = Engine(device="cpu", delivery=delivery)
    fe, got = _serve(tserve.Frontend, eng,
                     {"sssp": talg.shortest_paths_spec(thg, 0, 12),
                      "ppr": talg.random_walk_spec(thg, iters=12)},
                     trace, warm=tserve.warm)
    traces = eng.cache_stats()["traces"]
    _, want = _serve(jserve.Frontend, JEngine(delivery=delivery),
                     {"sssp": jalg.shortest_paths_spec(jhg, 0, 12),
                      "ppr": jalg.random_walk_spec(jhg, iters=12)}, trace)
    for (key, q), served, ref in zip(trace, got, want):
        seq = fe.compiled(key).run(query=q).value
        assert launcher.agrees(key, served.value, seq), (key, q)
        a, b = tree_leaves(served.value), tree_leaves(ref.value)
        for x, y in zip(a, b):
            if key == "sssp":
                assert np.array_equal(_np(x), _np(y), equal_nan=True)
            else:
                np.testing.assert_allclose(_np(x), _np(y), rtol=1e-5,
                                           atol=1e-7)
    snap = fe.stats()
    assert snap["completed"] == len(trace) and snap["in_flight"] == 0
    assert snap["queue_wait"]["count"] == len(trace)
    # warm made both paths' buckets; a sequential run adds the single path
    assert traces == 4


def test_results_of_two_flushes_do_not_alias():
    hg = _carry(_small())
    eng = Engine(device="cpu")
    clock = FakeClock()
    fe = tserve.Frontend(eng, max_batch=8, clock=clock)
    fe.register("sssp", talg.shortest_paths_spec(hg, 0, 12))
    first = [fe.submit("sssp", query=q) for q in (0, 1)]
    fe.pump(drain=True)
    kept = [f.result(timeout=0).value[0].clone() for f in first]
    second = [fe.submit("sssp", query=q) for q in (5, 6)]
    fe.pump(drain=True)
    for f, k in zip(first, kept):
        assert torch.equal(f.result(timeout=0).value[0], k)
    assert not torch.equal(first[0].result(timeout=0).value[0],
                           second[0].result(timeout=0).value[0])


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

_SUMMARY = ("served ", "  wait    p50=", "  execute p50=", "  flushes ",
            "  bucket ", "  engine cache: ")


@pytest.mark.parametrize("plan", [None, (
    '{"rules": [{"point": "execute", "trigger": "every", "n": 3, '
    '"error": "transient"}, {"point": "serve.flush", "trigger": "nth", '
    '"n": 2, "error": "transient"}, {"point": "serve.worker", '
    '"trigger": "nth", "n": 2}]}')])
def test_launcher_on_the_cpu(capsys, plan):
    argv = ["--device", "cpu", "--scale", "0.003", "--requests", "40",
            "--verify", "4", "--log-every-s", "1000"]
    if plan is not None:
        argv += ["--fault-plan", plan]
    assert launcher.main(argv) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    for prefix in _SUMMARY:
        assert any(line.startswith(prefix) for line in lines), prefix
    assert "verified 4 served results" in out
    # two paths, each unbatched and at buckets 8 and 16
    assert "warm boot:" in out and " 6 traces" in out
    if plan is not None:
        assert "fault-plan: 3 rule(s) armed" in out
        assert "  fault injection: " in out
        for point in ("execute", "serve.flush", "serve.worker"):
            assert f"    {point}: calls=" in out


def test_launcher_summary_lines_match_the_reference(capsys, tmp_path):
    from repro.launch import serve_hypergraph as j_launcher

    argv = ["--scale", "0.003", "--requests", "24", "--verify", "0",
            "--log-every-s", "1000"]
    def shape(out):  # each summary line with its numbers blanked
        return [re.sub(r"\d+(\.\d+)?", "#", line)
                for line in out.splitlines() if line.startswith(_SUMMARY)]

    assert j_launcher.main(argv + ["--cache-dir", str(tmp_path)]) == 0
    want = shape(capsys.readouterr().out)
    assert launcher.main(argv + ["--device", "cpu"]) == 0
    got = shape(capsys.readouterr().out)
    assert got == want and len(got) >= 6


class _ThreadReplica:
    """``ProcessReplica``'s interface over ``replica_main`` on a thread
    of this process (the pipe is real; no process is spawned)."""

    def __init__(self, index, config):
        import dataclasses
        import multiprocessing
        import threading

        from repro_torch.serve.replica import replica_main

        self.index, self.pid, self.faults = index, None, None
        self.connection, child = multiprocessing.Pipe()
        self._thread = threading.Thread(
            target=replica_main,
            args=(child, dataclasses.replace(config, index=index)),
            daemon=True)
        self._thread.start()
        self._broken = False

    poll_messages = tserve.ProcessReplica.poll_messages
    send = tserve.ProcessReplica.send

    def alive(self):
        return not self._broken and self._thread.is_alive()

    def kill(self):
        self.stop(force=True)

    def stop(self, force=False, join_s=5.0):
        if self._thread.is_alive():
            try:
                self.send(("stop",))
            except OSError:
                pass
            self._thread.join(join_s)
        self._broken = True


@pytest.mark.parametrize("flag", [["--replicas", "2"],
                                  ["--cache-dir", "somewhere"]])
def test_launcher_refuses_the_multi_process_tier(flag, capsys, monkeypatch,
                                                 tmp_path):
    """The multi-process flags no longer raise: ``--cache-dir`` serves
    in-process over a store of warmup records, ``--replicas 2`` through
    the ``Router`` (its replicas on threads here: the real processes
    are ``tests/test_torch_disk_cache.py``'s)."""
    monkeypatch.setattr(tserve, "ProcessReplica", _ThreadReplica)
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "default"))
    if flag[0] == "--cache-dir":
        flag = ["--cache-dir", str(tmp_path / flag[1])]
    argv = ["--device", "cpu", "--scale", "0.003", "--requests", "24",
            "--verify", "4", "--log-every-s", "1000"] + flag
    assert launcher.main(argv) == 0
    out = capsys.readouterr().out
    assert "warm boot: " in out and " 6 compiled" in out
    if flag[0] == "--replicas":
        assert "served 24/24 requests" in out
        assert "verified 4 pool-served results" in out
        assert "disk=6 aot=0 traces=6 records=12" in out
        assert (tmp_path / "default").is_dir()
    else:
        assert "  disk cache:   entries=6 records=0 stores=6" in out
        assert "verified 4 served results" in out


def test_batch_buckets_cover_every_flush_size():
    assert launcher.batch_buckets(16) == (8, 16)
    assert launcher.batch_buckets(5) == (8,)
    assert launcher.batch_buckets(64) == (8, 16, 32, 64)
