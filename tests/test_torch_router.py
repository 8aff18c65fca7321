"""The port's replica router, held against the JAX package's
``repro.serve.router`` on the same fake replica handles and fake clock.

Each case of the reference's fake-clock suite (``tests/test_router.py``)
runs through BOTH packages: the same submissions, kills, heartbeats and
completions give the same resolutions (value, or error type), the same
``stats()`` and the same registry snapshot, key for key; then the
reference's own assertions hold on the port's run.  The chaos property
(random kill schedules x arrival orders x completion interleavings)
runs both packages on each drawn schedule.

No processes, threads or sleeps: the clock is injected and ``pump(now)``
is the whole control loop.
"""
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.faults as jfaults
import repro.obs.metrics as jmetrics
import repro.serve.router as jrouter
import repro_torch.faults as tfaults
import repro_torch.obs.metrics as tmetrics
import repro_torch.serve.router as trouter

PKGS = {
    "repro": types.SimpleNamespace(
        Router=jrouter.Router, MAX_FAILOVERS=jrouter.MAX_FAILOVERS,
        faults=jfaults, MetricsRegistry=jmetrics.MetricsRegistry),
    "repro_torch": types.SimpleNamespace(
        Router=trouter.Router, MAX_FAILOVERS=trouter.MAX_FAILOVERS,
        faults=tfaults, MetricsRegistry=tmetrics.MetricsRegistry),
}


# --------------------------------------------------------------------------
# fakes: a replica handle and a clock, both fully deterministic (the
# reference suite's)
# --------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


class FakeReplica:
    """In-memory stand-in for ``ProcessReplica``: the router sends
    requests in, the test decides when (and whether) results come back.
    Deterministic execution model: ``value = f"v:{key}:{query}"``."""

    def __init__(self, index):
        self.index = index
        self.outbox = [("ready", {"index": index, "boot_s": 0.0,
                                  "traces": 0, "from_disk": 1,
                                  "compiled": 0})]
        self.inbox = []
        self._alive = True
        self._broken = False
        self.connection = None

    def poll_messages(self):
        out, self.outbox = self.outbox, []
        return out

    def send(self, msg):
        if self._broken or not self._alive:
            raise BrokenPipeError(f"fake replica {self.index} down")
        if msg[0] != "stop":
            self.inbox.append(msg)

    def alive(self):
        return self._alive and not self._broken

    def kill(self):
        self._alive = False

    def stop(self, force=False, join_s=None):
        self._alive = False

    def heartbeat(self):
        self.outbox.append(("hb", {"received": len(self.inbox)}))

    def complete(self, n=None):
        done = 0
        while self.inbox and (n is None or done < n):
            _, req_id, key, query, _hg, _dl = self.inbox.pop(0)
            self.outbox.append(("res", req_id, f"v:{key}:{query}"))
            done += 1
        return done

    def die(self):
        self._alive = False

    def break_pipe(self):
        self._broken = True


def make_router(pkg, n=2, clock=None, registry=None, **kw):
    clock = clock or FakeClock()
    replicas = []

    def factory(i):
        r = FakeReplica(i)
        replicas.append(r)
        return r

    kw.setdefault("heartbeat_timeout_ms", 1000.0)
    kw.setdefault("boot_timeout_s", 100.0)
    registry = registry if registry is not None else pkg.MetricsRegistry()
    router = pkg.Router(factory, n, clock=clock, registry=registry, **kw)
    router.pump(clock.now)      # drain the ready messages
    return router, replicas, clock, registry


def expected(key, query):
    return f"v:{key}:{query}"


def outcome(f):
    """A future's resolution as comparable data across packages."""
    if not f.done():
        return "pending"
    err = f.exception(timeout=0)
    return ("ok", f.result()) if err is None else ("err", type(err).__name__)


def record(router, registry, futs, **extra):
    return {"outcomes": [outcome(f) for f in futs],
            "stats": router.stats(),
            "snapshot": registry.snapshot(), **extra}


# --------------------------------------------------------------------------
# the reference's fake-clock cases, one scenario each
# --------------------------------------------------------------------------

def routes_and_counts(pkg):
    router, reps, clock, reg = make_router(pkg, 2)
    trace = [("sssp", 1), ("ppr", 2), ("sssp", 3), ("ppr", 4)]
    futs = [router.submit(k, query=q) for k, q in trace]
    in_flight = router.in_flight()
    for r in reps:
        r.complete()
    router.pump(clock.now)
    return record(router, reg, futs, trace=trace, in_flight=in_flight)


def check_routes_and_counts(pkg, rec):
    assert rec["in_flight"] == 4
    assert rec["outcomes"] == [("ok", expected(k, q)) for k, q in rec["trace"]]
    s = rec["stats"]
    assert s["served"] == 4 and s["in_flight"] == 0
    assert s["deaths"] == 0 and s["failovers"] == 0


def affinity(pkg):
    router, reps, clock, reg = make_router(pkg, 2)
    futs = [router.submit("sssp", query=q) for q in range(4)]
    return record(router, reg, futs,
                  inboxes=[len(r.inbox) for r in reps])


def check_affinity(pkg, rec):
    # all four go to ONE home replica until the load passes the slack
    assert max(rec["inboxes"]) >= 3


def least_loaded_spill(pkg):
    router, reps, clock, reg = make_router(pkg, 2, affinity_slack=0)
    futs = [router.submit("sssp", query=q) for q in range(6)]
    return record(router, reg, futs,
                  inboxes=[len(r.inbox) for r in reps])


def check_least_loaded_spill(pkg, rec):
    a, b = rec["inboxes"]
    assert abs(a - b) <= 1


def heartbeat_expiry(pkg):
    router, reps, clock, reg = make_router(pkg, 2)
    f = router.submit("sssp", query=7)
    serving = next(r for r in reps if r.inbox)
    other = next(r for r in reps if r is not serving)
    for _ in range(3):
        clock.advance(0.5)
        other.heartbeat()
        router.pump(clock.now)
    dead = not serving.alive()
    spawned = len(reps)
    failed_over = any(m[0] == "req" for m in other.inbox)
    other.complete()
    router.pump(clock.now)
    return record(router, reg, [f], dead=dead, spawned=spawned,
                  failed_over=failed_over)


def check_heartbeat_expiry(pkg, rec):
    assert rec["dead"] and rec["spawned"] == 3 and rec["failed_over"]
    assert rec["outcomes"] == [("ok", expected("sssp", 7))]
    snap = rec["snapshot"]
    assert snap["faults.replica.deaths"] == 1
    assert snap["faults.replica.failovers"] == 1
    assert snap["faults.replica.respawns"] == 1


def failover_budget(pkg):
    router, reps, clock, reg = make_router(pkg, 2)
    f = router.submit("sssp", query=1)
    deaths = 0
    while not f.done():
        serving = next((r for r in reps if r.inbox and r.alive()), None)
        assert serving is not None, "request parked with no serving replica"
        serving.die()
        deaths += 1
        clock.advance(0.01)
        router.pump(clock.now)
        assert deaths <= pkg.MAX_FAILOVERS + 2, "future never resolved"
    return record(router, reg, [f], deaths=deaths,
                  in_flight=router.in_flight())


def check_failover_budget(pkg, rec):
    assert rec["outcomes"] == [("err", "ReplicaLost")]
    assert rec["deaths"] == pkg.MAX_FAILOVERS + 1
    assert rec["snapshot"]["faults.replica.lost"] == 1
    assert rec["in_flight"] == 0


def close_drains(pkg):
    router, reps, clock, reg = make_router(pkg, 1, max_in_flight=1)
    f1 = router.submit("sssp", query=1)          # dispatched
    f2 = router.submit("sssp", query=2)          # parked (cap 1)
    router.close()
    f3 = router.submit("sssp", query=3)          # after close
    return record(router, reg, [f1, f2, f3], in_flight=router.in_flight())


def check_close_drains(pkg, rec):
    assert rec["outcomes"] == [("err", "FrontendClosed")] * 3
    assert rec["in_flight"] == 0


def overload_sheds(pkg):
    router, reps, clock, reg = make_router(pkg, 1, max_queue_depth=2)
    keep = [router.submit("sssp", query=q) for q in range(2)]
    shed = router.submit("sssp", query=99)
    shed_outcome = outcome(shed)
    reps[0].complete()
    router.pump(clock.now)
    return record(router, reg, keep, shed=shed_outcome)


def check_overload_sheds(pkg, rec):
    assert rec["shed"] == ("err", "Overloaded")
    assert rec["snapshot"]["serve.router.shed"] == 1
    assert rec["outcomes"] == [("ok", expected("sssp", q)) for q in range(2)]


def route_fault_point(pkg):
    inj = pkg.faults.FaultInjector(pkg.faults.FaultPlan(rules=(
        pkg.faults.FaultRule(point="router.route", trigger="nth", n=2,
                             error="fatal"),
    )))
    router, reps, clock, reg = make_router(pkg, 2, fault_injector=inj)
    f1 = router.submit("sssp", query=1)
    f2 = router.submit("sssp", query=2)          # nth=2: injected
    for r in reps:
        r.complete()
    router.pump(clock.now)
    return record(router, reg, [f1, f2], injector=inj.snapshot())


def check_route_fault_point(pkg, rec):
    assert rec["outcomes"] == [("ok", expected("sssp", 1)),
                               ("err", "InjectedFault")]
    assert rec["injector"]["never_fired"] == []
    assert rec["snapshot"]["serve.router.route_faults"] == 1


def broken_pipe_at_send(pkg):
    router, reps, clock, reg = make_router(pkg, 2)
    reps[0].break_pipe()
    futs = [router.submit("sssp", query=q) for q in range(3)]
    router.pump(clock.now)
    for r in [r for r in reps if r.alive()]:
        r.complete()
    router.pump(clock.now)
    return record(router, reg, futs)


def check_broken_pipe_at_send(pkg, rec):
    assert rec["outcomes"] == [("ok", expected("sssp", q)) for q in range(3)]


def all_dead_without_respawn(pkg):
    router, reps, clock, reg = make_router(pkg, 2, respawn=False)
    futs = [router.submit("sssp", query=q) for q in range(4)]
    for r in reps:
        r.die()
    clock.advance(0.01)
    router.pump(clock.now)
    late = router.submit("sssp", query=9)        # admission after loss
    return record(router, reg, futs + [late])


def check_all_dead_without_respawn(pkg, rec):
    assert rec["outcomes"] == [("err", "ReplicaLost")] * 5


def boot_timeout(pkg):
    clock = FakeClock()
    spawned = []

    def factory(i):
        r = FakeReplica(i)
        r.outbox.clear()                 # never says ready
        spawned.append(r)
        return r

    reg = pkg.MetricsRegistry()
    router = pkg.Router(factory, 1, boot_timeout_s=5.0, max_respawns=1,
                        clock=clock, registry=reg)
    f = router.submit("sssp", query=1)
    clock.advance(6.0)
    router.pump(clock.now)               # boot timeout -> dead -> respawn
    after_first = len(spawned)
    clock.advance(6.0)
    router.pump(clock.now)               # respawn also times out; budget 1
    return record(router, reg, [f], after_first=after_first)


def check_boot_timeout(pkg, rec):
    assert rec["after_first"] == 2
    assert rec["outcomes"] == [("err", "ReplicaLost")]


def max_in_flight(pkg):
    router, reps, clock, reg = make_router(pkg, 1, max_in_flight=2)
    futs = [router.submit("sssp", query=q) for q in range(5)]
    first = (len(reps[0].inbox), router.stats()["pending"])
    reps[0].complete()
    router.pump(clock.now)
    refilled = len(reps[0].inbox)
    while router.stats()["pending"] or router.in_flight():
        reps[0].complete()
        router.pump(clock.now)
    return record(router, reg, futs, first=first, refilled=refilled)


def check_max_in_flight(pkg, rec):
    assert rec["first"] == (2, 3) and rec["refilled"] == 2
    assert rec["outcomes"] == [("ok", expected("sssp", q)) for q in range(5)]


def stats_provider(pkg):
    router, reps, clock, reg = make_router(pkg, 2)
    f = router.submit("sssp", query=1)
    return record(router, reg, [f])


def check_stats_provider(pkg, rec):
    assert rec["snapshot"]["serve.router"]["replicas"] == 2
    assert rec["snapshot"]["serve.router"]["in_flight"] == 1
    assert rec["outcomes"] == ["pending"]


CASES = {
    "routes_and_counts": (routes_and_counts, check_routes_and_counts),
    "affinity": (affinity, check_affinity),
    "least_loaded_spill": (least_loaded_spill, check_least_loaded_spill),
    "heartbeat_expiry": (heartbeat_expiry, check_heartbeat_expiry),
    "failover_budget": (failover_budget, check_failover_budget),
    "close_drains": (close_drains, check_close_drains),
    "overload_sheds": (overload_sheds, check_overload_sheds),
    "route_fault_point": (route_fault_point, check_route_fault_point),
    "broken_pipe_at_send": (broken_pipe_at_send,
                            check_broken_pipe_at_send),
    "all_dead_without_respawn": (all_dead_without_respawn,
                                 check_all_dead_without_respawn),
    "boot_timeout": (boot_timeout, check_boot_timeout),
    "max_in_flight": (max_in_flight, check_max_in_flight),
    "stats_provider": (stats_provider, check_stats_provider),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_router_case_matches_reference(case):
    scenario, check = CASES[case]
    ref = scenario(PKGS["repro"])
    got = scenario(PKGS["repro_torch"])
    assert got == ref
    check(PKGS["repro_torch"], got)


def test_router_exports_and_budget_match_reference():
    import repro.serve as jserve
    import repro_torch.serve as tserve

    assert trouter.MAX_FAILOVERS == jrouter.MAX_FAILOVERS
    for name in ("Router", "ProcessReplica", "ReplicaConfig",
                 "DiskExecutableCache", "MAX_FAILOVERS"):
        assert name in tserve.__all__ and name in jserve.__all__
    # the handle interface the router consumes
    for attr in ("poll_messages", "send", "alive", "kill", "stop", "pid"):
        assert hasattr(tserve.ProcessReplica, attr)


# --------------------------------------------------------------------------
# the chaos property: random kill schedules x arrival orders, both packages
# --------------------------------------------------------------------------

def chaos(pkg, arrivals, kill_steps, per_step):
    router, reps, clock, reg = make_router(
        pkg, 2, max_respawns=50, heartbeat_timeout_ms=1000.0)
    kills = sorted(set(kill_steps))
    futs, keys = [], []
    step = 0
    pending_arrivals = list(enumerate(arrivals))
    while pending_arrivals or not all(f.done() for f in futs):
        assert step < 500, "chaos schedule failed to drain"
        if pending_arrivals:
            q, key_id = pending_arrivals.pop(0)
            key = f"k{key_id}"
            keys.append((key, q))
            futs.append(router.submit(key, query=q))
        if step in kills:
            live = [r for r in reps if r.alive() and r.inbox]
            if not live:
                live = [r for r in reps if r.alive()]
            if live:
                live[step % len(live)].die()
        for r in reps:
            if r.alive():
                r.complete(per_step)
                r.heartbeat()
        clock.advance(0.05)
        router.pump(clock.now)
        step += 1
    return record(router, reg, futs, keys=keys, kills=kills)


@given(
    st.lists(st.integers(min_value=0, max_value=5), min_size=4,
             max_size=24),                       # per-step arrivals (key id)
    st.lists(st.integers(min_value=0, max_value=30), min_size=0,
             max_size=6),                        # kill steps
    st.integers(min_value=1, max_value=3),       # completions per step
)
@settings(max_examples=40, deadline=None)
def test_chaos_every_request_resolves_as_the_reference(
        arrivals, kill_steps, per_step):
    ref = chaos(PKGS["repro"], arrivals, kill_steps, per_step)
    got = chaos(PKGS["repro_torch"], arrivals, kill_steps, per_step)
    assert got == ref
    ok = lost = 0
    for (key, q), res in zip(got["keys"], got["outcomes"]):
        if res == ("err", "ReplicaLost"):
            lost += 1
        else:
            assert res == ("ok", expected(key, q))
            ok += 1
    assert ok + lost == len(got["keys"])  # nothing hangs, nothing vanishes
    assert got["stats"]["in_flight"] == 0
    assert got["stats"]["pending"] == 0
    if not got["kills"]:
        assert lost == 0                  # fault-free: every value lands
