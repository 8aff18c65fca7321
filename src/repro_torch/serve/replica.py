"""One serving replica: a worker *process* booted from the shared store
(the port's counterpart of the JAX package's ``repro.serve.replica``).

The unit the ``Router`` (``repro_torch.serve.router``) replicates:

* ``ReplicaConfig`` — everything a replica needs to boot, picklable
  across a ``spawn`` boundary: a **builder reference**
  (``"pkg.mod:function"`` resolved by import, never a pickled closure)
  plus its kwargs, the shared ``DiskExecutableCache`` directory, the
  coalescing knobs, an optional ``FaultPlan`` JSON armed *inside* the
  replica, and the port's ``device`` and ``exec_cache_bytes``.
* ``replica_main(conn, config)`` — the child-process entry point: build
  the engine, ``serve.warm(..., require_no_retrace=config.
  require_no_retrace)`` from the shared store (every batch bucket up to
  ``max_batch``: the CUDA graphs are captured at boot, and the store's
  records say each capture is expected), then serve a pipe loop — one
  ``Frontend`` coalesces and executes, the loop receives requests and
  streams results + periodic heartbeats back.
* ``ProcessReplica`` — the router-side handle: spawn, non-blocking
  message drain, liveness (pipe EOF / exit code), kill (-9, for chaos
  tests) and stop.

Results cross the pipe as numpy: ``import torch`` registers pickler
reductions that would send a card tensor as a CUDA IPC handle (the
router would start CUDA to open it, and the handle dies with a killed
replica) and a host tensor as a shared-memory descriptor.  The copy to
the host runs on a stream of the calling thread's own: a done callback
runs on the pipe loop's thread when its future is already done, while
the ``Frontend`` worker may be inside a capture.

Fault points (armed via ``config.fault_plan``): ``replica.crash`` fires
``os._exit`` — the in-process model of kill -9, losing every in-flight
request exactly like a real crash — and ``replica.hang`` stops
heartbeats without exiting, so the router's missed-heartbeat detector
(not pipe EOF) has to catch it.  Before either acts, the replica sends
one last heartbeat carrying its injector's snapshot, so a chaos report
can count the fault.

Wire protocol (pickled tuples over a ``multiprocessing.Pipe``):
router->replica ``("req", id, spec_key, query, hg_ref, deadline_ms)``
and ``("stop",)``; replica->router ``("ready", boot_report)``,
``("hb", stats)``, ``("res", id, ServedResult)``, ``("err", id, exc)``,
``("fatal", repr)`` on a boot failure, ``("bye", stats)`` on a clean
stop.  The port adds to the boot report ``warm_records`` (the store's),
``engine_traces`` (the Engine's trace counter after warm),
``memory_reserved`` (``torch.cuda.memory_reserved`` on the card, else
0) and ``kernel_launches`` (K1's launch counter in this process); and
to every heartbeat ``traces`` (the Engine's trace counter: it must not
move after warm), ``flushes`` (the ``Frontend``'s), ``kernel_launches``
and ``faults`` (the injector's snapshot, or ``None``).  At-least-once
execution is safe: a failed-over request
re-runs the same compiled executable on a peer.
"""
from __future__ import annotations

import dataclasses
import importlib
import multiprocessing
import os
import pickle
import threading
import time
from functools import partial

_CRASH_EXIT = 13      # replica.crash's exit code: distinguishable from 0


@dataclasses.dataclass(frozen=True)
class ReplicaConfig:
    """Everything one replica process needs to boot, picklable.

    ``builder`` is an import reference ``"package.module:function"``;
    called with ``**kwargs`` and ``device=`` in the CHILD process it
    returns::

        {"specs": {spec_key: AlgorithmSpec},        # required, ordered
         "warm_queries": [example per spec] | None, # for query0-free specs
         "hypergraphs": {hg_ref: HyperGraph} | None}

    so nothing unpicklable (specs close over functions) ever crosses
    the process boundary.  ``require_no_retrace=True`` is the fleet
    contract: the shared store was prepared, so a boot that has to make
    an executable the store holds no record of raises ``RetraceError``.
    ``device``: where the replica runs (the card by default; the tests
    pass ``"cpu"``).  ``exec_cache_bytes``: its Engine's LRU byte bound
    (``None``: the Engine's default, a quarter of the card — replicas
    sharing one card each take a share).
    """

    builder: str
    kwargs: dict = dataclasses.field(default_factory=dict)
    cache_dir: str | None = None
    max_batch: int = 16
    max_delay_ms: float = 5.0
    heartbeat_interval_s: float = 0.1
    fault_plan: str | None = None
    seed_offset: int = 0
    require_no_retrace: bool = True
    hang_s: float = 60.0
    index: int = 0
    device: str = "cuda"
    exec_cache_bytes: int | None = None


def resolve_builder(ref: str):
    """``"pkg.mod:function"`` -> the callable (child-side import)."""
    mod, _, fn = ref.partition(":")
    if not mod or not fn:
        raise ValueError(
            f"builder reference {ref!r} must be 'package.module:function'"
        )
    return getattr(importlib.import_module(mod), fn)


def _picklable(err: BaseException) -> BaseException:
    """The error as something the pipe can carry; typed errors from the
    taxonomy round-trip as themselves, exotic ones degrade to repr."""
    try:
        pickle.loads(pickle.dumps(err))
        return err
    except Exception:
        return RuntimeError(f"{type(err).__name__}: {err}")


_HOST = threading.local()


def _to_host(x):
    """One result leaf as numpy.  A card tensor is copied on a stream of
    this thread's own (never the legacy default stream, which another
    thread's open capture may not tolerate); the ``Frontend`` has
    synchronized the flush's stream already."""
    import numpy as np
    import torch

    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if x.device.type == "cuda":
        stream = getattr(_HOST, "stream", None)
        if stream is None:
            stream = _HOST.stream = torch.cuda.Stream(x.device)
        with torch.cuda.stream(stream):
            return x.cpu().numpy()
    return x.numpy()


def replica_main(conn, config: ReplicaConfig) -> None:
    """Child-process entry point: boot from the shared store, serve the
    pipe loop until ``("stop",)`` or pipe EOF."""
    try:
        _serve_replica(conn, config)
    except BaseException as err:
        # Boot failures (builder import, warm RetraceError, ...) reach
        # the router as one typed message; the exit code seals it.
        try:
            conn.send(("fatal", f"{type(err).__name__}: {err}"))
        except Exception:
            pass
        raise


def _serve_replica(conn, config: ReplicaConfig) -> None:
    import torch

    from repro_torch.core import Engine, tree_map
    from repro_torch.kernels.deliver import fused
    from repro_torch.launch.serve_hypergraph import batch_buckets
    from repro_torch.serve.cache import DiskExecutableCache, warm
    from repro_torch.serve.frontend import Frontend

    injector = None
    if config.fault_plan:
        from repro_torch.faults import FaultInjector, FaultPlan

        plan = FaultPlan.from_json(config.fault_plan)
        if config.seed_offset:
            # Each spawned INSTANCE draws a distinct probabilistic fault
            # stream.  Without this a respawned replica re-arms the same
            # seed, replays the same draws against the requeued backlog,
            # and deterministically crashes at the same received-count —
            # a respawn cascade that serves nothing forever.
            plan = FaultPlan(rules=tuple(
                dataclasses.replace(r, seed=r.seed + config.seed_offset)
                if r.trigger == "prob" else r
                for r in plan.rules
            ))
        injector = FaultInjector(plan)
    store = DiskExecutableCache(config.cache_dir, device=config.device)
    engine = Engine(
        device=config.device,
        disk_cache=store,
        fault_injector=injector,
        exec_cache_bytes=config.exec_cache_bytes,
    )
    built = resolve_builder(config.builder)(
        **{**config.kwargs, "device": config.device})
    specs = built["specs"]
    hgs = built.get("hypergraphs") or {}
    report = warm(
        engine, list(specs.values()),
        batch_sizes=batch_buckets(config.max_batch),
        queries=built.get("warm_queries"),
        require_no_retrace=config.require_no_retrace,
    )
    fe = Frontend(
        engine, max_batch=config.max_batch,
        max_delay_ms=config.max_delay_ms,
    )
    for key, spec in specs.items():
        fe.register(key, spec)

    # One pipe, two writers: this loop (heartbeats) and the front-end's
    # worker thread (done callbacks) — Connection is not thread-safe.
    send_lock = threading.Lock()
    counts = {"received": 0, "completed": 0, "errors": 0}

    def _send(msg) -> bool:
        with send_lock:
            try:
                conn.send(msg)
                return True
            except (BrokenPipeError, OSError, ValueError):
                return False   # router gone; the loop will exit

    def _stats() -> dict:
        return {
            **counts,
            "traces": engine.cache_stats()["traces"],
            "flushes": sum(fe.metrics.snapshot()["flush_reasons"].values()),
            "kernel_launches": {
                "deliver_fused": fused.deliver_fused_cuda.launches},
            "faults": injector.snapshot() if injector is not None else None,
        }

    def _on_done(req_id: int, fut) -> None:
        try:
            served = fut.result()
            served = dataclasses.replace(
                served, value=tree_map(_to_host, served.value))
        except BaseException as err:  # typed FaultError fans back typed
            counts["errors"] += 1
            _send(("err", req_id, _picklable(err)))
        else:
            counts["completed"] += 1
            _send(("res", req_id, served))

    fe.start()
    stop = False
    try:
        dev = engine.device
        _send(("ready", {
            "index": config.index,
            "pid": os.getpid(),
            "boot_s": report["boot_s"],
            "traces": report["traces"],
            "from_disk": report["from_disk"],
            "compiled": report["compiled"],
            "warm_records": store.stats()["warm_records"],
            "engine_traces": engine.cache_stats()["traces"],
            "memory_reserved": (torch.cuda.memory_reserved(dev)
                                if dev.type == "cuda" else 0),
            "kernel_launches": {
                "deliver_fused": fused.deliver_fused_cuda.launches},
        }))
        next_hb = time.monotonic() + config.heartbeat_interval_s
        while not stop:
            if conn.poll(max(next_hb - time.monotonic(), 0.0)):
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    break          # router died: no one left to serve
                if msg[0] == "stop":
                    stop = True
                elif msg[0] == "req":
                    _, req_id, spec_key, query, hg_ref, deadline_ms = msg
                    counts["received"] += 1
                    if injector is not None and not _chaos_gate(
                        injector, config,
                        lambda: _send(("hb", _stats())),
                    ):
                        continue   # hang fired: request lost, as planned
                    try:
                        hg = hgs[hg_ref] if hg_ref is not None else None
                        fut = fe.submit(
                            spec_key, hg=hg, query=query,
                            deadline_ms=deadline_ms,
                        )
                    except Exception as err:   # unknown key / closed
                        counts["errors"] += 1
                        _send(("err", req_id, _picklable(err)))
                    else:
                        fut.add_done_callback(partial(_on_done, req_id))
            now = time.monotonic()
            if now >= next_hb:
                if not _send(("hb", _stats())):
                    break
                next_hb = now + config.heartbeat_interval_s
    finally:
        # Graceful stop: requests still queued fail typed
        # (FrontendClosed) and their callbacks stream the errors back
        # before the pipe closes.
        fe.close()
        _send(("bye", _stats()))
        try:
            conn.close()
        except Exception:
            pass  # last act of a dying process; no one left to tell


def _chaos_gate(injector, config: ReplicaConfig, last_words) -> bool:
    """Fire the per-request replica fault points.  ``replica.crash``
    hard-exits (the kill -9 model: in-flight requests are simply gone);
    ``replica.hang`` sleeps without heartbeating so ONLY the router's
    missed-heartbeat detector can declare this replica dead.  Either
    first calls ``last_words`` (one heartbeat with the injector's
    snapshot).  Returns False when the current request should be
    dropped (hang fired)."""
    try:
        injector.maybe_raise("replica.crash", replica=config.index)
    except BaseException:
        last_words()
        os._exit(_CRASH_EXIT)
    try:
        injector.maybe_raise("replica.hang", replica=config.index)
    except BaseException:
        last_words()
        time.sleep(config.hang_s)   # the router will kill us first
        return False
    return True


class ProcessReplica:
    """Router-side handle on one spawned replica process.

    The interface the ``Router`` consumes (and chaos tests fake):
    ``poll_messages`` (non-blocking drain), ``send`` (raises on a
    broken pipe), ``alive`` (pipe + exit-code liveness), ``stop``
    (graceful or forced), ``kill`` (SIGKILL, for chaos tests) and
    ``connection`` (waitable, for the router thread's poll).
    ``faults`` is the last injector snapshot the replica reported (in a
    heartbeat or its ``bye``), for a chaos report across instances.
    """

    def __init__(self, index: int, config: ReplicaConfig):
        ctx = multiprocessing.get_context("spawn")
        parent, child = ctx.Pipe()
        self.index = index
        self.process = ctx.Process(
            target=replica_main,
            args=(child, dataclasses.replace(config, index=index)),
            name=f"repro-torch-replica-{index}",
            daemon=True,
        )
        self.process.start()
        child.close()
        self.connection = parent
        self._broken = False
        self.faults: dict | None = None

    @property
    def pid(self) -> int | None:
        return self.process.pid

    def poll_messages(self) -> list:
        """Drain every message currently in the pipe, non-blocking.
        A broken pipe marks the handle dead instead of raising — the
        messages drained before the break are still delivered."""
        out: list = []
        try:
            while not self._broken and self.connection.poll(0):
                out.append(self.connection.recv())
        except (EOFError, OSError):
            self._broken = True
        for msg in out:
            if msg[0] in ("hb", "bye") and msg[1].get("faults"):
                self.faults = msg[1]["faults"]
        return out

    def send(self, msg) -> None:
        if self._broken:
            raise BrokenPipeError(f"replica {self.index} pipe is down")
        try:
            self.connection.send(msg)
        except (BrokenPipeError, OSError, ValueError):
            self._broken = True
            raise

    def alive(self) -> bool:
        return not self._broken and self.process.exitcode is None

    def kill(self) -> None:
        """SIGKILL, no warning — the chaos tests' real kill -9."""
        try:
            self.process.kill()
        except Exception:
            pass

    def stop(self, force: bool = False, join_s: float = 5.0) -> None:
        """Tear the process down.  Graceful sends ``("stop",)`` and
        waits; ``force=True`` (death declaration: the replica missed
        heartbeats or broke its pipe) goes straight to terminate so a
        wedged process can't stall the failover path."""
        if not force:
            try:
                self.send(("stop",))
            except Exception:
                pass
            self.process.join(join_s)
        if self.process.exitcode is None:
            self.process.terminate()
            self.process.join(1.0)
        if self.process.exitcode is None:
            self.process.kill()
            self.process.join(1.0)
        self._broken = True
        try:
            self.connection.close()
        except Exception:
            pass
