"""The serving tier: an async request front-end on the compile-once seam
(the port's counterpart of the JAX package's ``repro.serve``, its
in-process half).

``Engine.compile`` made one executable serve many queries — but only
for hand-assembled homogeneous batches.  This package turns that seam
into a request-serving subsystem:

* ``queue``    — the coalescing batcher (``CoalescingBatcher``): groups
  heterogeneous in-flight queries by (compiled path, hypergraph),
  admits per group up to the batch bucket, and flushes on deadline or
  full batch; ``AdaptiveDelay`` tunes the deadline.  Pure,
  clock-injected — property-testable without touching torch.
* ``frontend`` — the submission API (``Frontend.submit(spec_key, hg,
  query, deadline_ms) -> Future``): a worker thread drains the batcher
  into ``CompiledAlgorithm.run_batch`` and fans results back out to
  per-request futures, with retries, a poison bisect, a circuit breaker,
  deadlines and a worker supervisor.
* ``metrics``  — latency observability (``ServeMetrics``): p50/p99/p999
  histograms split queue-wait vs execute, per-bucket occupancy, flush
  reasons — exposed as ``Frontend.stats()`` and a periodic log line.
* ``cache``    — ``stable_digest`` (cross-process signature digests),
  the shared on-disk store (``DiskExecutableCache``: checksummed warmup
  records, a flock per signature, quarantine) and ``warm(engine,
  specs)``, the boot pass that captures every batch bucket before the
  first request.
* ``replica`` / ``router`` — multi-replica serving: N worker
  *processes* (``ProcessReplica``) each booting ``warm(...,
  require_no_retrace=True)`` from the ONE shared store, behind a
  ``Router`` doing affinity/least-loaded routing, heartbeat death
  detection, bounded failover (``ReplicaLost`` after ``MAX_FAILOVERS``),
  respawn from the store and ``Overloaded`` load shedding.  Results
  cross the pipe as numpy.

Entry point: ``repro_torch.launch.serve_hypergraph`` (a mixed SSSP/PPR
replay, in-process or through ``--replicas N``).
"""
from repro_torch.serve.cache import DiskExecutableCache, stable_digest, warm
from repro_torch.serve.frontend import Frontend, ServedResult
from repro_torch.serve.metrics import LatencyHistogram, ServeMetrics
from repro_torch.serve.queue import (
    AdaptiveDelay,
    CoalescingBatcher,
    Flush,
    Request,
)
from repro_torch.serve.replica import ProcessReplica, ReplicaConfig
from repro_torch.serve.router import MAX_FAILOVERS, Router

__all__ = [
    "AdaptiveDelay",
    "CoalescingBatcher",
    "DiskExecutableCache",
    "Flush",
    "Frontend",
    "LatencyHistogram",
    "MAX_FAILOVERS",
    "ProcessReplica",
    "ReplicaConfig",
    "Request",
    "Router",
    "ServedResult",
    "ServeMetrics",
    "stable_digest",
    "warm",
]
