"""Engine-wide observability, in PyTorch: trace spans, explain/calibrate,
metrics (the port's counterpart of the JAX package's ``repro.obs``).

* ``trace``     — clock-injected, ring-buffered ``Tracer`` recording
  phase spans (layout build, compile, execute) with device time from
  ``torch.cuda.synchronize`` deltas; exports Chrome-trace JSON
  loadable in Perfetto.  Attach with ``Engine(tracer=Tracer())``;
  zero overhead when absent.
* ``metrics``   — the unified ``MetricsRegistry`` (counters, gauges,
  log-spaced histograms, snapshot providers) every counting subsystem
  registers into; one ``snapshot()``, surfaced via ``--metrics-json``
  on the launcher.  Process-global, and not the JAX package's.
* ``calibrate`` — predicted-vs-measured residuals per ``auto`` axis:
  ``Engine.explain(spec)`` reports every candidate's predicted cost
  without executing; ``Engine.run`` enriches ``Result.decision`` with
  measured counterparts; this module compares the two in log2 space.
"""
from repro_torch.obs.calibrate import (
    decision_residuals,
    delivery_calibration,
    delivery_traffic_pair,
    executed_supersteps,
    fused_traffic,
    reference_traffic,
    residual_log2,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    LatencyHistogram,
    MetricsRegistry,
    default_registry,
    reset_default_registry,
    weak_provider,
)
from repro_torch.obs.trace import Span, Tracer, maybe_span

__all__ = [
    "Counter",
    "Gauge",
    "LatencyHistogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "decision_residuals",
    "default_registry",
    "delivery_calibration",
    "delivery_traffic_pair",
    "executed_supersteps",
    "fused_traffic",
    "maybe_span",
    "reference_traffic",
    "reset_default_registry",
    "residual_log2",
    "weak_provider",
]
