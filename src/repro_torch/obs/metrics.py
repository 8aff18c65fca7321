"""The unified metrics registry: one ``snapshot()`` across the engine
(the port's own copy of the JAX package's ``repro.obs.metrics``).

Every subsystem that counts something — the Engine executable LRU, the
delivery layout builder — registers into one ``MetricsRegistry``
instead of growing its own ad-hoc dict.  Two registration styles:

* **owned metrics** (``counter`` / ``gauge`` / ``histogram``): the
  registry get-or-creates the instrument by name and owns its storage.
  Used by code without a natural stats object (the layout builder).
* **providers** (``register_provider(name, fn)``): a zero-arg callable
  returning a dict, merged into every ``snapshot()``.  Used by
  subsystems that already keep their own state (``Engine.cache_stats``).
  Providers are typically registered through ``weak_provider`` so a
  registry held in a module-global never keeps an Engine alive: a dead
  provider returns ``None`` and is pruned at the next snapshot.

``LatencyHistogram`` lives here: one log-spaced histogram
implementation, shared by the registry and the serving
tier.  The process-wide default registry is this package's own; the
JAX package's is a different object.
"""
from __future__ import annotations

import bisect
import math
import threading
import weakref
from typing import Any, Callable

# Histogram bin upper bounds: 1us .. ~4600s, quarter-decade spacing —
# ~2x resolution per bin, 40 bins, fixed memory.
_BOUNDS = [1e-6 * (10 ** (i / 4)) for i in range(40)]


class LatencyHistogram:
    """Fixed-bin log histogram over seconds; quantiles report the upper
    bound of the covering bin (<= ~78% relative overestimate at
    quarter-decade spacing — plenty for p50-vs-p999 shape)."""

    def __init__(self):
        self._counts = [0] * (len(_BOUNDS) + 1)
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        seconds = max(float(seconds), 0.0)
        self._counts[bisect.bisect_left(_BOUNDS, seconds)] += 1
        self.count += 1
        self.total += seconds
        self.max = max(self.max, seconds)

    def quantile(self, q: float) -> float:
        """Upper bound of the bin holding the q-quantile (0 when empty)."""
        if self.count == 0:
            return 0.0
        target = math.ceil(q * self.count)
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target:
                return _BOUNDS[i] if i < len(_BOUNDS) else self.max
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean_s": self.total / self.count if self.count else 0.0,
            "p50_s": self.quantile(0.50),
            "p99_s": self.quantile(0.99),
            "p999_s": self.quantile(0.999),
            "max_s": self.max,
        }


class Counter:
    """A monotonically increasing count (lock shared with the registry)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock):
        self.value = 0
        self._lock = lock

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """A point-in-time value (last write wins)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def set(self, v) -> None:
        with self._lock:
            self.value = v

    def snapshot(self):
        return self.value


class _LockedHistogram(LatencyHistogram):
    """Registry-owned histogram: records under the registry lock
    (multiple writers; ``ServeMetrics`` keeps its own lock instead)."""

    def __init__(self, lock):
        super().__init__()
        self._lock = lock

    def record(self, seconds: float) -> None:
        with self._lock:
            super().record(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            return super().snapshot()


class MetricsRegistry:
    """Counters/gauges/histograms + snapshot providers, one namespace."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, Any] = {}
        self._providers: dict[str, Callable[[], dict | None]] = {}

    # -- owned instruments -------------------------------------------------

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self._lock)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> LatencyHistogram:
        return self._get(name, _LockedHistogram)

    # -- providers ---------------------------------------------------------

    def register_provider(
        self, name: str, fn: Callable[[], dict | None]
    ) -> str:
        """Merge ``fn()`` into every snapshot under ``name`` (suffixed
        ``#2``, ``#3``... on collision).  Returns the registered name.
        A provider returning ``None`` (dead weakref) is pruned."""
        with self._lock:
            base, n, unique = name, 2, name
            while unique in self._providers:
                unique = f"{base}#{n}"
                n += 1
            self._providers[unique] = fn
            return unique

    def unregister_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    # -- the one snapshot --------------------------------------------------

    def snapshot(self) -> dict:
        """Every owned instrument + every live provider, one dict."""
        with self._lock:
            out: dict[str, Any] = {
                name: m.snapshot() for name, m in self._metrics.items()
            }
            dead = []
            for name, fn in self._providers.items():
                try:
                    v = fn()
                except Exception as err:  # noqa: BLE001 - keep snapshotting
                    v = {"error": repr(err)}
                if v is None:
                    dead.append(name)
                else:
                    out[name] = v
            for name in dead:
                del self._providers[name]
            return out


def weak_provider(method) -> Callable[[], dict | None]:
    """Wrap a bound method as a provider that dies with its owner."""
    ref = weakref.WeakMethod(method)

    def call():
        m = ref()
        return m() if m is not None else None

    return call


# -- the process-wide default (what Engine / serve wire into) --------------

_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Fresh default registry (test isolation); returns the new one.
    Objects constructed before the reset keep writing to the old one."""
    global _DEFAULT
    _DEFAULT = MetricsRegistry()
    return _DEFAULT
