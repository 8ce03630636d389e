"""Process-local metrics registry: counters, gauges, histograms.

Port of ``dmosopt_tpu/telemetry/registry.py``, a copy (pure Python).

The registry is deliberately tiny and dependency-free — a dict of
counters (monotonic floats), gauges (last value wins) and histograms
(fixed bucket boundaries, plus running min/max/sum/count), each keyed by
``(name, sorted label items)``. It is the in-process aggregation layer
under the telemetry facade: every emission is one dict update, cheap
enough to stay on by default, and `snapshot()` renders the whole state
as plain JSON-able types for logs, tests, and the HDF5 epoch summary.

Metric names are lowercase snake_case and must appear in the catalog in
``docs/observability.md`` (enforced by ``tools/lint_metrics.py`` /
``make lint-metrics``).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

# Log-spaced seconds-oriented default buckets: phase durations span
# ~1 ms (a cached surrogate predict) to minutes (a cold-compile epoch).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, math.inf,
)


def _label_key(labels: Dict) -> Tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: Tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count", "min", "max")

    def __init__(self, buckets: Sequence[float]):
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or bs[-1] != math.inf:
            bs = bs + (math.inf,)
        self.buckets = bs
        self.counts = [0] * len(bs)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float):
        v = float(value)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def summary(self) -> Dict:
        out = {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": (self.sum / self.count) if self.count else None,
            "buckets": {
                ("inf" if math.isinf(b) else repr(b)): c
                for b, c in zip(self.buckets, self.counts)
                if c
            },
        }
        return out


class MetricsRegistry:
    """Counters / gauges / histograms with labels.

    All mutators take the metric name, a value, and free-form keyword
    labels; each distinct label combination is an independent series.
    Thread-safe: the driver's evaluator thread pool may emit from
    worker threads.
    """

    # collapsed label set served once a metric exceeds the series limit
    _OVERFLOW_LABELS = (("overflow", "true"),)

    def __init__(
        self,
        histogram_buckets: Optional[Dict[str, Sequence[float]]] = None,
        series_limit: Optional[int] = 512,
    ):
        self._counters: Dict[Tuple, float] = {}
        self._gauges: Dict[Tuple, float] = {}
        self._histograms: Dict[Tuple, _Histogram] = {}
        self._buckets_by_name = dict(histogram_buckets or {})
        self._lock = threading.Lock()
        # label-cardinality guard: at most `series_limit` distinct label
        # combinations per metric name; later combinations collapse into
        # one {overflow="true"} series and are counted by the
        # `telemetry_series_overflow_total` counter. Per-tenant label
        # values at 64-256 tenants are exactly the explosion this
        # bounds; None disables the guard.
        self._series_limit = series_limit
        self._series_count: Dict[str, int] = {}

    # ------------------------------------------------------------ mutators

    def _guarded_key(self, store: Dict, name: str, labels: Dict) -> Tuple:
        """Series key for (name, labels), applying the cardinality
        guard. Caller must hold the lock."""
        key = (name, _label_key(labels))
        if self._series_limit is None or not labels or key in store:
            return key
        n = self._series_count.get(name, 0)
        if n >= self._series_limit:
            okey = ("telemetry_series_overflow_total", ())
            self._counters[okey] = self._counters.get(okey, 0.0) + 1.0
            return (name, self._OVERFLOW_LABELS)
        self._series_count[name] = n + 1
        return key

    def counter_inc(self, name: str, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(f"counter {name!r}: negative increment {value}")
        with self._lock:
            key = self._guarded_key(self._counters, name, labels)
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def gauge_set(self, name: str, value: float, **labels):
        with self._lock:
            key = self._guarded_key(self._gauges, name, labels)
            self._gauges[key] = float(value)

    def histogram_observe(self, name: str, value: float, **labels):
        with self._lock:
            key = self._guarded_key(self._histograms, name, labels)
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = _Histogram(
                    self._buckets_by_name.get(name, DEFAULT_BUCKETS)
                )
            h.observe(value)

    # ------------------------------------------------------------- queries
    #
    # Queries hold the same lock as the mutators: a histogram summary
    # reads five fields of an object another thread may be mid-observe
    # on, and the exposition layer promises that what `/metrics` serves
    # agrees EXACTLY with a `snapshot()` taken at the same instant — a
    # lock-free read could serve a count that includes an observation
    # whose sum does not (a torn view).

    def counter_value(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0.0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        with self._lock:
            return self._gauges.get((name, _label_key(labels)))

    def histogram_summary(self, name: str, **labels) -> Optional[Dict]:
        with self._lock:
            h = self._histograms.get((name, _label_key(labels)))
            return h.summary() if h is not None else None

    def metric_names(self) -> set:
        with self._lock:
            return {
                name
                for store in (self._counters, self._gauges, self._histograms)
                for (name, _) in store
            }

    def snapshot(self) -> Dict:
        """The whole registry as nested plain dicts:
        ``{"counters": {name: {label_str: value}}, "gauges": {...},
        "histograms": {name: {label_str: summary}}}``.

        The entire snapshot — every counter, gauge, and histogram
        summary — is built under ONE lock acquisition, so concurrent
        emission can never produce a torn view: what the OpenMetrics
        exposition serves is exactly one instant of the registry
        (pinned by the threaded hammer test in tests/test_telemetry.py).
        """
        with self._lock:
            out = {"counters": {}, "gauges": {}, "histograms": {}}
            for (name, key), v in self._counters.items():
                out["counters"].setdefault(name, {})[_label_str(key)] = v
            for (name, key), v in self._gauges.items():
                out["gauges"].setdefault(name, {})[_label_str(key)] = v
            for (name, key), h in self._histograms.items():
                out["histograms"].setdefault(name, {})[_label_str(key)] = h.summary()
            return out
