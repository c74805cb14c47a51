"""Typed metric registry of the port: counters, gauges, histograms.

A copy of ``brainiak_tpu.obs.metrics``.  Prometheus-shaped but
dependency-free: a metric has a name, an optional unit, and
per-label-set values; updates are thread-safe and always reflected in
the in-process registry (:func:`collect`), and — when obs is enabled —
every update additionally emits a ``metric`` record to the sinks, so
the JSONL trace carries the raw increments / sets / observations.

Names and labels are the JAX package's: ``*_total`` for counters
(``fit_steps_total{estimator=}``, ``rollback_total``), ``*_seconds``
for time histograms (``checkpoint_seconds``), so one report reads the
records of either package.
"""

import threading

from . import sink
from .sketch import QuantileSketch

__all__ = [
    "HISTOGRAM_QUANTILES",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "collect",
    "counter",
    "default_registry",
    "gauge",
    "histogram",
    "reset",
]

#: Quantiles histograms surface in :func:`collect` summaries.
HISTOGRAM_QUANTILES = (0.5, 0.9, 0.99)


def _label_key(labels):
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Base: name, unit, per-label-set values behind one lock."""

    mtype = None

    def __init__(self, name, help="", unit=None):
        self.name = name
        self.help = help
        self.unit = unit
        self._values = {}
        self._lock = threading.Lock()

    def _emit(self, value, labels):
        if sink.enabled():
            sink.emit(sink.make_record(
                "metric", self.name, mtype=self.mtype,
                value=float(value),
                labels={k: str(v) for k, v in labels.items()} or None,
                unit=self.unit))

    def labelsets(self):
        with self._lock:
            return [dict(key) for key in self._values]

    def samples(self):
        """[(labels dict, value)] — histograms yield summary dicts."""
        with self._lock:
            return [(dict(key), value if not isinstance(value, dict)
                     else dict(value))
                    for key, value in self._values.items()]


class Counter(_Metric):
    """Monotonically increasing count; emitted records carry the
    increment (the report CLI sums them)."""

    mtype = "counter"

    def inc(self, amount=1, **labels):
        if amount < 0:
            raise ValueError(
                f"counter {self.name} increment must be >= 0, "
                f"got {amount}")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) \
                + float(amount)
        self._emit(amount, labels)

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)


class Gauge(_Metric):
    """Point-in-time value; emitted records carry the set value (the
    report CLI keeps the last)."""

    mtype = "gauge"

    def set(self, value, **labels):
        key = _label_key(labels)
        with self._lock:
            self._values[key] = float(value)
        self._emit(value, labels)

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels))


class Histogram(_Metric):
    """Streaming summary (count/sum/min/max + sketch quantiles) per
    label set; emitted records carry each observation.

    Every label set is additionally backed by a mergeable
    :class:`~brainiak_tpu_torch.obs.sketch.QuantileSketch`, so
    :meth:`summary`/:func:`collect` report real p50/p90/p99 values
    (:data:`HISTOGRAM_QUANTILES`, bounded relative error) instead of
    only the min/max envelope, and :meth:`sketch` hands a **copy**
    out for cross-replica merging."""

    mtype = "histogram"

    def __init__(self, name, help="", unit=None):
        super().__init__(name, help=help, unit=unit)
        # accessed under the base _Metric._lock, like _values (the
        # lock-rule annotation lives with locks declared in the
        # same class; the base holds this one)
        self._sketches = {}

    def observe(self, value, **labels):
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            cur = self._values.get(key)
            if cur is None:
                self._values[key] = {"count": 1, "sum": value,
                                     "min": value, "max": value}
                self._sketches[key] = QuantileSketch()
            else:
                cur["count"] += 1
                cur["sum"] += value
                cur["min"] = min(cur["min"], value)
                cur["max"] = max(cur["max"], value)
            self._sketches[key].observe(value)
        self._emit(value, labels)

    def summary(self, **labels):
        with self._lock:
            cur = self._values.get(_label_key(labels))
            if not cur:
                return None
            out = dict(cur)
            out.update(self._quantile_fields(_label_key(labels)))
            return out

    def _quantile_fields(self, key):
        # callers hold the base _Metric._lock
        sk = self._sketches.get(key)
        if sk is None:
            return {}
        return {f"p{int(q * 100)}": sk.quantile(q)
                for q in HISTOGRAM_QUANTILES}

    def quantile(self, q, **labels):
        """The ``q``-quantile of one label set's observations (None
        before the first observation)."""
        with self._lock:
            sk = self._sketches.get(_label_key(labels))
            return sk.quantile(q) if sk is not None else None

    def sketch(self, **labels):
        """A **copy** of one label set's sketch (None before the
        first observation) — safe to merge/serialize without racing
        :meth:`observe`."""
        with self._lock:
            sk = self._sketches.get(_label_key(labels))
            return QuantileSketch.from_dict(sk.to_dict()) \
                if sk is not None else None

    def samples(self):
        """[(labels dict, summary dict incl. sketch quantiles)]."""
        with self._lock:
            return [(dict(key),
                     dict(value, **self._quantile_fields(key)))
                    for key, value in self._values.items()]


class MetricsRegistry:
    """Get-or-create registry; re-registering a name with a different
    metric type is an error (a counter silently shadowed by a gauge
    would corrupt every report)."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, unit):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name, help=help,
                                                   unit=unit)
            elif type(metric) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{metric.mtype}, not {cls.mtype}")
            return metric

    def counter(self, name, help="", unit=None):
        return self._get(Counter, name, help, unit)

    def gauge(self, name, help="", unit=None):
        return self._get(Gauge, name, help, unit)

    def histogram(self, name, help="", unit=None):
        return self._get(Histogram, name, help, unit)

    def collect(self):
        """Flat samples: [{name, mtype, unit, labels, value}] sorted
        by name then labels (histogram value is a summary dict)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = []
        for metric in metrics:
            for labels, value in metric.samples():
                out.append({"name": metric.name,
                            "mtype": metric.mtype,
                            "unit": metric.unit,
                            "help": metric.help,
                            "labels": labels,
                            "value": value})
        out.sort(key=lambda s: (s["name"], sorted(s["labels"].items())))
        return out

    def reset(self):
        """Drop every metric (registrations included) — test isolation."""
        with self._lock:
            self._metrics.clear()


default_registry = MetricsRegistry()


def counter(name, help="", unit=None):
    """Get-or-create a :class:`Counter` in the default registry."""
    return default_registry.counter(name, help=help, unit=unit)


def gauge(name, help="", unit=None):
    """Get-or-create a :class:`Gauge` in the default registry."""
    return default_registry.gauge(name, help=help, unit=unit)


def histogram(name, help="", unit=None):
    """Get-or-create a :class:`Histogram` in the default registry."""
    return default_registry.histogram(name, help=help, unit=unit)


def collect():
    """Samples of the default registry (see ``MetricsRegistry.collect``)."""
    return default_registry.collect()


def reset():
    """Reset the default registry."""
    return default_registry.reset()
