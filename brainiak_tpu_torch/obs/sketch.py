"""Mergeable bounded-relative-error quantile sketches (the port's copy).

A copy of ``brainiak_tpu.obs.sketch`` (pure Python): on the same
stream of observations it gives the same buckets, so the same
quantiles and merges, bit for bit.

:class:`QuantileSketch` is a DDSketch-style log-bucketed sketch
(Masson, Rim & Lee, VLDB 2019): values are mapped to geometrically
sized buckets ``gamma^k`` with ``gamma = (1 + alpha) / (1 - alpha)``,
so any reported quantile is within **relative** error ``alpha`` of an
exact rank statistic — ``|q_est - q_true| <= alpha * q_true`` — at
any scale from microseconds to hours, with no prior min/max hints.

- ``observe`` is O(1) (a log, a dict increment);
- memory is bounded by ``max_buckets`` (the smallest buckets collapse
  together, preserving the error bound for the upper quantiles);
- ``merge`` is **exact**: ``a.merge(b)`` yields the same sketch as
  observing both streams into one (bucket-wise addition), so pooled
  quantiles carry the same ``alpha`` bound as local ones;
- ``to_dict``/``from_dict`` round-trip through JSON, so sketches
  travel in records between processes (and between the packages).

Thread-safety: none here, by design — the holder synchronizes
(:class:`~brainiak_tpu_torch.obs.metrics.Histogram` under its metric
lock); an internal lock would double-lock the hot path.
"""

import math

__all__ = ["DEFAULT_MAX_BUCKETS", "DEFAULT_RELATIVE_ACCURACY",
           "QuantileSketch"]

#: Default relative accuracy ``alpha``: a reported p99 of 100 ms is
#: within +-1 ms of the exact rank statistic.
DEFAULT_RELATIVE_ACCURACY = 0.01

#: Default bucket-count bound.  At alpha=0.01 (gamma~1.0202) 2048
#: buckets span ~17 orders of magnitude — microseconds to weeks —
#: before any collapse happens.
DEFAULT_MAX_BUCKETS = 2048


class QuantileSketch:
    """DDSketch-style mergeable quantile summary.

    Parameters
    ----------
    relative_accuracy : float
        The ``alpha`` bound: quantile answers are within
        ``alpha * true_value`` of exact.  Must be in (0, 1).
    max_buckets : int
        Memory bound: when the positive store would exceed this many
        buckets, the smallest buckets collapse into one.  Upper
        quantiles keep their error bound; collapsed low quantiles
        degrade toward the collapse boundary (the right trade for
        latency telemetry, where the tail is the product).
    """

    __slots__ = ("relative_accuracy", "max_buckets", "_gamma",
                 "_log_gamma", "_buckets", "_neg_buckets",
                 "_zero_count", "count", "sum", "min", "max")

    def __init__(self, relative_accuracy=DEFAULT_RELATIVE_ACCURACY,
                 max_buckets=DEFAULT_MAX_BUCKETS):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError(
                "relative_accuracy must be in (0, 1), got "
                f"{relative_accuracy}")
        if max_buckets < 2:
            raise ValueError(
                f"max_buckets must be >= 2, got {max_buckets}")
        self.relative_accuracy = float(relative_accuracy)
        self.max_buckets = int(max_buckets)
        self._gamma = (1.0 + relative_accuracy) \
            / (1.0 - relative_accuracy)
        self._log_gamma = math.log(self._gamma)
        self._buckets = {}      # key -> count (positive values)
        self._neg_buckets = {}  # key -> count (negative magnitudes)
        self._zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    # -- ingest -------------------------------------------------------

    def _key(self, magnitude):
        # ceil(log_gamma(x)): every value in (gamma^(k-1), gamma^k]
        # shares bucket k, whose representative midpoint is within
        # alpha relative error of any member
        return int(math.ceil(math.log(magnitude) / self._log_gamma))

    def observe(self, value):
        """Add one observation (O(1)); non-finite values raise."""
        value = float(value)
        if not math.isfinite(value):
            raise ValueError(
                f"sketch observations must be finite, got {value}")
        self.count += 1
        self.sum += value
        self.min = value if self.min is None \
            else min(self.min, value)
        self.max = value if self.max is None \
            else max(self.max, value)
        if value == 0.0:
            self._zero_count += 1
            return
        store = self._buckets if value > 0 else self._neg_buckets
        key = self._key(abs(value))
        store[key] = store.get(key, 0) + 1
        if len(store) > self.max_buckets:
            self._collapse(store)

    def _collapse(self, store):
        """Fold the smallest buckets together until the bound holds
        (DDSketch's collapsing strategy: the tail quantiles keep
        their guarantee; the collapsed low end reports the collapse
        boundary)."""
        keys = sorted(store)
        while len(store) > self.max_buckets:
            lowest = keys.pop(0)
            store[keys[0]] = store.get(keys[0], 0) \
                + store.pop(lowest)

    # -- query --------------------------------------------------------

    def _bucket_value(self, key):
        # midpoint of (gamma^(k-1), gamma^k] in the geometric sense:
        # 2*gamma^k/(gamma+1) keeps relative error <= alpha for every
        # member of the bucket
        return 2.0 * math.pow(self._gamma, key) / (self._gamma + 1.0)

    def quantile(self, q):
        """The ``q``-quantile (q in [0, 1]) within relative error
        ``relative_accuracy``; None on an empty sketch."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        # nearest-rank (0-based, rounded): the convention of a
        # sorted-list percentile, sample for sample at small n too
        rank = int(round(q * (self.count - 1)))
        seen = 0
        # ascending value order: negatives (largest magnitude first),
        # zeros, positives
        for key in sorted(self._neg_buckets, reverse=True):
            seen += self._neg_buckets[key]
            if seen > rank:
                return -self._bucket_value(key)
        seen += self._zero_count
        if seen > rank:
            return 0.0
        for key in sorted(self._buckets):
            seen += self._buckets[key]
            if seen > rank:
                return self._bucket_value(key)
        # numerical edge: q == 1.0 with float rank round-off
        return self.max

    def quantiles(self, qs):
        """[quantile(q) for q in qs] in one pass-friendly call."""
        return [self.quantile(q) for q in qs]

    # -- merge / serialization ---------------------------------------

    def merge(self, other):
        """Fold ``other`` into this sketch **exactly** (bucket-wise
        addition): the result is indistinguishable from having
        observed both streams locally, so pooled replica quantiles
        keep the single-sketch error bound.  The accuracies must
        match (merging across gammas has no exact form).  Returns
        self."""
        if not isinstance(other, QuantileSketch):
            raise TypeError(
                f"cannot merge {type(other).__name__} into a "
                "QuantileSketch")
        if other.relative_accuracy != self.relative_accuracy:
            raise ValueError(
                "cannot merge sketches with different relative "
                f"accuracies ({self.relative_accuracy} vs "
                f"{other.relative_accuracy})")
        for key, n in other._buckets.items():
            self._buckets[key] = self._buckets.get(key, 0) + n
        for key, n in other._neg_buckets.items():
            self._neg_buckets[key] = \
                self._neg_buckets.get(key, 0) + n
        self._zero_count += other._zero_count
        self.count += other.count
        self.sum += other.sum
        for attr in ("min", "max"):
            theirs = getattr(other, attr)
            if theirs is None:
                continue
            mine = getattr(self, attr)
            pick = theirs if mine is None else (
                min(mine, theirs) if attr == "min"
                else max(mine, theirs))
            setattr(self, attr, pick)
        if len(self._buckets) > self.max_buckets:
            self._collapse(self._buckets)
        if len(self._neg_buckets) > self.max_buckets:
            self._collapse(self._neg_buckets)
        return self

    def to_dict(self):
        """JSON-serializable form (:meth:`from_dict` round-trips):
        the cross-process wire format replica summaries travel in."""
        return {
            "relative_accuracy": self.relative_accuracy,
            "max_buckets": self.max_buckets,
            "buckets": {str(k): v
                        for k, v in sorted(self._buckets.items())},
            "neg_buckets": {
                str(k): v
                for k, v in sorted(self._neg_buckets.items())},
            "zero_count": self._zero_count,
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
        }

    @classmethod
    def from_dict(cls, data):
        """Rebuild a sketch from :meth:`to_dict` output."""
        sketch = cls(
            relative_accuracy=data["relative_accuracy"],
            max_buckets=data.get("max_buckets",
                                 DEFAULT_MAX_BUCKETS))
        sketch._buckets = {int(k): int(v)
                           for k, v in data["buckets"].items()}
        sketch._neg_buckets = {
            int(k): int(v)
            for k, v in data.get("neg_buckets", {}).items()}
        sketch._zero_count = int(data.get("zero_count", 0))
        sketch.count = int(data["count"])
        sketch.sum = float(data["sum"])
        sketch.min = data.get("min")
        sketch.max = data.get("max")
        return sketch

    def __repr__(self):
        return (f"QuantileSketch(count={self.count}, "
                f"alpha={self.relative_accuracy}, "
                f"buckets={len(self._buckets)})")
