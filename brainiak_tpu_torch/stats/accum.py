"""Mergeable null-distribution accumulators (the port's copy).

A copy of ``brainiak_tpu/stats/accum.py``, which is NumPy only: the
wire format is plain NumPy, so a state either package saves, the
other loads and merges.

Replaces the materialized ``[n_resamples, V]`` null array with
fixed-size per-voxel state that (a) reproduces
:func:`~brainiak_tpu_torch.stats.pvalues.p_from_null` **bit-for-bit** from
integer exceedance counts, (b) carries streaming moments, (c) holds
per-voxel quantile state for CIs / cluster thresholds as a vectorized
log-bucket histogram following the exact-bucket-merge idiom of
:class:`brainiak_tpu_torch.obs.sketch.QuantileSketch`, and (d) tracks the
per-resample max statistic for max-statistic FWER control.

The pooling contract: every piece of state merges by integer addition
(counts, histograms) or disjoint-slice fill (max statistic), so two
half-runs over disjoint resample-index ranges ``merge()`` to EXACTLY
the verdict — p-values, CI bounds, thresholds — of one full run.  The
wire format (:meth:`NullAccumulator.to_state` / ``save`` / ``to_json``)
is a flat dict of plain NumPy arrays, so it round-trips through
``np.savez(allow_pickle=False)``, JSON, and the resilient-loop
checkpointer unchanged.

Memory model: state is ``O((2 K + c) · V)`` integers with
``K = O(log(max_magnitude / min_magnitude) / quantile_accuracy)``
histogram buckets per sign — independent of ``n_resamples``.
"""

import json
import math

import numpy as np

__all__ = ["NullAccumulator", "fdr_threshold"]

#: wire-format version stamped into serialized state.
WIRE_VERSION = 1

#: quantile relative-accuracy default (DDSketch alpha); CI bounds from
#: the accumulator are exact-in-rank, alpha-relative in value.
DEFAULT_QUANTILE_ACCURACY = 0.01

#: magnitudes below this collapse into the single "zero" bucket; above
#: the max they clip into the top bucket.  Defaults cover correlation-
#: scale statistics (|r| <= 1, differences <= 2) with wide margin.
DEFAULT_MIN_MAGNITUDE = 1e-5
DEFAULT_MAX_MAGNITUDE = 8.0

_CONFIG_KEYS = ("quantile_accuracy", "min_magnitude", "max_magnitude")


def fdr_threshold(p_values, alpha=0.05):
    """Benjamini-Hochberg step-up p-value cutoff.

    Returns the largest p among the finite input p-values that
    survives the step-up criterion (``p_(k) <= k/m * alpha``), or
    ``0.0`` when nothing survives.  Voxels with ``p <=`` the returned
    cutoff are the FDR-controlled discoveries.
    """
    p = np.asarray(p_values, dtype=float).ravel()
    p = p[np.isfinite(p)]
    if p.size == 0:
        return 0.0
    p = np.sort(p)
    m = p.size
    crit = (np.arange(1, m + 1) / m) * alpha
    passing = np.nonzero(p <= crit)[0]
    if passing.size == 0:
        return 0.0
    return float(p[passing[-1]])


class NullAccumulator:
    """Streaming, mergeable summary of a null distribution.

    Parameters
    ----------
    observed : array
        Observed statistic; chunks are compared against it (after the
        optional ``center`` shift) exactly as ``p_from_null`` would.
    n_total : int
        Total planned resamples across all pooled runs; sizes the
        per-resample max-statistic track and defines merge coverage.
    center : array, optional
        Subtracted from each chunk before exceedance counting (the
        Hall & Wilson bootstrap shift).  Quantile state always tracks
        the RAW chunk values (bootstrap CIs are percentiles of the
        unshifted distribution).
    """

    def __init__(self, observed, n_total, center=None,
                 quantile_accuracy=DEFAULT_QUANTILE_ACCURACY,
                 min_magnitude=DEFAULT_MIN_MAGNITUDE,
                 max_magnitude=DEFAULT_MAX_MAGNITUDE, shape=None):
        observed = np.asarray(observed, dtype=np.float64)
        self.observed = observed
        self.center = (None if center is None
                       else np.asarray(center, dtype=np.float64))
        self.n_total = int(n_total)
        self.quantile_accuracy = float(quantile_accuracy)
        self.min_magnitude = float(min_magnitude)
        self.max_magnitude = float(max_magnitude)
        # per-resample statistic shape (chunk values are [n, *shape]).
        # When not given, derived from the observed statistic with
        # leading broadcast axes squeezed — pass it explicitly when the
        # observed carries a genuine leading axis of size 1.
        if shape is None:
            shape = tuple(observed.shape)
            while shape and shape[0] == 1:
                shape = shape[1:]
        self.shape = tuple(int(s) for s in shape)
        shape = self.shape

        self._gamma = ((1.0 + self.quantile_accuracy)
                       / (1.0 - self.quantile_accuracy))
        self._log_gamma = math.log(self._gamma)
        self.k_lo = int(math.ceil(
            math.log(self.min_magnitude) / self._log_gamma))
        self.k_hi = int(math.ceil(
            math.log(self.max_magnitude) / self._log_gamma))
        self.n_keys = self.k_hi - self.k_lo + 1

        self.n = 0
        self.ge = np.zeros(shape, dtype=np.int64)
        self.le = np.zeros(shape, dtype=np.int64)
        self.abs_ge = np.zeros(shape, dtype=np.int64)
        self.sum = np.zeros(shape, dtype=np.float64)
        self.sumsq = np.zeros(shape, dtype=np.float64)
        self.n_finite = np.zeros(shape, dtype=np.int64)
        self.pos = np.zeros((self.n_keys,) + shape, dtype=np.int64)
        self.neg = np.zeros((self.n_keys,) + shape, dtype=np.int64)
        self.small = np.zeros(shape, dtype=np.int64)
        self.max_stat = np.full(self.n_total, np.nan)
        self.covered = np.zeros(self.n_total, dtype=np.uint8)

    # -- update -----------------------------------------------------------

    def _bucket_hist(self, values, mask):
        """Per-voxel bucket counts of the selected ``values`` as one
        ``[n_keys, *shape]`` array via a fused bincount (bucket-major
        linear index), the vectorized form of the sketch's per-value
        bucket add."""
        flat_cols = int(np.prod(self.shape, dtype=np.int64)) or 1
        out = np.zeros((self.n_keys, flat_cols), dtype=np.int64)
        if np.any(mask):
            mags = np.abs(values[mask])
            keys = np.ceil(np.log(mags) / self._log_gamma)
            keys = np.clip(keys, self.k_lo, self.k_hi).astype(np.int64)
            cols = np.broadcast_to(
                np.arange(flat_cols).reshape((1,) + self.shape),
                values.shape)[mask].astype(np.int64)
            lin = (keys - self.k_lo) * flat_cols + cols
            out = np.bincount(
                lin, minlength=self.n_keys * flat_cols).reshape(
                    self.n_keys, flat_cols).astype(np.int64)
        return out.reshape((self.n_keys,) + self.shape)

    def update(self, values, index_range):
        """Fold one chunk of null statistics into the accumulator.

        values : ``[n, *shape]`` array of null statistics for resample
        indices ``index_range = (lo, hi)`` (``hi - lo == n``).  Indices
        must not already be covered (by this run or a merged one).
        """
        values = np.asarray(values, dtype=np.float64)
        lo, hi = int(index_range[0]), int(index_range[1])
        if hi - lo != values.shape[0]:
            raise ValueError(
                "index_range {} spans {} resamples but chunk has {}"
                .format((lo, hi), hi - lo, values.shape[0]))
        if lo < 0 or hi > self.n_total:
            raise ValueError("index_range {} outside [0, {})".format(
                (lo, hi), self.n_total))
        if np.any(self.covered[lo:hi]):
            raise ValueError(
                "resample indices [{}, {}) already accumulated".format(
                    lo, hi))

        shifted = values if self.center is None else values - self.center
        self.ge += np.sum(shifted >= self.observed, axis=0)
        self.le += np.sum(shifted <= self.observed, axis=0)
        self.abs_ge += np.sum(
            np.abs(shifted) >= np.abs(self.observed), axis=0)
        self.n += values.shape[0]

        finite = np.isfinite(values)
        self.n_finite += np.sum(finite, axis=0)
        zeroed = np.where(finite, values, 0.0)
        self.sum += np.sum(zeroed, axis=0)
        self.sumsq += np.sum(zeroed * zeroed, axis=0)

        bucketed = finite & (np.abs(values) >= self.min_magnitude)
        self.small += np.sum(finite & ~bucketed, axis=0)
        self.pos += self._bucket_hist(values, bucketed & (values > 0))
        self.neg += self._bucket_hist(values, bucketed & (values < 0))

        per_resample = shifted.reshape(values.shape[0], -1)
        row_finite = np.isfinite(per_resample)
        row_max = np.max(
            np.where(row_finite, per_resample, -np.inf), axis=1)
        self.max_stat[lo:hi] = np.where(
            np.any(row_finite, axis=1), row_max, np.nan)
        self.covered[lo:hi] = 1

    # -- merge / verdicts -------------------------------------------------

    def _config_tuple(self):
        return (self.n_total, self.shape,
                self.quantile_accuracy, self.min_magnitude,
                self.max_magnitude)

    def merge(self, other):
        """Fold a disjoint-range accumulator into this one, in place.

        Exactness: counts and histograms add as integers; the
        max-statistic track fills disjoint slices — so merged state is
        identical to single-run state over the union of ranges.
        """
        if self._config_tuple() != other._config_tuple():
            raise ValueError("cannot merge accumulators with different "
                             "configurations")
        if not np.array_equal(self.observed, other.observed,
                              equal_nan=True):
            raise ValueError("cannot merge accumulators with different "
                             "observed statistics")
        same_center = ((self.center is None) == (other.center is None)
                       and (self.center is None
                            or np.array_equal(self.center, other.center,
                                              equal_nan=True)))
        if not same_center:
            raise ValueError("cannot merge accumulators with different "
                             "center shifts")
        overlap = (self.covered.astype(bool)
                   & other.covered.astype(bool))
        if np.any(overlap):
            raise ValueError(
                "resample ranges overlap at {} indices; pooled runs "
                "must cover disjoint index ranges".format(
                    int(np.sum(overlap))))
        self.n += other.n
        self.ge += other.ge
        self.le += other.le
        self.abs_ge += other.abs_ge
        self.sum += other.sum
        self.sumsq += other.sumsq
        self.n_finite += other.n_finite
        self.pos += other.pos
        self.neg += other.neg
        self.small += other.small
        mask = other.covered.astype(bool)
        self.max_stat[mask] = other.max_stat[mask]
        self.covered |= other.covered
        return self

    @property
    def complete(self):
        return bool(np.all(self.covered))

    def p_values(self, side='right', exact=False):
        """p-map from the integer exceedance counts — bit-for-bit the
        value :func:`~brainiak_tpu_torch.stats.pvalues.p_from_null` returns
        on the materialized distribution."""
        from .pvalues import p_from_counts
        if side == 'two-sided':
            numerator = self.abs_ge
        elif side == 'left':
            numerator = self.le
        elif side == 'right':
            numerator = self.ge
        else:
            raise ValueError("The value for 'side' must be either "
                             "'two-sided', 'left', or 'right', got {0}"
                             .format(side))
        return p_from_counts(numerator, self.n, exact=exact)

    def mean(self):
        with np.errstate(invalid='ignore', divide='ignore'):
            return np.where(self.n_finite > 0,
                            self.sum / np.maximum(self.n_finite, 1),
                            np.nan)

    def variance(self):
        with np.errstate(invalid='ignore', divide='ignore'):
            m = self.sum / np.maximum(self.n_finite, 1)
            v = self.sumsq / np.maximum(self.n_finite, 1) - m * m
            return np.where(self.n_finite > 1, np.maximum(v, 0.0),
                            np.nan)

    def _ordered_counts(self):
        """Histogram rows in ascending-value order with their
        representative values: most-negative bucket first, the
        near-zero bucket in the middle, largest positive last."""
        rep = (2.0 * np.exp(np.arange(self.k_lo, self.k_hi + 1)
                            * self._log_gamma) / (self._gamma + 1.0))
        counts = np.concatenate(
            [self.neg[::-1], self.small[None, ...], self.pos], axis=0)
        values = np.concatenate([-rep[::-1], [0.0], rep])
        return counts, values

    def quantile(self, q):
        """Per-voxel nearest-rank quantile from the bucket histogram
        (value accurate to the configured relative accuracy; rank
        exact, hence exactly merge-stable)."""
        counts, values = self._ordered_counts()
        cum = np.cumsum(counts, axis=0)
        total = self.n_finite
        rank = np.rint(q * np.maximum(total - 1, 0)).astype(np.int64)
        idx = np.sum(cum <= rank, axis=0)
        idx = np.minimum(idx, len(values) - 1)
        out = values[idx]
        return np.where(total > 0, out, np.nan)

    def ci(self, ci_percentile=95):
        """(lower, upper) per-voxel CI bounds at ``ci_percentile``."""
        lo_q = (100.0 - ci_percentile) / 200.0
        hi_q = (ci_percentile + (100.0 - ci_percentile) / 2.0) / 100.0
        return self.quantile(lo_q), self.quantile(hi_q)

    def fwer_threshold(self, alpha=0.05):
        """Max-statistic FWER threshold: the (1 - alpha) nearest-rank
        quantile of the per-resample max-statistic null."""
        vals = self.max_stat[self.covered.astype(bool)]
        vals = vals[np.isfinite(vals)]
        if vals.size == 0:
            return float('nan')
        vals = np.sort(vals)
        idx = min(vals.size - 1,
                  int(math.floor((1.0 - alpha) * vals.size)))
        return float(vals[idx])

    def fdr_threshold(self, alpha=0.05, side='right', exact=False):
        """Benjamini-Hochberg cutoff over this accumulator's p-map."""
        return fdr_threshold(self.p_values(side=side, exact=exact),
                             alpha=alpha)

    # -- wire format ------------------------------------------------------

    def to_state(self):
        """Flat dict of NumPy arrays — the canonical wire format,
        shared by ``np.savez``, JSON, and resilient-loop checkpoints."""
        state = {
            "wire_version": np.asarray(WIRE_VERSION, dtype=np.int64),
            "n_total": np.asarray(self.n_total, dtype=np.int64),
            "n": np.asarray(self.n, dtype=np.int64),
            "config": np.asarray([self.quantile_accuracy,
                                  self.min_magnitude,
                                  self.max_magnitude]),
            "observed": self.observed,
            "has_center": np.asarray(
                0 if self.center is None else 1, dtype=np.int64),
            "center": (np.zeros(1)
                       if self.center is None else self.center),
            "ge": self.ge, "le": self.le, "abs_ge": self.abs_ge,
            "sum": self.sum, "sumsq": self.sumsq,
            "n_finite": self.n_finite,
            "pos": self.pos, "neg": self.neg, "small": self.small,
            "max_stat": self.max_stat, "covered": self.covered,
        }
        return state

    @classmethod
    def from_state(cls, state):
        version = int(np.asarray(state["wire_version"]))
        if version > WIRE_VERSION:
            raise ValueError(
                "accumulator wire version {} is newer than supported "
                "version {}".format(version, WIRE_VERSION))
        cfg = np.asarray(state["config"], dtype=float).ravel()
        center = (np.asarray(state["center"])
                  if int(np.asarray(state["has_center"])) else None)
        acc = cls(np.asarray(state["observed"]),
                  int(np.asarray(state["n_total"])), center=center,
                  quantile_accuracy=float(cfg[0]),
                  min_magnitude=float(cfg[1]),
                  max_magnitude=float(cfg[2]),
                  shape=np.asarray(state["ge"]).shape)
        acc.n = int(np.asarray(state["n"]))
        for name in ("ge", "le", "abs_ge", "n_finite", "pos", "neg",
                     "small", "covered"):
            setattr(acc, name, np.array(
                state[name], dtype=getattr(acc, name).dtype))
        for name in ("sum", "sumsq", "max_stat"):
            setattr(acc, name, np.array(state[name],
                                        dtype=np.float64))
        return acc

    def save(self, path):
        """Persist to ``.npz`` (readable with ``allow_pickle=False``)."""
        np.savez(path, **self.to_state())

    @classmethod
    def load(cls, path):
        with np.load(path, allow_pickle=False) as z:
            return cls.from_state({k: z[k] for k in z.files})

    def to_json(self):
        """JSON wire form (exact: integer state verbatim, float state
        via hex floats) for transports where npz is awkward."""
        payload = {}
        for key, arr in self.to_state().items():
            arr = np.asarray(arr)
            if arr.dtype.kind in "iu":
                data = arr.ravel().tolist()
            else:
                data = [float.hex(float(v)) for v in arr.ravel()]
            payload[key] = {"dtype": arr.dtype.name,
                            "shape": list(arr.shape), "data": data}
        return json.dumps(payload)

    @classmethod
    def from_json(cls, text):
        payload = json.loads(text)
        state = {}
        for key, rec in payload.items():
            dtype = np.dtype(rec["dtype"])
            if dtype.kind in "iu":
                arr = np.asarray(rec["data"], dtype=dtype)
            else:
                arr = np.asarray([float.fromhex(v)
                                  for v in rec["data"]], dtype=dtype)
            state[key] = arr.reshape(rec["shape"])
        return cls.from_state(state)
