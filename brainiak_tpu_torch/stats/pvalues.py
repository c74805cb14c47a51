"""Host-side p-value and summary-statistic conventions (the port's
copy of ``brainiak_tpu/stats/pvalues.py``, which is NumPy only).

The resampling-inference scalar conventions that ``isc``, :mod:`.accum`
and :mod:`.engine` agree on bit for bit:

- :func:`p_from_null` -- the exact-test numerator uses the *raw*
  exceedance count (``numerator / n_samples``); the sampled test adds
  the observed statistic to both numerator and denominator
  (``(numerator + 1) / (n_samples + 1)``, Phipson & Smyth 2010).
- :func:`compute_summary_statistic` -- 'mean' is the Fisher-z
  (arctanh) average mapped back through tanh; 'median' is the plain
  NaN-aware median.
"""

import numpy as np

__all__ = [
    "compute_summary_statistic",
    "exceedance_counts",
    "p_from_counts",
    "p_from_null",
]


def compute_summary_statistic(iscs, summary_statistic='mean', axis=None):
    """'mean' (Fisher-z averaged) or 'median' of ISC values."""
    if summary_statistic not in ('mean', 'median'):
        raise ValueError("Summary statistic must be 'mean' or 'median'")
    if summary_statistic == 'mean':
        return np.tanh(np.nanmean(np.arctanh(iscs), axis=axis))
    return np.nanmedian(iscs, axis=axis)


def exceedance_counts(observed, distribution, axis=0):
    """Per-element exceedance counts of ``observed`` vs a null chunk.

    Returns ``(ge, le, abs_ge)`` — the three integer numerators
    :func:`p_from_null` can be rebuilt from for any ``side``.  Counts
    sum exactly over disjoint chunks of the null axis, which is the
    whole basis of the mergeable accumulator contract
    (:class:`brainiak_tpu_torch.stats.accum.NullAccumulator`).
    """
    distribution = np.asarray(distribution)
    ge = np.sum(distribution >= observed, axis=axis)
    le = np.sum(distribution <= observed, axis=axis)
    abs_ge = np.sum(np.abs(distribution) >= np.abs(observed), axis=axis)
    return ge, le, abs_ge


def p_from_counts(numerator, n_samples, exact=False):
    """The shared count -> p-value map.

    ``exact`` uses the raw count over the full enumeration
    (``numerator / n_samples``); otherwise the observed statistic
    joins the null (``(numerator + 1) / (n_samples + 1)``).  This is
    the single definition both :func:`p_from_null` and the
    accumulators route through, so chunked counts reproduce the
    monolithic p-map bit-for-bit.
    """
    numerator = np.asarray(numerator)
    if exact:
        return numerator / n_samples
    return (numerator + 1) / (n_samples + 1)


def p_from_null(observed, distribution, side='two-sided', exact=False,
                axis=None):
    """p-value of an observed statistic under a resampling null distribution.

    Adjusts for the observed statistic unless ``exact`` (Phipson & Smyth
    2010).
    """
    if side not in ('two-sided', 'left', 'right'):
        raise ValueError("The value for 'side' must be either "
                         "'two-sided', 'left', or 'right', got {0}".
                         format(side))
    distribution = np.asarray(distribution)
    n_samples = len(distribution)

    if side == 'two-sided':
        numerator = np.sum(np.abs(distribution) >= np.abs(observed),
                           axis=axis)
    elif side == 'left':
        numerator = np.sum(distribution <= observed, axis=axis)
    else:
        numerator = np.sum(distribution >= observed, axis=axis)

    return p_from_counts(numerator, n_samples, exact=exact)
