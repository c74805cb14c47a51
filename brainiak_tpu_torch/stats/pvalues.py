"""ISC summary statistics (NumPy, host).

Copy of ``brainiak_tpu/stats/pvalues.py``'s
``compute_summary_statistic``, which :mod:`brainiak_tpu_torch.isc`
needs: 'mean' is the Fisher-z (arctanh) average mapped back through
tanh, 'median' the NaN-aware median.
"""

import numpy as np

__all__ = ["compute_summary_statistic"]


def compute_summary_statistic(iscs, summary_statistic='mean', axis=None):
    """'mean' (Fisher-z averaged) or 'median' of ISC values."""
    if summary_statistic not in ('mean', 'median'):
        raise ValueError("Summary statistic must be 'mean' or 'median'")
    if summary_statistic == 'mean':
        return np.tanh(np.nanmean(np.arctanh(iscs), axis=axis))
    return np.nanmedian(iscs, axis=axis)
