"""Time-series input checks and array correlation (NumPy, host).

Copies of ``brainiak_tpu/utils/utils.py``'s ``_check_timeseries_input``
and ``array_correlation``, which :mod:`brainiak_tpu_torch.isc` needs;
the port imports nothing of the JAX package.
"""

import logging

import numpy as np

__all__ = ["array_correlation"]

logger = logging.getLogger(__name__)


def _check_timeseries_input(data):
    """Standardize time-series input to (data3d, n_TRs, n_voxels,
    n_subjects).

    Accepts a list of per-subject (n_TRs, n_voxels) arrays, a 2-D array
    (n_TRs, n_subjects), or a 3-D array (n_TRs, n_voxels, n_subjects).
    """
    if isinstance(data, list):
        shape0 = data[0].shape
        arrays = []
        for d in data:
            d = np.asarray(d)
            if d.shape != shape0:
                raise ValueError("All ndarrays in input list "
                                 "must be the same shape!")
            arrays.append(d[:, np.newaxis] if d.ndim == 1 else d)
        data = np.dstack(arrays)
    else:
        data = np.asarray(data)
        if data.ndim == 2:
            data = data[:, np.newaxis, :]
        elif data.ndim != 3:
            raise ValueError("Input ndarray should have 2 "
                             "or 3 dimensions (got {0})!".format(data.ndim))

    n_TRs, n_voxels, n_subjects = data.shape
    logger.debug(
        "Assuming %d subjects with %d time points and %d voxel(s) or ROI(s)",
        n_subjects, n_TRs, n_voxels)
    return data, n_TRs, n_voxels, n_subjects


def array_correlation(x, y, axis=0):
    """Column- (axis=0) or row-wise (axis=1) Pearson correlation of two
    arrays."""
    x = np.asarray(x)
    y = np.asarray(y)
    if x.shape != y.shape:
        raise ValueError("Input arrays must be the same shape")
    if axis == 1:
        x, y = x.T, y.T
    xd = x - x.mean(axis=0)
    yd = y - y.mean(axis=0)
    num = np.sum(xd * yd, axis=0)
    den = np.sqrt(np.sum(xd ** 2, axis=0) * np.sum(yd ** 2, axis=0))
    return num / den
