"""Time-series input checks, array correlation and concatenation
(NumPy, host).

Copies of ``brainiak_tpu/utils/utils.py``'s ``_check_timeseries_input``
and ``array_correlation``, which :mod:`brainiak_tpu_torch.isc` needs,
of its ``concatenate_not_none``, which SS-SRM needs, of its
``usable_cpu_count``, which the searchlight's host tier needs, and of
its ``from_tri_2_sym`` / ``from_sym_2_tri``, which TFA and HTFA need
for their packed covariance fields; the port imports nothing of the
JAX package.
"""

import logging
import os

import numpy as np

__all__ = ["array_correlation", "circ_dist", "concatenate_not_none",
           "cov2corr", "from_sym_2_tri", "from_tri_2_sym",
           "usable_cpu_count"]

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


def concatenate_not_none(data, axis=0):
    """Concatenate the non-None entries of a list of arrays."""
    return np.concatenate([d for d in data if d is not None], axis=axis)


def usable_cpu_count():
    """Number of CPUs usable by the current process (cpuset-aware)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def from_tri_2_sym(tri, dim):
    """Expand an upper-triangular 1-D vector into a dim×dim symmetric matrix.

    Only the upper triangle of the result is populated (matching the
    reference, utils/utils.py:69-92, which leaves the strict lower triangle
    zero).
    """
    symm = np.zeros((dim, dim), dtype=np.asarray(tri).dtype)
    symm[np.triu_indices(dim)] = tri
    return symm


def from_sym_2_tri(symm):
    """Extract the upper triangle (incl. diagonal) of a symmetric matrix
    as 1-D.

    Reference contract: utils/utils.py:95-115.
    """
    symm = np.asarray(symm)
    return symm[np.triu_indices_from(symm)]


def circ_dist(x, y):
    """Pairwise circular distance (radians) between two equal-size vectors.

    Reference contract: utils/utils.py:48-66.
    """
    x = np.asarray(x)
    y = np.asarray(y)
    if x.size != y.size:
        raise ValueError("Input sizes must match to compute pairwise "
                         "comparisons.")
    return np.angle(np.exp(1j * (x - y)))


def cov2corr(cov):
    """Convert a covariance matrix to a correlation matrix.

    Reference contract: utils/utils.py:185-206.
    """
    cov = np.asarray(cov)
    if cov.ndim != 2:
        raise ValueError("covariance matrix should be 2D array")
    inv_sd = 1.0 / np.sqrt(np.diag(cov))
    return cov * inv_sd[None, :] * inv_sd[:, None]
