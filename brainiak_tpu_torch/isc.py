"""Intersubject correlation (ISC) and intersubject functional
correlation (ISFC) on a CUDA device.

PyTorch counterpart of the non-resampling half of
``brainiak_tpu/isc.py``: :func:`isc`, :func:`isfc` and
:func:`squareform_isfc`, with the same public surface and statistical
semantics.  The voxelwise correlations are batched PyTorch products on
``device`` (``"cuda"`` by default; without a card the call raises
unless ``device="cpu"``), in float32 with TF32 off; NaN thresholding,
the float64 assembly of the results and the summary statistics run on
the host in NumPy, as in the reference.

With ``mesh=`` (:class:`~brainiak_tpu_torch.parallel.mesh.Mesh` with a
``'voxel'`` axis), :func:`isc` splits the voxels over the mesh's voxel
positions (NaN-padded: every ISC is voxelwise, so pad voxels come back
NaN and are sliced off) and :func:`isfc` computes each subject's
leave-one-out [V, V] matrix by the SUMMA ring
(:func:`brainiak_tpu_torch.ops.distla.summa_gram`, kernel K5 on CUDA).
The two ISFC paths keep the reference's treatment of constant voxels:
the ring's z-score gives them correlation 0, the dense
:func:`_pearson_rows` NaN (0/0).

The resampling tests (``bootstrap_isc``, ``permutation_isc``,
``timeshift_isc``, ``phaseshift_isc``) come with the port of
``stats/`` and its ``NullEngine``.
"""

import numpy as np
import torch
from scipy.spatial.distance import squareform

from .device import matmul_precision, resolve_device
from .ops.distla import summa_gram
from .parallel.mesh import (DEFAULT_VOXEL_AXIS, Sharded, fetch_replicated,
                            shard_along)
from .stats.pvalues import compute_summary_statistic
from .utils.utils import _check_timeseries_input, array_correlation

__all__ = ["compute_summary_statistic", "isc", "isfc", "squareform_isfc"]


# ---------------------------------------------------------------------------
# helpers (host)

def _threshold_nans(data, tolerate_nans):
    """Exclude voxels exceeding the NaN threshold; returns (data,
    keep_mask)."""
    nans = np.all(np.any(np.isnan(data), axis=0), axis=1)
    if tolerate_nans is True:
        pass
    elif isinstance(tolerate_nans, float):
        if not 0.0 <= tolerate_nans <= 1.0:
            raise ValueError("If threshold to tolerate NaNs is a float, "
                             "it must be between 0.0 and 1.0; got {0}".format(
                                 tolerate_nans))
        nans += ~(np.sum(~np.any(np.isnan(data), axis=0), axis=1) >=
                  data.shape[-1] * tolerate_nans)
    mask = ~nans
    return data[:, mask, :], mask


def squareform_isfc(isfcs, iscs=None):
    """Square <-> condensed ISFC conversion retaining the diagonal
    ISCs."""
    if not isinstance(iscs, np.ndarray) and isfcs.shape[-2] == \
            isfcs.shape[-1]:
        if isfcs.ndim == 2:
            isfcs = isfcs[np.newaxis, ...]
        if isfcs.ndim == 3:
            iscs = np.diagonal(isfcs, axis1=1, axis2=2)
            isfcs = np.vstack([squareform(m, checks=False)[np.newaxis, :]
                               for m in isfcs])
        else:
            raise ValueError("Square (redundant) ISFCs must be square "
                             "with multiple subjects or pairs of subjects "
                             "indexed by the first dimension")
        if isfcs.shape[0] == iscs.shape[0] == 1:
            isfcs, iscs = isfcs[0], iscs[0]
        return isfcs, iscs
    else:
        if isfcs.ndim == iscs.ndim == 1:
            isfcs, iscs = isfcs[np.newaxis, :], iscs[np.newaxis, :]
        stack = []
        for isfc_v, isc_v in zip(isfcs, iscs):
            sq = squareform(isfc_v, checks=False)
            np.fill_diagonal(sq, isc_v)
            stack.append(sq[np.newaxis, ...])
        out = np.vstack(stack)
        return out[0] if out.shape[0] == 1 else out


def _f32(arr, device):
    return torch.as_tensor(np.asarray(arr), dtype=torch.float32,
                           device=device)


def _shard_voxels(arr, mesh, axis, device):
    """``arr`` as float32 on ``device`` (``mesh=None``), or split along
    ``axis`` over the mesh's ``'voxel'`` positions (a
    :class:`~brainiak_tpu_torch.parallel.mesh.Sharded`), NaN-padded up
    to a multiple of the position count; callers slice padded outputs
    with ``[..., :n]``."""
    if mesh is None:
        return _f32(arr, device)
    n_shards = mesh.shape[DEFAULT_VOXEL_AXIS]
    pad = (-arr.shape[axis]) % n_shards
    if pad:
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        arr = np.pad(np.asarray(arr, dtype=float), widths,
                     constant_values=np.nan)
    return shard_along(np.asarray(arr, dtype=np.float32), mesh,
                       DEFAULT_VOXEL_AXIS, axis)


def _voxelwise(core, data, mesh, device, out_dim):
    """``core`` on [T, V, S] data, whole on ``device`` or piece by piece
    on the mesh's voxel positions; a host array."""
    placed = _shard_voxels(data, mesh, 1, device)
    if mesh is None:
        return fetch_replicated(core(placed))
    return fetch_replicated(Sharded([core(c) for c in placed.chunks],
                                    placed.devices, out_dim, placed.axes))


def _fetch_ring_matrix(m, mesh):
    """Host array of the ring's [V, V] matrix.  One process holds all of
    it, so this is the reference's single-process branch (the
    multi-process slab broadcast is not ported)."""
    return fetch_replicated(m, mesh)


# ---------------------------------------------------------------------------
# device cores

def _loo_means_core(data, tolerate_nans=True):
    """Mean of all-but-subject-s along the last axis: [T, V, S] -> same."""
    if tolerate_nans:
        nan = torch.isnan(data)
        total = torch.nansum(data, dim=2, keepdim=True)
        count = (~nan).sum(dim=2, keepdim=True).to(data.dtype)
        centered = torch.where(nan, torch.zeros_like(data), data)
    else:
        total = data.sum(dim=2, keepdim=True)
        count = data.shape[2]
        centered = data
    return (total - centered) / (count - 1)


def _columnwise_corr(x, y):
    """Pearson r between matching columns of x and y over axis 0:
    [T, V, S] -> [S, V]."""
    xd = x - x.mean(dim=0)
    yd = y - y.mean(dim=0)
    num = (xd * yd).sum(dim=0)
    den = torch.sqrt((xd ** 2).sum(dim=0) * (yd ** 2).sum(dim=0))
    return (num / den).T


def _isc_loo_core(data, tolerate_nans=True):
    """Leave-one-out ISC, corr(subject, mean of the others) per voxel:
    [T, V, S] -> [S, V]."""
    return _columnwise_corr(data, _loo_means_core(data, tolerate_nans))


def _isc_pairwise_core(data):
    """Per-voxel subject-by-subject correlation: [T, V, S] -> [S, S, V]."""
    xd = data - data.mean(dim=0)
    z = xd / torch.sqrt((xd ** 2).sum(dim=0))
    with matmul_precision(None):
        return torch.einsum('tvs,tvr->srv', z, z)


def _pearson_rows(x, y):
    """Correlate rows of x [A, T] with rows of y [B, T] -> [A, B]."""
    xd = x - x.mean(dim=1, keepdim=True)
    yd = y - y.mean(dim=1, keepdim=True)
    xn = xd / torch.sqrt((xd ** 2).sum(dim=1, keepdim=True))
    yn = yd / torch.sqrt((yd ** 2).sum(dim=1, keepdim=True))
    with matmul_precision(None):
        return xn @ yn.T


def _symmetrize(m):
    return (m + m.T) / 2


def _isfc_loo_core(data, target_means, symmetric=True):
    """Leave-one-out ISFC matrices of every subject:
    [T, V, S] / [T, W, S] -> [V, W, S]."""
    per_subject = []
    for s in range(data.shape[2]):
        m = _pearson_rows(data[..., s].T, target_means[..., s].T)
        per_subject.append(_symmetrize(m) if symmetric else m)
    return torch.stack(per_subject, dim=2)


def _isfc_pairwise_core(data, idx_i, idx_j):
    """Pairwise symmetrized ISFC matrices: [T, V, S] -> [V, V, P]."""
    return torch.stack([
        _symmetrize(_pearson_rows(data[..., i].T, data[..., j].T))
        for i, j in zip(idx_i, idx_j)], dim=2)


def _isfc_ring(data, targets, mesh, tolerate_nans, symmetric):
    """The leave-one-out ISFC matrices by the SUMMA ring, one ring per
    subject (its series against the mean of the others' targets), each
    fetched to the host: a float32 [V, V, S] host array."""
    dev = mesh.devices.flat[0]
    target_means = _loo_means_core(_f32(targets, dev), bool(tolerate_nans))
    data_t = _f32(data, dev)
    per_subj = []
    for s in range(data.shape[2]):
        m = summa_gram(data_t[..., s], mesh, data_b=target_means[..., s],
                       axis_names=(DEFAULT_VOXEL_AXIS,))
        per_subj.append(_fetch_ring_matrix(
            _symmetrize(m) if symmetric else m, mesh))
    return np.stack(per_subj, axis=2)


# ---------------------------------------------------------------------------
# public API

def isc(data, pairwise=False, summary_statistic=None, tolerate_nans=True,
        mesh=None, device="cuda"):
    """Intersubject correlation per voxel.

    Leave-one-out (default) or pairwise; optional 'mean' / 'median'
    summary.  ``mesh`` with a ``'voxel'`` axis splits the voxels over
    its positions (each correlation is voxelwise, so the pieces are
    independent); it is not used by the 2-subject host path.
    """
    dev = resolve_device(device)
    data, n_TRs, n_voxels, n_subjects = _check_timeseries_input(data)
    if n_subjects == 2:
        summary_statistic = None
    data, mask = _threshold_nans(data, tolerate_nans)
    n_kept = data.shape[1]

    if n_subjects == 2:
        iscs_stack = array_correlation(data[..., 0],
                                       data[..., 1])[np.newaxis, :]
    elif pairwise:
        corr = _voxelwise(_isc_pairwise_core, data, mesh, dev,
                          2)[..., :n_kept]
        iu = np.triu_indices(n_subjects, k=1)
        iscs_stack = corr[iu[0], iu[1], :]
    else:
        tol = bool(tolerate_nans)
        iscs_stack = _voxelwise(lambda d: _isc_loo_core(d, tol), data,
                                mesh, dev, 1)[:, :n_kept]

    iscs = np.full((iscs_stack.shape[0], n_voxels), np.nan)
    iscs[:, np.where(mask)[0]] = iscs_stack

    if summary_statistic:
        iscs = compute_summary_statistic(
            iscs, summary_statistic=summary_statistic, axis=0)[np.newaxis, :]
    if iscs.shape[0] == 1:
        iscs = iscs[0]
    return iscs


def _check_targets_input(targets, data):
    """Standardize optional ISFC targets."""
    if isinstance(targets, (np.ndarray, list)):
        targets, n_TRs, n_voxels, n_subjects = (
            _check_timeseries_input(targets))
        if data.shape[0] != n_TRs:
            raise ValueError("Targets array must have same number of "
                             "TRs as input data")
        if data.shape[2] != n_subjects:
            raise ValueError("Targets array must have same number of "
                             "subjects as input data")
        symmetric = False
    else:
        targets = data
        n_TRs, n_voxels, n_subjects = data.shape
        symmetric = True
    return targets, n_TRs, n_voxels, n_subjects, symmetric


def isfc(data, targets=None, pairwise=False, summary_statistic=None,
         vectorize_isfcs=True, tolerate_nans=True, mesh=None,
         device="cuda"):
    """Intersubject functional correlation.

    Correlates each subject's voxel time series with (a) the average of
    the other subjects' series (leave-one-out), or (b) each other
    subject's series (pairwise); optionally against a separate
    ``targets`` array.

    mesh : optional mesh with a ``'voxel'`` axis: the leave-one-out
        [V, V] matrices are then computed by the SUMMA ring on its
        devices, with O(V/n) of the data and O(V^2/n) of each result per
        position.  Requires > 2 subjects, leave-one-out mode, targets
        with the same voxel count as data, and the post-NaN-threshold
        voxel count divisible by the mesh's voxel axis.
    """
    dev = resolve_device(device)
    data, n_TRs, n_voxels, n_subjects = _check_timeseries_input(data)
    targets, t_n_TRs, t_n_voxels, _, symmetric = (
        _check_targets_input(targets, data))
    if not symmetric:
        pairwise = False
    data, mask = _threshold_nans(data, tolerate_nans)
    targets, targets_mask = _threshold_nans(targets, tolerate_nans)

    if symmetric and n_subjects == 2:
        if mesh is not None:
            raise ValueError("mesh-sharded ISFC requires more than 2 "
                             "subjects (the 2-subject case has no "
                             "leave-one-out mean)")
        m = fetch_replicated(_pearson_rows(_f32(data[..., 0].T, dev),
                                           _f32(data[..., 1].T, dev)))
        isfcs = ((m + m.T) / 2)[..., np.newaxis]
        summary_statistic = None
    elif pairwise:
        if mesh is not None:
            raise ValueError("mesh-sharded ISFC only supports "
                             "leave-one-out (pairwise=False)")
        iu = np.triu_indices(n_subjects, k=1)
        isfcs = fetch_replicated(_isfc_pairwise_core(_f32(data, dev),
                                                     iu[0], iu[1]))
    elif mesh is not None:
        if data.shape[1] != targets.shape[1]:
            raise ValueError("mesh-sharded ISFC requires targets with the "
                             "same voxel count as data")
        n_shards = mesh.shape[DEFAULT_VOXEL_AXIS]
        if data.shape[1] % n_shards != 0:
            raise ValueError(
                f"mesh-sharded ISFC requires the voxel count after NaN "
                f"thresholding ({data.shape[1]} of {n_voxels} input "
                f"voxels) to be divisible by the mesh 'voxel' axis "
                f"size ({n_shards})")
        isfcs = _isfc_ring(data, targets, mesh, tolerate_nans, symmetric)
    else:
        target_means = _loo_means_core(_f32(targets, dev),
                                       bool(tolerate_nans))
        isfcs = fetch_replicated(_isfc_loo_core(
            _f32(data, dev), target_means, symmetric=symmetric))

    isfcs_all = np.full((n_voxels, t_n_voxels, isfcs.shape[2]), np.nan)
    isfcs_all[np.ix_(np.where(mask)[0], np.where(targets_mask)[0])] = isfcs
    isfcs = np.moveaxis(isfcs_all, 2, 0)

    if summary_statistic:
        isfcs = compute_summary_statistic(
            isfcs, summary_statistic=summary_statistic, axis=0)
    if isfcs.shape[0] == 1:
        isfcs = isfcs[0]
    if vectorize_isfcs and symmetric:
        return squareform_isfc(isfcs)
    return isfcs
