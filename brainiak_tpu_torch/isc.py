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
:func:`_pearson_rows` NaN (0/0).  On a mesh across processes each rank
computes its own positions' pieces; :func:`isc` gathers them with
:func:`~brainiak_tpu_torch.parallel.mesh.fetch_replicated`, and the
ring's [V, V] matrices reach the host of every rank one row slab at a
time (:func:`_fetch_ring_matrix`), so no device holds the whole.

The resampling tests (:func:`bootstrap_isc`, :func:`permutation_isc`,
:func:`timeshift_isc`, :func:`phaseshift_isc`) route through the
:mod:`brainiak_tpu_torch.stats` engine
(:class:`~brainiak_tpu_torch.stats.engine.NullEngine`): each null
family is a batched tensor program over resample descriptors drawn up
front from one ``torch.Generator`` seeded with ``random_state``, so a
seed gives other (statistically equivalent) resamples than the JAX
package's ``jax.random`` keys.  Exact tests enumerate their resamples
and agree with it.  Pass ``return_distribution=False`` to count the
null into the engine's mergeable accumulator instead of materializing
``[n_resamples, V]``.
"""

import numpy as np
import torch
from scipy.spatial.distance import squareform

from .device import matmul_precision, resolve_device
from .obs import spans as obs_spans
from .ops import stats as ops_stats
from .ops.distla import summa_gram
from .parallel.mesh import (DEFAULT_VOXEL_AXIS, Sharded, comm_device,
                            fetch_replicated, shard_along)
from .stats.pvalues import compute_summary_statistic
from .utils.utils import _check_timeseries_input, array_correlation

__all__ = [
    "bootstrap_isc",
    "compute_summary_statistic",
    "isc",
    "isfc",
    "permutation_isc",
    "phaseshift_isc",
    "squareform_isfc",
    "timeshift_isc",
]

MAX_RANDOM_SEED = 2 ** 32 - 1


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


def _check_isc_input(iscs, pairwise=False):
    """Standardize ISC stat-test input; returns (iscs, n_subjects,
    n_voxels)."""
    if isinstance(iscs, list):
        iscs = np.array(iscs)[:, np.newaxis]
    elif isinstance(iscs, np.ndarray) and iscs.ndim == 1:
        iscs = iscs[:, np.newaxis]
    if pairwise:
        try:
            test_square = squareform(iscs[:, 0], force='tomatrix')
            n_subjects = test_square.shape[0]
        except ValueError:
            raise ValueError("For pairwise input, ISCs must be the "
                             "vectorized triangle of a square matrix.")
    else:
        n_subjects = iscs.shape[0]
    return iscs, n_subjects, iscs.shape[1]


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


def _shard_voxels(arr, mesh, axis, device, dtype=np.float32):
    """``arr`` as ``dtype`` (float32 by default) on ``device``
    (``mesh=None``), or split along ``axis`` over the mesh's
    ``'voxel'`` positions (a
    :class:`~brainiak_tpu_torch.parallel.mesh.Sharded`), NaN-padded up
    to a multiple of the position count; callers slice padded outputs
    with ``[..., :n]``."""
    if mesh is None:
        return torch.as_tensor(np.asarray(arr, dtype=dtype), device=device)
    n_shards = mesh.shape[DEFAULT_VOXEL_AXIS]
    pad = (-arr.shape[axis]) % n_shards
    if pad:
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        arr = np.pad(np.asarray(arr, dtype=float), widths,
                     constant_values=np.nan)
    return shard_along(np.asarray(arr, dtype=dtype), mesh,
                       DEFAULT_VOXEL_AXIS, axis)


def _voxelwise(core, data, mesh, device, out_dim):
    """``core`` on [T, V, S] data, whole on ``device`` or piece by piece
    on the mesh's voxel positions; a host array."""
    placed = _shard_voxels(data, mesh, 1, device)
    if mesh is None:
        return fetch_replicated(core(placed))
    return fetch_replicated(placed.map(core, dim=out_dim))


def _fetch_ring_matrix(m, mesh):
    """Host array of the ring's [V, V] matrix on every process.  One
    process holds all of it (a tensor), so that is one copy.  Across
    processes (a :class:`~brainiak_tpu_torch.parallel.mesh.Sharded` of
    row slabs) one position's slab is broadcast from its owner at a
    time, under an ``isc.ring_slab`` span, and the host assembles the
    slabs: no device ever holds [V, V], which is why the ring runs."""
    if not isinstance(m, Sharded):
        return fetch_replicated(m, mesh)
    dist = torch.distributed
    me = dist.get_rank()
    dev = comm_device()
    template = m.local()[0][1]
    chunk = template.shape[0]
    rows = np.empty((len(m.chunks) * chunk, template.shape[1]),
                    dtype=np.float32)
    for i, (piece, owner) in enumerate(zip(m.chunks, m.ranks)):
        with obs_spans.span("isc.ring_slab",
                            attrs={"shard": i, "rows": chunk}):
            buf = piece.to(dev).contiguous() if owner == me else \
                torch.empty(template.shape, dtype=template.dtype,
                            device=dev)
            dist.broadcast(buf, src=owner)
            rows[i * chunk:(i + 1) * chunk] = buf.cpu().numpy()
    if m.shape is not None:
        rows = rows[:m.shape[0], :m.shape[1]]
    return rows


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
    dev = mesh.local_devices()[0]
    target_means = _loo_means_core(_f32(targets, dev), bool(tolerate_nans))
    data_t = _f32(data, dev)
    per_subj = []
    for s in range(data.shape[2]):
        m = summa_gram(data_t[..., s], mesh, data_b=target_means[..., s],
                       axis_names=(DEFAULT_VOXEL_AXIS,))
        if isinstance(m, Sharded):
            # row slabs on their ranks: symmetrized on the host
            m = _fetch_ring_matrix(m, mesh)
            per_subj.append((m + m.T) / 2 if symmetric else m)
        else:
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


# ---------------------------------------------------------------------------
# resampling statistics

def _reinsert_nan_voxels(observed, distribution, mask, n_voxels):
    """Restore NaN columns for voxels excluded by _threshold_nans so
    output stays positionally aligned with the input voxel axis."""
    if np.all(mask):
        return observed, distribution
    idx = np.where(mask)[0]
    obs_full = np.full(observed.shape[:-1] + (n_voxels,), np.nan)
    obs_full[..., idx] = observed
    dist_full = np.full(distribution.shape[:-1] + (n_voxels,), np.nan)
    dist_full[..., idx] = distribution
    return obs_full, dist_full


def _resolve_seed(random_state):
    if isinstance(random_state, np.random.RandomState):
        return int(random_state.randint(0, MAX_RANDOM_SEED))
    if random_state is None:
        return int(np.random.randint(0, MAX_RANDOM_SEED))
    return int(random_state)


def _null_engine(mesh, null_batch_size, device):
    from .stats.engine import NullEngine
    return NullEngine(mesh=mesh, null_batch_size=null_batch_size,
                      device=device)


def _reinsert_nan_p(observed, p, mask, n_voxels, n_samples):
    """Accumulator-mode counterpart of _reinsert_nan_voxels: excluded
    voxels get the all-NaN-column p of ``1 / (n + 1)`` (every NaN
    comparison counts as a non-exceedance)."""
    if np.all(mask):
        return observed, p
    idx = np.where(mask)[0]
    obs_full = np.full(observed.shape[:-1] + (n_voxels,), np.nan)
    obs_full[..., idx] = observed
    p_full = np.full(np.shape(p)[:-1] + (n_voxels,),
                     1.0 / (n_samples + 1))
    p_full[..., idx] = p
    return obs_full, p_full


def bootstrap_isc(iscs, pairwise=False, summary_statistic='median',
                  n_bootstraps=1000, ci_percentile=95, side='right',
                  random_state=None, mesh=None, null_batch_size=None,
                  return_distribution=True, device="cuda"):
    """Subject-wise bootstrap test for ISCs.

    Resamples subjects with replacement, shifts the bootstrap
    distribution by the observed statistic (Hall & Wilson 1991), and
    returns (observed, ci, p, distribution).

    mesh : optional Mesh with a ``'voxel'`` axis -- splits the voxel
        dimension of the resampling program over its positions.
    null_batch_size : resamples a batched program evaluates at once;
        default :func:`brainiak_tpu_torch.stats.engine
        .default_null_batch`.
    return_distribution : when False the ``[n_bootstraps, V]`` null is
        never materialized -- p and CI come from the engine's mergeable
        accumulator (CI to sketch accuracy) and the returned
        distribution is None.
    device : ``"cuda"`` (default) or ``"cpu"``.
    """
    iscs, n_subjects, n_voxels = _check_isc_input(iscs, pairwise=pairwise)
    if summary_statistic not in ('mean', 'median'):
        raise ValueError("Summary statistic must be 'mean' or 'median'")

    observed = compute_summary_statistic(
        iscs, summary_statistic=summary_statistic, axis=0)

    engine = _null_engine(mesh, null_batch_size, device)
    result = engine.run(
        iscs, "subject_bootstrap", n_bootstraps,
        statistic=summary_statistic, side=side,
        seed=_resolve_seed(random_state), pairwise=pairwise,
        observed=observed, center=observed,
        return_distribution=return_distribution)

    if return_distribution:
        # p and the CI from the null on the engine's device: the same
        # counts and percentiles as NumPy's on the host copy
        null = result.null_tensor
        ci = tuple(ops_stats.percentiles(
            null, ((100 - ci_percentile) / 2,
                   ci_percentile + (100 - ci_percentile) / 2)))
        obs = torch.as_tensor(observed, dtype=null.dtype,
                              device=null.device)
        p = ops_stats.p_from_null(obs, null - obs, side=side,
                                  exact=False).cpu().numpy()
        return observed, ci, p, result.distribution
    # accumulator mode: exceedance counts of (null - observed), i.e.
    # exactly the Hall & Wilson shifted comparison, without the array
    p = result.p_values(side=side, exact=False)
    ci = result.ci(ci_percentile)
    return observed, ci, p, None


def _null_p(result, observed, side, exact):
    """p of ``observed`` against the materialized null, counted on the
    engine's device (the counts, so the values, of
    :func:`~brainiak_tpu_torch.stats.pvalues.p_from_null` on the host
    copy)."""
    null = result.null_tensor
    obs = torch.as_tensor(observed, dtype=null.dtype, device=null.device)
    return ops_stats.p_from_null(obs, null, side=side,
                                 exact=exact).cpu().numpy()


def _check_group_assignment(group_assignment, n_subjects):
    if isinstance(group_assignment, list):
        group_assignment = np.array(group_assignment)
    if group_assignment is not None and \
            len(group_assignment) != n_subjects:
        raise ValueError("Group assignments ({0}) do not match number of "
                         "subjects ({1})!".format(len(group_assignment),
                                                  n_subjects))
    return group_assignment


def permutation_isc(iscs, group_assignment=None, pairwise=False,
                    summary_statistic='median', n_permutations=1000,
                    side='right', random_state=None, mesh=None,
                    null_batch_size=None, return_distribution=True,
                    device="cuda"):
    """Group-label permutation test for ISCs.

    One group: sign-flipping (exact when 2**N <= n_permutations).  Two
    groups: group-assignment shuffling (exact when N! <=
    n_permutations).  Returns (observed, p, distribution).

    mesh / null_batch_size / return_distribution / device : see
    :func:`bootstrap_isc`.
    """
    iscs, n_subjects, n_voxels = _check_isc_input(iscs, pairwise=pairwise)
    if summary_statistic not in ('mean', 'median'):
        raise ValueError("Summary statistic must be 'mean' or 'median'")
    group_assignment = _check_group_assignment(group_assignment, n_subjects)

    labels = (np.unique(group_assignment)
              if group_assignment is not None else np.array([0]))
    n_groups = len(labels)
    if n_groups > 2:
        raise ValueError("This test is not valid for more than "
                         "2 groups! (got {0})".format(n_groups))

    family = "sign_flip" if n_groups == 1 else "group_shuffle"
    engine = _null_engine(mesh, null_batch_size, device)
    result = engine.run(
        iscs, family, n_permutations, statistic=summary_statistic,
        side=side, seed=_resolve_seed(random_state), pairwise=pairwise,
        group_assignment=group_assignment,
        return_distribution=return_distribution)

    observed = result.observed
    if return_distribution:
        return observed, _null_p(result, observed, side, result.exact), \
            result.distribution
    return observed, result.p_values(side=side), None


def timeshift_isc(data, pairwise=False, summary_statistic='median',
                  n_shifts=1000, side='right', tolerate_nans=True,
                  random_state=None, mesh=None, null_batch_size=None,
                  return_distribution=True, device="cuda"):
    """Circular time-shift null for ISC.

    Returns (observed, p, distribution).
    mesh / null_batch_size / return_distribution / device : see
    :func:`bootstrap_isc`."""
    data, n_TRs, n_voxels, n_subjects = _check_timeseries_input(data)
    data, mask = _threshold_nans(data, tolerate_nans)

    observed = isc(data, pairwise=pairwise,
                   summary_statistic=summary_statistic,
                   tolerate_nans=tolerate_nans, mesh=mesh, device=device)

    engine = _null_engine(mesh, null_batch_size, device)
    result = engine.run(
        data, "circular_timeshift", n_shifts,
        statistic=summary_statistic, side=side,
        seed=_resolve_seed(random_state), pairwise=pairwise,
        tolerate_nans=tolerate_nans, observed=observed,
        return_distribution=return_distribution)

    if return_distribution:
        _, p = _reinsert_nan_p(observed, _null_p(result, observed, side,
                                                 False),
                               mask, n_voxels, result.n)
        observed, distribution = _reinsert_nan_voxels(
            observed, result.distribution, mask, n_voxels)
        return observed, p, distribution
    observed, p = _reinsert_nan_p(
        observed, result.p_values(side=side), mask, n_voxels, result.n)
    return observed, p, None


def phaseshift_isc(data, pairwise=False, summary_statistic='median',
                   n_shifts=1000, voxelwise=False, side='right',
                   tolerate_nans=True, random_state=None, mesh=None,
                   null_batch_size=None, return_distribution=True,
                   device="cuda"):
    """Phase-randomization null for ISC.

    Returns (observed, p, distribution).
    mesh / null_batch_size / return_distribution / device : see
    :func:`bootstrap_isc`."""
    data, n_TRs, n_voxels, n_subjects = _check_timeseries_input(data)
    data, mask = _threshold_nans(data, tolerate_nans)

    observed = isc(data, pairwise=pairwise,
                   summary_statistic=summary_statistic,
                   tolerate_nans=tolerate_nans, mesh=mesh, device=device)

    engine = _null_engine(mesh, null_batch_size, device)
    result = engine.run(
        data, "phase_randomize", n_shifts, statistic=summary_statistic,
        side=side, seed=_resolve_seed(random_state), pairwise=pairwise,
        voxelwise=voxelwise, tolerate_nans=tolerate_nans,
        observed=observed, return_distribution=return_distribution)

    if return_distribution:
        _, p = _reinsert_nan_p(observed, _null_p(result, observed, side,
                                                 False),
                               mask, n_voxels, result.n)
        observed, distribution = _reinsert_nan_voxels(
            observed, result.distribution, mask, n_voxels)
        return observed, p, distribution
    observed, p = _reinsert_nan_p(
        observed, result.p_values(side=side), mask, n_voxels, result.n)
    return observed, p, None
