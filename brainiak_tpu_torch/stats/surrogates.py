"""Surrogate-family registry: each null family as a batched tensor
program over resample descriptors.

PyTorch counterpart of ``brainiak_tpu/stats/surrogates.py``.  A
family is a plain function of its resample descriptors:

=================== ====================================== =========
family              descriptor (one row a resample)        input
=================== ====================================== =========
subject_bootstrap   subject indices drawn with replacement ISC stack
sign_flip           +-1 a subject                          ISC stack
group_shuffle       a permutation of the subjects          ISC stack
circular_timeshift  a circular time shift a subject        [T, V, S]
phase_randomize     phase angles [n_pos, 1, S]             [T, V, S]
=================== ====================================== =========

:data:`TRANSFORMS` applies a batch of descriptors to the data; the
``*_null`` functions compose a transform with the family's statistic,
and :func:`make_spec` evaluates a chunk of resamples as one batched
program of ``null_batch_size`` lanes at a time (the JAX package's
``lax.map`` over its keys).

Descriptors.  The JAX package splits one ``jax.random`` key over all
planned resamples.  Here every descriptor is drawn up front, for all
``n_total`` resamples, from one CPU ``torch.Generator`` seeded with
``seed``; the engine slices them by global resample index, so chunking,
resume and disjoint-range merges give the same resample at every index.
``phase_randomize(voxelwise=True)`` would need ``[n_pos, V, S]`` angles
a resample, too many to hold: its descriptor is one seed a resample,
and the angles are drawn on the data's device from a generator seeded
with it (a CUDA generator's stream is not the CPU's, so those nulls
depend on the device).  Exact tests enumerate ``itertools.product`` /
``permutations`` as the JAX package does, so their descriptors are its.

Shift families.  Leave-one-out, a shifted subject is correlated with
the UNSHIFTED others' mean, so a circular shift or a phase rotation
changes only the correlation's numerator, and that numerator is a
lookup in the subject's circular cross-correlation with the others
(every shift at once, one ``irfft``) or a linear form in the rotation's
phasors (Parseval: one batched product with ``X conj(Y)`` over the
rotated bins).  The null is the JAX program's statistic in exact
arithmetic, computed without forming a shifted ``[T, V, S]`` stack a
resample; it runs in float64 (the spectra of the float32 data), so it
lies nearer float64 than a float32 correlation would.  Pairwise, every
pair is shifted, so each lane's shifted data is formed and correlated
in float32, as :func:`brainiak_tpu_torch.isc.isc` does.

dtypes.  The ISC-input families run in the input's dtype (float64 from
NumPy, on the card too).  Every per-lane statistic is a reduction over
subjects, pairs or time, so a lane's value does not depend on the
lanes it is batched with.

Voxel sharding: with ``mesh=`` the family's input is split along its
voxel axis over the mesh's ``'voxel'`` positions (NaN-padded); every
program here is voxelwise, so each position evaluates its piece.
"""

import math
from itertools import permutations, product

import numpy as np
import torch

from ..device import resolve_device
from ..ops.stats import n_positive_bins, rotate_phases

__all__ = [
    "FAMILIES",
    "ISC_INPUT_FAMILIES",
    "TRANSFORMS",
    "NullSpec",
    "bootstrap_null",
    "circular_timeshift",
    "draw_descriptors",
    "group_shuffle",
    "group_shuffle_null",
    "make_spec",
    "phase_null",
    "phase_randomize",
    "sign_flip",
    "sign_flip_null",
    "subject_bootstrap",
    "timeshift_null",
]

#: the registered surrogate families, in registry order.
FAMILIES = ("sign_flip", "group_shuffle", "subject_bootstrap",
            "circular_timeshift", "phase_randomize")

#: families whose input is an ISC matrix (vs a [T, V, S] time series).
ISC_INPUT_FAMILIES = ("sign_flip", "group_shuffle", "subject_bootstrap")


# ---------------------------------------------------------------------------
# transforms: a batch of n descriptors applied to the data

def sign_flip(flips, iscs):
    """Per-subject sign flips ``[n, S]`` applied to an ``[S, V]`` ISC
    stack: ``[n, S, V]``."""
    return iscs * flips[:, :, None]


def group_shuffle(perms, selector):
    """Permutations ``[n, S]`` of a per-subject label vector:
    ``[n, S]``."""
    return selector[perms]


def subject_bootstrap(samples, iscs):
    """With-replacement subject indices ``[n, S]`` gathered from an
    ``[S, V]`` ISC stack: ``[n, S, V]``."""
    return iscs[samples]


def circular_timeshift(shifts, data):
    """Independent circular time shifts ``[n, S]`` of each subject of
    ``[T, V, S]`` data: ``[n, T, V, S]``, subject ``s`` of lane ``i``
    rolled by ``shifts[i, s]`` along time (as ``jnp.roll``)."""
    n_trs, n_vox, n_subj = data.shape
    n = shifts.shape[0]
    t = torch.arange(n_trs, device=data.device)
    idx = (t[None, :, None] - shifts[:, None, :]) % n_trs
    idx = idx[:, :, None, :].expand(n, n_trs, n_vox, n_subj)
    return torch.gather(data.expand(n, n_trs, n_vox, n_subj), 1, idx)


def phase_randomize(angles, data):
    """Phase angles ``[n, n_pos, 1 or V, S]`` applied to ``[T, V, S]``
    data: ``[n, T, V, S]`` with the power spectra kept
    (:func:`brainiak_tpu_torch.ops.stats.rotate_phases`)."""
    return rotate_phases(torch.fft.rfft(data, dim=0), angles,
                         data.shape[0])


TRANSFORMS = {
    "sign_flip": sign_flip,
    "group_shuffle": group_shuffle,
    "subject_bootstrap": subject_bootstrap,
    "circular_timeshift": circular_timeshift,
    "phase_randomize": phase_randomize,
}


# ---------------------------------------------------------------------------
# shared statistic helpers

def _nanmedian(x, dim):
    """NaN-excluding median in the input dtype: sort with NaN pushed to
    +inf and average the two middle ranks, the arithmetic of
    ``np.median``'s ``(a + b) / 2`` (``torch.nanmedian`` returns the
    lower middle value instead)."""
    x = x.movedim(dim, -1)
    valid = ~torch.isnan(x)
    count = valid.sum(dim=-1, keepdim=True)
    ordered = torch.sort(torch.where(valid, x, torch.inf), dim=-1).values
    hi_rank = count // 2
    lo_rank = torch.clamp(count - 1, min=0) // 2
    lo = ordered.gather(-1, lo_rank)[..., 0]
    hi = ordered.gather(-1, hi_rank)[..., 0]
    return torch.where(count[..., 0] > 0, (lo + hi) / 2.0, torch.nan)


def _summary(iscs, statistic, dim):
    """'mean' (Fisher-z) or 'median' over ``dim``, NaN excluded."""
    if statistic == 'mean':
        return torch.tanh(torch.nanmean(torch.arctanh(iscs), dim=dim))
    return _nanmedian(iscs, dim)


def _group_diff_stat(iscs, sel, labels, statistic):
    """summary(group 0) - summary(group 1) of an ``[S, V]`` stack for
    each lane's row labels ``sel`` (``[n, S]``; rows labelled NaN are
    in neither group): ``[n, V]``.  The one source of the two-group
    statistic for both the observed value and the nulls."""
    s0 = _summary(torch.where((sel == labels[0])[..., None], iscs,
                              torch.nan), statistic, dim=1)
    s1 = _summary(torch.where((sel == labels[1])[..., None], iscs,
                              torch.nan), statistic, dim=1)
    return s0 - s1


# ---------------------------------------------------------------------------
# family programs: [n] descriptors -> [n, V] null statistics

def bootstrap_null(iscs, samples, statistic, iu=None):
    """Subject-wise bootstrap statistics of ``samples`` (``[n, S]``).
    Leave-one-out: ``iscs`` is the ``[S, V]`` stack.  Pairwise (``iu``,
    the upper-triangle indices): ``iscs`` is the square ``[S, S, V]``
    form; each sample is sorted and a pair of one subject drawn twice
    is censored with NaN."""
    if iu is None:
        return _summary(subject_bootstrap(samples, iscs), statistic, dim=1)
    sample = torch.sort(samples, dim=1).values
    i0, i1 = sample[:, iu[0]], sample[:, iu[1]]
    resq = torch.where((i0 == i1)[..., None], torch.nan, iscs[i0, i1])
    return _summary(resq, statistic, dim=1)


def sign_flip_null(iscs, flips, statistic, iu=None):
    """One-group sign-flip statistics of ``flips`` (``[n, S]``); in
    pairwise mode a pair's sign is the product of its subjects'."""
    if iu is not None:
        flips = flips[:, iu[0]] * flips[:, iu[1]]
    return _summary(sign_flip(flips, iscs), statistic, dim=1)


def group_shuffle_null(iscs, selector, labels, perms, statistic,
                       sq_labels=None, iu=None):
    """Two-group label-shuffle statistics of ``perms`` (``[n, S]``).
    Pairwise: ``sq_labels`` is the [S, S] pair-label matrix (NaN
    across groups), permuted on both axes."""
    if sq_labels is not None:
        sel = sq_labels[perms[:, iu[0]], perms[:, iu[1]]]
    else:
        sel = group_shuffle(perms, selector)
    return _group_diff_stat(iscs, sel, labels, statistic)


def _pairwise_stat(shifted, statistic, iu):
    """The pairwise ISC statistic of each lane of shifted ``[n, T, V,
    S]`` data (``iu``: the upper-triangle pair indices)."""
    from ..isc import _isc_pairwise_core

    corr = torch.func.vmap(_isc_pairwise_core)(shifted)
    return _summary(corr[:, iu[0], iu[1], :], statistic, dim=1)


def loo_spectra(data, others):
    """The leave-one-out shift nulls' float64 inputs: the ``rfft``
    along time of each subject's deviations and of the unshifted
    others' mean's, and the correlation denominators ``[V, S]``, which
    a circular shift or a phase rotation leaves as they are."""
    x, y = data.to(torch.float64), others.to(torch.float64)
    xd, yd = x - x.mean(dim=0), y - y.mean(dim=0)
    den = torch.sqrt((xd ** 2).sum(dim=0) * (yd ** 2).sum(dim=0))
    return torch.fft.rfft(xd, dim=0), torch.fft.rfft(yd, dim=0), den


def shift_cross(xf, yf, n_trs):
    """Every circular shift's correlation numerator at once:
    ``cross[k, v, s] = sum_t x_s[t - k] y_s[t]`` (deviations), the
    circular cross-correlation ``irfft(conj(X) Y)``; ``[T, V, S]``."""
    return torch.fft.irfft(torch.conj(xf) * yf, n=n_trs, dim=0)


def timeshift_loo(cross, den, shifts, statistic):
    """Leave-one-out time-shift statistics of ``shifts`` (``[n, S]``):
    each subject's numerator looked up at its shift."""
    subj = torch.arange(shifts.shape[1], device=shifts.device)
    return _summary(cross[shifts, :, subj] / den.T, statistic, dim=1)


def phase_basis(xf, yf, n_trs):
    """A phase rotation's correlation numerator is linear in its
    phasors (Parseval): ``(Q_0 + 2 sum_f Re(rot_f Q_f) + Q_nyq) / T``,
    ``Q = X conj(Y)``.  Returns the real and imaginary parts of ``Q``
    over the rotated bins as ``[S, 2 n_pos, V]`` and the fixed terms
    ``[V, S]``."""
    n_pos = n_positive_bins(n_trs)
    q = xf * torch.conj(yf)
    body = q[1:n_pos + 1]
    basis = torch.cat([body.real, body.imag]).permute(2, 0, 1)
    rest = q[0].real + (q[n_pos + 1].real if n_trs % 2 == 0 else 0.0)
    return basis.contiguous(), rest


def phase_loo(basis, rest, den, n_trs, angles, statistic):
    """Leave-one-out phase-randomization statistics of ``angles``
    (``[n, n_pos, 1 or V, S]``): shared angles as one batched product
    with the basis, voxelwise ones elementwise."""
    a = angles.to(torch.float64)
    if a.shape[2] == 1:
        a = a[:, :, 0, :].permute(2, 0, 1)                   # [S, n, P]
        num = torch.bmm(torch.cat([torch.cos(a), -torch.sin(a)], dim=2),
                        basis)                                 # [S, n, V]
        num = num.permute(1, 0, 2)
    else:
        n_pos = a.shape[1]
        re, im = basis[:, :n_pos], basis[:, n_pos:]           # [S, P, V]
        num = (torch.cos(a) * re.permute(1, 2, 0)
               - torch.sin(a) * im.permute(1, 2, 0)).sum(dim=1)
        num = num.transpose(1, 2)                              # [n, S, V]
    r = (2 * num + rest.T) / n_trs / den.T
    return _summary(r, statistic, dim=1)


def timeshift_null(data, others, shifts, statistic, iu=None):
    """Circular time-shift statistics of ``shifts`` (``[n, S]``) over
    ``[T, V, S]`` data.  Leave-one-out: by the spectrum in float64
    (:func:`shift_cross`); pairwise (``iu``): each lane's shifted data
    correlated in the data's dtype."""
    if iu is not None:
        return _pairwise_stat(circular_timeshift(shifts, data), statistic,
                              iu)
    xf, yf, den = loo_spectra(data, others)
    return timeshift_loo(shift_cross(xf, yf, data.shape[0]), den, shifts,
                         statistic)


def phase_null(data, others, angles, statistic, iu=None):
    """Phase-randomization statistics of ``angles`` (``[n, n_pos, 1 or
    V, S]``) over ``[T, V, S]`` data.  Leave-one-out: by the spectrum
    in float64 (:func:`phase_basis`); pairwise (``iu``): each lane's
    randomized data correlated in the data's dtype."""
    n_trs = data.shape[0]
    if iu is not None:
        return _pairwise_stat(phase_randomize(angles, data), statistic,
                              iu)
    xf, yf, den = loo_spectra(data, others)
    basis, rest = phase_basis(xf, yf, n_trs)
    return phase_loo(basis, rest, den, n_trs, angles, statistic)


# ---------------------------------------------------------------------------
# descriptors

def draw_descriptors(family, seed, n, n_subjects, n_trs=None,
                     voxelwise=False, dtype=np.float64):
    """All ``n`` sampled descriptors of ``family`` from one CPU
    ``torch.Generator`` seeded with ``seed`` (a numpy array, row i the
    i-th resample): bootstrap indices and permutations ``[n, S]``
    int64, sign flips ``[n, S]`` of ``dtype``, shifts ``[n, S]``
    int64, phase angles ``[n, n_pos, 1, S]`` float32 in ``[0, 2 pi)``,
    or one int64 seed a resample for voxelwise phases."""
    g = torch.Generator().manual_seed(int(seed))
    shape = (int(n), int(n_subjects))
    if family == "subject_bootstrap":
        xs = torch.randint(n_subjects, shape, generator=g)
    elif family == "sign_flip":
        xs = (torch.randint(2, shape, generator=g) * 2 - 1).to(
            torch.float64)
        return xs.numpy().astype(dtype)
    elif family == "group_shuffle":
        xs = torch.argsort(torch.rand(shape, generator=g), dim=1)
    elif family == "circular_timeshift":
        xs = torch.randint(n_trs, shape, generator=g)
    elif voxelwise:
        xs = torch.randint(2 ** 62, (int(n),), generator=g)
    else:
        xs = torch.rand((int(n), n_positive_bins(n_trs), 1,
                         int(n_subjects)), generator=g) * (2 * math.pi)
    return xs.numpy()


def _voxelwise_angles(seeds, n_trs, n_voxels, offset, piece):
    """The voxelwise angles of each lane's seed for the voxels
    ``[offset, offset + V_piece)``: one generator a resample on the
    piece's device draws ``[n_pos, n_voxels, S]`` (the whole volume's,
    so a piece of a mesh gets its voxels' angles) and the piece takes
    its slice, zero angles for pad voxels past ``n_voxels``."""
    n_pos = n_positive_bins(n_trs)
    width = piece.shape[1]
    out = []
    for s in seeds.tolist():
        g = torch.Generator(device=piece.device).manual_seed(int(s))
        a = torch.rand((n_pos, n_voxels, piece.shape[2]), generator=g,
                       dtype=piece.dtype, device=piece.device)
        a = a[:, offset:offset + width] * (2 * math.pi)
        if a.shape[1] < width:
            a = torch.cat([a, a.new_zeros((n_pos, width - a.shape[1],
                                           a.shape[2]))], dim=1)
        out.append(a)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# family specs: everything the engine needs to drive one null run

class NullSpec:
    """One prepared resampling family: the full resample descriptor
    array ``xs`` (drawn descriptors, or the enumerated resamples of an
    exact test) plus a ``run(xs_chunk) -> [n, V] tensor`` closure over
    the device-placed inputs, on ``device``.  Slicing ``xs`` by global
    resample index is what makes chunking, resume, and disjoint-range
    pooling all yield the same per-index surrogate."""

    def __init__(self, family, xs, run, n_voxels, n_total, exact,
                 sampled, statistic, compute_observed, device):
        self.family = family
        self.xs = xs
        self.run = run
        self.n_voxels = n_voxels
        self.n_total = n_total
        self.exact = exact
        self.sampled = sampled
        self.statistic = statistic
        self.compute_observed = compute_observed
        self.device = device


def _pieces(placed, fn, dim):
    """``fn(piece, voxel_offset)`` on each piece of ``placed`` this
    process holds (a tensor: ``fn(placed, 0)``), the results a
    :class:`~brainiak_tpu_torch.parallel.mesh.Sharded` along ``dim``."""
    from ..parallel.mesh import Sharded

    if not isinstance(placed, Sharded):
        return fn(placed, 0)
    vdim = placed.dim
    width = next(c for c in placed.chunks if c is not None).shape[vdim]
    return Sharded([None if c is None else fn(c, k * width)
                    for k, c in enumerate(placed.chunks)],
                   placed.devices, dim, placed.axes, placed.ranks)


def _lanes(program, xs, batch):
    """``program(xs_group)`` over groups of ``batch`` rows of ``xs``,
    concatenated along the lanes."""
    return torch.cat([program(xs[i:i + batch])
                      for i in range(0, xs.shape[0], batch)])


def _collect(out, n_voxels, device):
    """A program's [n, V] result on ``device``: a tensor as it is, a
    mesh's pieces fetched and put there."""
    from ..parallel.mesh import fetch_replicated

    if isinstance(out, torch.Tensor):
        return out[:, :n_voxels]
    return torch.as_tensor(fetch_replicated(out)[:, :n_voxels],
                           device=device)


def make_spec(family, data, *, statistic='median', n_resamples=1000,
              seed=0, pairwise=False, group_assignment=None,
              voxelwise=False, tolerate_nans=True, mesh=None,
              null_batch_size=None, device="cuda"):
    """Build the :class:`NullSpec` for one family over prepared data.

    ``data`` is the family's input: an ISC stack (``[S, V]``
    leave-one-out, or the condensed pairwise form) for the
    ISC-resampling families, a ``[T, V, S]`` time-series stack for the
    shift families.  Placement (on ``device``, or voxel-split over
    ``mesh``) happens here, once, outside the chunk loop.
    """
    from .engine import default_null_batch

    if family not in FAMILIES:
        raise ValueError("Unknown surrogate family {!r}; registered "
                         "families: {}".format(family,
                                               ", ".join(FAMILIES)))
    if statistic not in ('mean', 'median'):
        raise ValueError("Summary statistic must be 'mean' or 'median'")

    from ..isc import (_check_isc_input, _loo_means_core, _shard_voxels,
                       isc)
    from .pvalues import compute_summary_statistic

    dev = mesh.local_devices()[0] if mesh is not None \
        else resolve_device(device)

    cache = {}

    def on(device, name, arr):
        """Host array ``arr`` on ``device``, copied there once."""
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(arr, device=device)
        return cache[key]

    def iu_on(piece):
        return None if iu is None else (
            on(piece.device, "iu0", iu[0]), on(piece.device, "iu1", iu[1]))

    if family in ISC_INPUT_FAMILIES:
        iscs, n_subjects, n_voxels = _check_isc_input(
            np.asarray(data) if not isinstance(data, list) else data,
            pairwise=pairwise)
        dtype = np.result_type(iscs.dtype, np.float32)
        iu = np.triu_indices(n_subjects, k=1) if pairwise else None
        batch = (null_batch_size if null_batch_size is not None
                 else default_null_batch(n_voxels))

        def run_on(placed, program):
            def run(xs_chunk):
                def piece_fn(piece, offset):
                    del offset
                    xs = torch.as_tensor(xs_chunk, device=piece.device)
                    return _lanes(lambda x: program(piece, x), xs, batch)

                return _collect(_pieces(placed, piece_fn, 1), n_voxels,
                                dev)
            return run

        if family == "subject_bootstrap":
            if pairwise:
                from scipy.spatial.distance import squareform
                sq = np.stack([squareform(v, force='tomatrix')
                               for v in iscs.T], axis=-1)  # [S, S, V]
                for v in range(sq.shape[-1]):
                    np.fill_diagonal(sq[..., v], 1.0)
                placed = _shard_voxels(sq, mesh, 2, dev, dtype)
            else:
                placed = _shard_voxels(iscs, mesh, 1, dev, dtype)
            run = run_on(placed, lambda piece, x: bootstrap_null(
                piece, x, statistic, iu_on(piece)))

            def compute_observed():
                return compute_summary_statistic(
                    iscs, summary_statistic=statistic, axis=0)

            xs = draw_descriptors(family, seed, n_resamples, n_subjects)
            return NullSpec(family, xs, run, n_voxels, int(n_resamples),
                            False, True, statistic, compute_observed, dev)

        if family == "sign_flip":
            exact = n_resamples >= 2 ** n_subjects
            if exact:
                n_total = 2 ** n_subjects
                xs = np.asarray(list(product([-1.0, 1.0],
                                             repeat=n_subjects)))
            else:
                n_total = int(n_resamples)
                xs = draw_descriptors(family, seed, n_total, n_subjects)
            xs = xs.astype(dtype)
            placed = _shard_voxels(iscs, mesh, 1, dev, dtype)
            run = run_on(placed, lambda piece, x: sign_flip_null(
                piece, x, statistic, iu_on(piece)))

            def compute_observed():
                return compute_summary_statistic(
                    iscs, summary_statistic=statistic,
                    axis=0)[np.newaxis, :]

            return NullSpec(family, xs, run, n_voxels, n_total, exact,
                            not exact, statistic, compute_observed, dev)

        # group_shuffle
        if group_assignment is None:
            raise ValueError("group_shuffle requires group_assignment")
        group_selector = np.asarray(group_assignment)
        labels = np.unique(group_selector)
        if len(labels) != 2:
            raise ValueError("group_shuffle requires exactly 2 groups "
                             "(got {0})".format(len(labels)))
        labels_f = labels.astype(float)
        exact = n_resamples >= math.factorial(n_subjects)
        if exact:
            n_total = math.factorial(n_subjects)
            xs = np.asarray(list(permutations(np.arange(n_subjects))))
        else:
            n_total = int(n_resamples)
            xs = draw_descriptors(family, seed, n_total, n_subjects)
        placed = _shard_voxels(iscs, mesh, 1, dev, dtype)
        sel_f = group_selector.astype(float)
        if pairwise:
            from scipy.spatial.distance import squareform
            sq_labels = np.full((n_subjects, n_subjects), np.nan)
            for g in labels:
                idx = np.where(group_selector == g)[0]
                sq_labels[np.ix_(idx, idx)] = g
            np.fill_diagonal(sq_labels, np.nan)
            observed_sel = squareform(sq_labels, checks=False)
        else:
            sq_labels = None
            observed_sel = sel_f

        def shuffle_program(piece, x):
            d = piece.device
            return group_shuffle_null(
                piece, on(d, "sel", sel_f), on(d, "labels", labels_f), x,
                statistic,
                None if sq_labels is None else on(d, "sq", sq_labels),
                iu_on(piece))

        run = run_on(placed, shuffle_program)

        def compute_observed():
            def piece_fn(piece, offset):
                del offset
                d = piece.device
                return _group_diff_stat(
                    piece, on(d, "observed_sel", observed_sel)[None],
                    on(d, "labels", labels_f), statistic)

            out = _collect(_pieces(placed, piece_fn, 1), n_voxels, dev)
            return out[0].cpu().numpy()

        return NullSpec(family, xs, run, n_voxels, n_total, exact,
                        not exact, statistic, compute_observed, dev)

    # shift families: data is a prepared [T, V, S] stack
    data = np.asarray(data)
    if data.ndim != 3:
        raise ValueError("shift families expect [TRs, voxels, "
                         "subjects] data (got ndim={})".format(
                             data.ndim))
    n_trs, n_voxels, n_subjects = data.shape
    batch = (null_batch_size if null_batch_size is not None
             else default_null_batch(n_trs * n_voxels * n_subjects))
    placed = _shard_voxels(data, mesh, 1, dev)
    tol = bool(tolerate_nans)
    iu = np.triu_indices(n_subjects, k=1) if pairwise else None
    # per piece, once: the leave-one-out spectra (the unshifted
    # others' mean's among them), or for pairwise phases the spectrum
    prepared = {}

    def inputs(piece):
        key = (str(piece.device), piece.data_ptr())
        if key not in prepared:
            if pairwise:
                prepared[key] = torch.fft.rfft(piece, dim=0)
            else:
                xf, yf, den = loo_spectra(piece, _loo_means_core(
                    piece.to(torch.float64), tol))
                prepared[key] = (shift_cross(xf, yf, n_trs), den) \
                    if family == "circular_timeshift" else \
                    phase_basis(xf, yf, n_trs) + (den,)
                del xf, yf
        return prepared[key]

    def program(piece, offset, xs):
        if family == "circular_timeshift":
            if pairwise:
                return _pairwise_stat(circular_timeshift(xs, piece),
                                      statistic, iu_on(piece))
            return timeshift_loo(*inputs(piece), xs, statistic)
        if voxelwise:
            xs = _voxelwise_angles(xs, n_trs, n_voxels, offset, piece)
        if pairwise:
            return _pairwise_stat(rotate_phases(inputs(piece), xs, n_trs),
                                  statistic, iu_on(piece))
        return phase_loo(*inputs(piece), n_trs, xs, statistic)

    def run(xs_chunk):
        def piece_fn(piece, offset):
            # a voxelwise phase's descriptors are seeds, read on the host
            xs = xs_chunk if voxelwise else torch.as_tensor(
                xs_chunk, device=piece.device)
            return _lanes(lambda x: program(piece, offset, x), xs, batch)

        return _collect(_pieces(placed, piece_fn, 1), n_voxels, dev)

    def compute_observed():
        return isc(data, pairwise=pairwise, summary_statistic=statistic,
                   tolerate_nans=tolerate_nans, mesh=mesh, device=dev)

    xs = draw_descriptors(family, seed, n_resamples, n_subjects,
                          n_trs=n_trs, voxelwise=voxelwise)
    return NullSpec(family, xs, run, n_voxels, int(n_resamples), False,
                    True, statistic, compute_observed, dev)
