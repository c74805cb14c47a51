"""FastSRM: atlas-accelerated deterministic SRM, the port's.

PyTorch counterpart of ``brainiak_tpu.funcalign.fastsrm``.  The
pipeline: (1) optionally project each subject's data onto an atlas
(deterministic label means on the host, or a probabilistic
pseudo-inverse product on the device), (2) run the port's
:class:`~brainiak_tpu_torch.funcalign.srm.DetSRM` in the reduced space
on session-concatenated data, on ``device``, (3) recover each
subject's full-resolution basis as the polar factor of Σ_j S_jᵀ X_j
(the product on the device, its wide SVD by ``torch.linalg.svd``),
(4) transform and inverse-transform through those bases.  Data may be
arrays or ``.npy`` paths; ``temp_dir`` / ``low_ram`` spill the bases
and the reduced data to disk; sessions may differ in length.  No
hand-written kernel: the JAX package runs all of it as XLA ops.

``n_jobs`` other than 1 reduces the subjects in a
``concurrent.futures.ThreadPoolExecutor`` (the JAX package uses
joblib's threads; the port depends on no joblib), results in subject
order.  A ``SubjectStore`` or its ``SubjectRef`` handles (the data
plane, ROADMAP item 13) raise ``NotImplementedError``.
"""

import concurrent.futures
import logging
import os
import uuid

import numpy as np

from ..device import resolve_device
from .srm import (DetSRM, NotFittedError, _Estimator, _host, _procrustes,
                  _tensor)

__all__ = ["FastSRM"]

logger = logging.getLogger(__name__)

#: Voxel rows per streamed ingestion slab (:func:`_iter_voxel_chunks`).
REDUCE_CHUNK_VOXELS = 8192


def _refuse_lazy(img):
    """A ``SubjectStore`` (its ``read`` / ``voxel_counts`` /
    ``digests`` surface) or a ``SubjectRef`` (``load`` /
    ``iter_voxel_chunks``) needs the data plane, not ported yet."""
    if all(hasattr(img, a) for a in ("read", "voxel_counts", "digests")) \
            or hasattr(img, "iter_voxel_chunks") or hasattr(img, "load"):
        raise NotImplementedError(
            "fitting from a SubjectStore needs the data plane "
            "(data/, ROADMAP queue A item 13), which is not ported "
            "yet; pass a list of [voxels, samples] arrays")


def _safe_load(data):
    if isinstance(data, str):
        return np.load(data)
    return np.asarray(data)


def _canonicalize_imgs(imgs):
    """Accepts: an array of paths [n_subjects, n_sessions]; a list of
    arrays (one session each); a list of lists of arrays or paths.
    Returns a list of lists: imgs[subject][session]."""
    _refuse_lazy(imgs)
    if isinstance(imgs, np.ndarray) and imgs.dtype.kind in ("U", "S", "O") \
            and imgs.ndim == 2:
        out = [[imgs[i, j] for j in range(imgs.shape[1])]
               for i in range(imgs.shape[0])]
    elif isinstance(imgs, (list, tuple)):
        if len(imgs) == 0:
            raise ValueError("imgs is empty")
        if isinstance(imgs[0], (list, tuple)):
            out = [list(subj) for subj in imgs]
        else:
            out = [[subj] for subj in imgs]
    else:
        raise ValueError("imgs must be a list of arrays, a list of lists "
                         "of arrays, or a 2D array of paths")
    for subj in out:
        for img in subj:
            _refuse_lazy(img)
    return out


def _shape_of(img):
    if isinstance(img, str):
        return np.load(img, mmap_mode="r").shape
    return np.asarray(img).shape


def _iter_voxel_chunks(img, chunk_voxels=None):
    """Yield ``(start_row, block)`` voxel slabs of ``img`` without
    loading it whole: ``.npy`` paths are served off a read-only memmap,
    in-memory arrays are sliced in place."""
    chunk = int(chunk_voxels or REDUCE_CHUNK_VOXELS)
    data = np.load(img, mmap_mode="r") if isinstance(img, str) \
        else np.asarray(img)
    for start in range(0, data.shape[0], chunk):
        yield start, np.asarray(data[start:start + chunk])


def _check_imgs_consistency(imgs, atlas, n_components):
    """Shape validation: every subject needs the same voxel count,
    sessions agree in timeframes across subjects, the atlas covers the
    data voxels with more regions than components, and the total
    timeframe count reaches n_components.  Only shapes are touched
    (paths probed with mmap, the raw atlas inspected before any
    pseudo-inverse is built)."""
    shapes = [[_shape_of(img) for img in subj] for subj in imgs]
    for i, subj in enumerate(shapes):
        for j, shp in enumerate(subj):
            if len(shp) != 2:
                raise ValueError(
                    f"imgs[{i}][{j}] should have exactly 2 axes "
                    f"(voxels, timeframes); got shape {shp}")
            if shp[0] != shapes[0][0][0]:
                raise ValueError(
                    f"imgs[{i}][{j}] has {shp[0]} voxels whereas "
                    f"imgs[0][0] has {shapes[0][0][0]}; all subjects "
                    "must share the voxel space")
            if shp[1] != shapes[0][j][1]:
                raise ValueError(
                    f"imgs[{i}][{j}] has {shp[1]} timeframes whereas "
                    f"imgs[0][{j}] has {shapes[0][j][1]}; sessions must "
                    "have the same length across subjects")
    n_voxels = shapes[0][0][0]
    total_t = sum(shp[1] for shp in shapes[0])
    if n_components is not None and total_t < n_components:
        raise ValueError(
            f"Total number of timeframes ({total_t}) is shorter than "
            f"the number of components ({n_components})")
    if atlas is not None:
        atlas = np.asarray(atlas)
        if atlas.ndim == 2:  # probabilistic [n_supervoxels, n_voxels]
            atlas_voxels, n_regions = atlas.shape[1], atlas.shape[0]
        else:
            atlas_voxels = len(atlas)
            n_regions = len(np.setdiff1d(np.unique(atlas), [0]))
        if atlas_voxels != n_voxels:
            raise ValueError(
                f"Atlas has {atlas_voxels} voxels but data have "
                f"{n_voxels}")
        if n_components is not None and n_regions <= n_components:
            raise ValueError(
                f"Atlas has {n_regions} regions which must exceed the "
                f"number of components ({n_components})")


def _check_indexes(indexes, n_max, name):
    for idx in indexes:
        if not 0 <= int(idx) < n_max:
            raise ValueError(
                f"Index {int(idx)} of {name} is out of range "
                f"(0..{n_max - 1})")


def _reduce_one(data, atlas, inv_atlas, chunk_voxels=None, device="cuda"):
    """Project [n_voxels, n_timeframes] data to the reduced space;
    returns [n_timeframes, n_supervoxels] (numpy).

    ``.npy`` paths are reduced voxel slab by voxel slab off a memmap
    (:func:`_iter_voxel_chunks`, float64 accumulators on the host, cast
    back to the input's result type), so they are never loaded whole.
    In-memory arrays take the probabilistic atlas' product on
    ``device``, in the data's dtype (at least float32), and the
    deterministic atlas' label means on the host.
    An explicit ``chunk_voxels`` forces the streamed route."""
    if inv_atlas is None and atlas is None:
        return _safe_load(data).T
    if not isinstance(data, str) and chunk_voxels is None:
        data_t = np.asarray(data).T  # [T, V]
        if inv_atlas is not None:
            dev = resolve_device(device)
            return _host(_tensor(data_t, data_t.dtype, dev)
                         @ _tensor(inv_atlas, data_t.dtype, dev))
        values = np.unique(atlas)
        values = values[values != 0]
        return np.stack([data_t[:, atlas == c].mean(axis=1)
                         for c in values], axis=1)
    n_voxels, n_frames = _shape_of(data)
    if inv_atlas is not None:
        inv_atlas = np.asarray(inv_atlas)
        out = np.zeros((n_frames, inv_atlas.shape[1]))
        for start, block in _iter_voxel_chunks(data, chunk_voxels):
            out += block.T.astype(np.float64) \
                @ inv_atlas[start:start + block.shape[0]]
        return out.astype(np.result_type(block.dtype, inv_atlas.dtype),
                          copy=False)
    atlas = np.asarray(atlas)
    values = np.unique(atlas)
    values = values[values != 0]
    sums = np.zeros((n_frames, len(values)))
    counts = np.array([np.count_nonzero(atlas == c) for c in values],
                      dtype=np.float64)
    for start, block in _iter_voxel_chunks(data, chunk_voxels):
        onehot = (atlas[start:start + block.shape[0], None]
                  == values[None, :]).astype(np.float64)
        sums += block.T.astype(np.float64) @ onehot
    return (sums / counts).astype(block.dtype, copy=False)


def _map_subjects(fn, n_subjects, n_jobs):
    """``[fn(i) for i in range(n_subjects)]``, on ``n_jobs`` threads
    unless it is ``None`` or 1 (a negative count as joblib reads it:
    -1 every core, -2 all but one), in subject order."""
    if n_jobs in (None, 1):
        return [fn(i) for i in range(n_subjects)]
    workers = n_jobs if n_jobs > 0 else \
        max(1, (os.cpu_count() or 1) + 1 + n_jobs)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, range(n_subjects)))


class FastSRM(_Estimator):
    """FastSRM.

    Parameters
    ----------
    atlas : None, [n_voxels] deterministic labels (0 = ignore), or
        [n_supervoxels, n_voxels] probabilistic atlas
    n_components : int
    n_iter : int, reduced-space SRM iterations
    temp_dir : str or None — spill bases / reduced data as .npy
    low_ram : bool — with temp_dir, keep intermediates on disk
    seed : int, the reduced-space SRM's ``rand_seed``
    n_jobs : threads for the host load and reduce stage over subjects
    aggregate : 'mean' or None — transform returns the subject mean or
        per-subject projections
    device : str or torch.device, default "cuda" — where the
        reduced-space SRM and the products run (raises without a card
        unless ``"cpu"``)
    """

    _param_names = ("atlas", "n_components", "n_iter", "temp_dir",
                    "low_ram", "seed", "n_jobs", "verbose", "aggregate",
                    "device")

    def __init__(self, atlas=None, n_components=20, n_iter=100,
                 temp_dir=None, low_ram=False, seed=0, n_jobs=1,
                 verbose="warn", aggregate="mean", device="cuda"):
        if aggregate is not None and aggregate != "mean":
            raise ValueError("aggregate can have only value mean or None")
        self.atlas = atlas
        self.n_components = n_components
        self.n_iter = n_iter
        self.low_ram = low_ram
        self.seed = seed
        self.n_jobs = n_jobs
        self.verbose = verbose
        self.aggregate = aggregate
        self.device = device
        self.basis_list = None
        if temp_dir is None:
            self.temp_dir = None
            self.low_ram = False
        else:
            self.temp_dir = os.path.join(temp_dir,
                                         "fastsrm" + str(uuid.uuid4()))

    # -- internals --------------------------------------------------------
    def _atlas_parts(self):
        if self.atlas is None:
            return None, None
        atlas = np.asarray(self.atlas)
        if atlas.ndim == 2:
            return None, np.linalg.pinv(atlas)  # probabilistic
        return atlas, None

    def _maybe_spill(self, array, name, bases=False):
        # bases spill whenever temp_dir is set; reduced data only under
        # low_ram
        if self.temp_dir is not None and (bases or self.low_ram):
            os.makedirs(self.temp_dir, exist_ok=True)
            path = os.path.join(self.temp_dir, name + ".npy")
            np.save(path, array)
            return path
        return array

    def clean(self):
        """Remove the temporary files."""
        if self.temp_dir is not None and os.path.exists(self.temp_dir):
            for f in os.listdir(self.temp_dir):
                os.remove(os.path.join(self.temp_dir, f))
            os.rmdir(self.temp_dir)

    def _compute_basis(self, subject_sessions, shared_sessions):
        """Basis [n_components, n_voxels]: the polar factor of
        Σ_j S_jᵀ X_j, in the dtype of the shared response (float32
        after a fit).  Path sessions accumulate it voxel slab by voxel
        slab on the host (the [K, V] accumulator is the working set);
        in-memory sessions take one product each on the device."""
        dev = resolve_device(self.device)
        corr = None
        for img, shared in zip(subject_sessions, shared_sessions):
            if isinstance(img, str):
                n_voxels = _shape_of(img)[0]
                c = np.zeros((shared.shape[1], n_voxels))
                for start, block in _iter_voxel_chunks(img):
                    c[:, start:start + block.shape[0]] = \
                        (block @ shared).T  # block: [v, T]
                c = _tensor(c, shared.dtype, dev)
            else:
                c = _tensor(shared, shared.dtype, dev).T \
                    @ _tensor(img, shared.dtype, dev).T
            corr = c if corr is None else corr + c
        return _host(_procrustes(corr))

    # -- API --------------------------------------------------------------
    def fit(self, imgs, checkpoint_dir=None, checkpoint_every=5):
        """Fit the bases from multi-subject (multi-session) data.

        With ``checkpoint_dir``, the iterative stage (the reduced-space
        deterministic SRM) checkpoints every ``checkpoint_every``
        iterations under the resilience guard and resumes after
        preemption; the projection and SVD stages around it are
        recomputed deterministically.

        Example
        -------
        >>> fsrm = FastSRM(n_components=10, n_iter=100)
        >>> fsrm.fit(imgs, checkpoint_dir="/ckpts/fast1")  # resumable
        """
        resolve_device(self.device)
        imgs = _canonicalize_imgs(imgs)
        n_subjects = len(imgs)
        if n_subjects <= 1:
            raise ValueError("There are not enough subjects in the input "
                             "data to train the model.")
        n_sessions = len(imgs[0])
        for subj in imgs:
            if len(subj) != n_sessions:
                raise ValueError("All subjects must have the same number "
                                 "of sessions")

        _check_imgs_consistency(imgs, self.atlas, self.n_components)
        atlas, inv_atlas = self._atlas_parts()

        def reduce_subject(i):
            return [self._maybe_spill(
                _reduce_one(imgs[i][j], atlas, inv_atlas,
                            device=self.device),
                f"reduced_{i}_{j}") for j in range(n_sessions)]

        reduced = _map_subjects(reduce_subject, n_subjects, self.n_jobs)
        shared_sessions = self._fit_reduced(reduced, checkpoint_dir,
                                            checkpoint_every)
        self.basis_list = []
        for i in range(n_subjects):
            basis = self._compute_basis(imgs[i], shared_sessions)
            self.basis_list.append(
                self._maybe_spill(basis, f"basis_{i}", bases=True))
        return self

    def _fit_reduced(self, reduced, checkpoint_dir, checkpoint_every):
        """The reduced-space DetSRM on session-concatenated data; the
        subjects' mean shared response cut back into sessions, each
        [T_j, K] (numpy, float32)."""
        first_subj = [_safe_load(r) for r in reduced[0]]
        session_lengths = [r.shape[0] for r in first_subj]
        X = [np.concatenate(first_subj, axis=0).T] + \
            [np.concatenate([_safe_load(r) for r in subj], axis=0).T
             for subj in reduced[1:]]
        det = DetSRM(n_iter=self.n_iter, features=self.n_components,
                     rand_seed=self.seed, device=self.device)
        det.fit(X,
                checkpoint_dir=None if checkpoint_dir is None else
                os.path.join(checkpoint_dir, "reduced_srm"),
                checkpoint_every=checkpoint_every)
        # [T, K], in the fit's float32 (the host transform promotes)
        concatenated_s = np.mean(det.transform(X), axis=0).T.astype(
            det.s_.dtype)
        bounds = np.cumsum([0] + session_lengths)
        return [concatenated_s[a:b] for a, b in zip(bounds[:-1],
                                                    bounds[1:])]

    def _check_against_basis(self, imgs):
        """Transform-time shape validation against the fitted bases'
        voxel space."""
        n_voxels = _safe_load(self.basis_list[0]).shape[1]
        for i, subj in enumerate(imgs):
            for j, img in enumerate(subj):
                shp = _shape_of(img)
                if len(shp) != 2 or shp[0] != n_voxels:
                    raise ValueError(
                        f"imgs[{i}][{j}] has shape {shp} but the fitted "
                        f"bases expect ({n_voxels}, n_timeframes)")

    def transform(self, imgs, subjects_indexes=None):
        """Project data into shared space (each session's product on
        ``device``, in the bases' dtype; numpy out)."""
        if self.basis_list is None:
            raise NotFittedError("The model fit has not been run yet.")
        imgs = _canonicalize_imgs(imgs)
        if subjects_indexes is None:
            subjects_indexes = list(range(len(imgs)))
        _check_indexes(subjects_indexes, len(self.basis_list),
                       "subjects_indexes")
        if len(imgs) != len(subjects_indexes):
            raise ValueError(
                f"imgs has {len(imgs)} subjects but subjects_indexes "
                f"has {len(subjects_indexes)} entries; they must match")
        self._check_against_basis(imgs)
        n_sessions = len(imgs[0])

        per_subject = []
        for pos, i in enumerate(subjects_indexes):
            basis = _safe_load(self.basis_list[i])
            sessions = []
            dev = resolve_device(self.device)
            b = _tensor(basis, basis.dtype, dev)
            for j in range(n_sessions):
                sessions.append(_host(
                    b @ _tensor(_safe_load(imgs[pos][j]), basis.dtype,
                                dev)))
            per_subject.append(sessions)

        if self.aggregate == "mean":
            out = [np.mean([subj[j] for subj in per_subject], axis=0)
                   for j in range(n_sessions)]
            return out[0] if n_sessions == 1 else out
        if n_sessions == 1:
            return [subj[0] for subj in per_subject]
        return per_subject

    def fit_transform(self, imgs, subjects_indexes=None):
        self.fit(imgs)
        return self.transform(imgs, subjects_indexes=subjects_indexes)

    def inverse_transform(self, shared_response, subjects_indexes=None,
                          sessions_indexes=None):
        """Reconstruct voxel-space data: basisᵀ · shared (numpy, on the
        host)."""
        if self.basis_list is None:
            raise NotFittedError("The model fit has not been run yet.")
        if subjects_indexes is None:
            subjects_indexes = list(range(len(self.basis_list)))
        _check_indexes(subjects_indexes, len(self.basis_list),
                       "subjects_indexes")
        single_session = isinstance(shared_response, np.ndarray)
        shared = [shared_response] if single_session else \
            list(shared_response)
        if sessions_indexes is None:
            sessions_indexes = list(range(len(shared)))
        _check_indexes(sessions_indexes, len(shared), "sessions_indexes")

        data = []
        for i in subjects_indexes:
            basis = _safe_load(self.basis_list[i])
            if single_session:
                data.append(basis.T @ shared[0])
            else:
                data.append([basis.T @ shared[j]
                             for j in sessions_indexes])
        return data

    def add_subjects(self, imgs, shared_response):
        """Fit the bases of more subjects against an existing shared
        response."""
        resolve_device(self.device)
        if self.basis_list is None:
            self.basis_list = []
        imgs = _canonicalize_imgs(imgs)
        if self.basis_list:
            self._check_against_basis(imgs)
        single = isinstance(shared_response, np.ndarray)
        shared = [shared_response.T] if single else \
            [s.T for s in shared_response]
        for subj in imgs:
            basis = self._compute_basis(subj, shared)
            self.basis_list.append(
                self._maybe_spill(basis, f"basis_{len(self.basis_list)}",
                                  bases=True))
        return self
