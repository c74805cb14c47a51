"""Correlation-based voxel selection (FCMA stage 1) on a CUDA device.

PyTorch counterpart of ``brainiak_tpu.fcma.voxelselector``.  The
per-voxel pipeline

    per-epoch correlation -> clamped Fisher-z -> within-subject z-score
    -> per-voxel [E, E] Gram + digit shrink
    -> batched kernel-SVM k-fold cross validation

runs on ``device``.  On CUDA, ``run('svm')`` computes every Gram in one
launch of kernel K1 (:func:`brainiak_tpu_torch.ops.fcma_kernels
.fcma_gram`) over the whole volume, so the [B, E, V] correlation tensor
never reaches device memory, then solves all voxels' SVM duals in one
batched SMO.  ``run(clf)`` with a scikit-learn estimator runs K3
(:func:`~brainiak_tpu_torch.ops.fcma_kernels.fcma_corr_normalize`) per
block of ``voxel_unit`` voxels and cross-validates on the host.  On
the CPU the same wrappers run their plain versions, block by block.

With a ``mesh``, the analog of the reference's MPI voxel task farm,
each block is split over the mesh's voxel positions: every position
runs K1 (or K3) on its slice against ``data2``, which is placed once on
each distinct device, and the SMO runs once a device over its voxels.
With ``use_distla``, ``data2`` is split over the voxel positions
instead and each block's Gram is the sum of the positions' partial
Grams (:func:`brainiak_tpu_torch.ops.distla.block_gram`).  Across
processes (:func:`~brainiak_tpu_torch.parallel.mesh
.initialize_distributed`) each rank scores the voxels of its own
positions and the ranks then sum their scores into the whole result,
the reference's MPI score gather; on the distla path one
``all_reduce`` of the partial Grams gives every rank the whole Grams.
"""

import copy
import logging

import numpy as np
import torch

from ..device import matmul_precision, resolve_device, resolve_precision
from ..obs import spans as obs_spans
from ..ops import distla
from ..ops.fcma_kernels import corr_layout, fcma_corr_normalize, fcma_gram
from ..ops.svm import stratified_kfold, svm_cv_accuracy
from ..parallel.mesh import (DEFAULT_VOXEL_AXIS, Sharded, axis_devices,
                             axis_ranks, comm_device, process_index)

logger = logging.getLogger(__name__)

__all__ = ["VoxelSelector"]


def _shrink(kernels):
    """The reference's magnitude shrink: scale so K[0,0] has at most 2
    integer digits, for stable SVM duals."""
    k00 = kernels[:, 0, 0].clamp(min=1.0)
    ndigits = torch.floor(torch.log10(k00)) + 1
    proportion = torch.where(ndigits > 2, 10.0 ** (2 - ndigits),
                             torch.ones_like(ndigits))
    return kernels * proportion[:, None, None]


def _split(start, stop, n):
    """``[start, stop)`` cut into ``n`` contiguous runs as even as
    possible, the longer ones first (``torch.tensor_split``'s rule)."""
    q, r = divmod(stop - start, n)
    bounds = [start + k * q + min(k, r) for k in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def _on(data, dev):
    """The copy on ``dev`` of a replicated stack (a tensor without a
    mesh)."""
    return data.on(dev) if isinstance(data, Sharded) else data


def _gather_scores(*arrays):
    """Each rank's per-voxel arrays, zero outside its own voxels,
    summed into the whole arrays on every rank by one ``all_reduce``:
    a voxel has one owner, so the sum adds only zeros to its value."""
    summed = torch.from_numpy(np.stack(arrays)).to(comm_device())
    torch.distributed.all_reduce(summed)
    return tuple(summed.cpu().numpy())


def _gram_and_shrink(corr, precision=None):
    """Per-voxel linear-kernel Gram with the magnitude shrink."""
    with matmul_precision(precision) as dtype:
        c = corr.to(dtype)
        kernels = torch.einsum('bev,bfv->bef', c, c).float()
    return _shrink(kernels)


class VoxelSelector:
    """FCMA voxel selection by per-voxel correlation-pattern
    classification.

    Parameters
    ----------
    labels : per-epoch condition labels
    epochs_per_subj : int (epochs of one subject are adjacent)
    num_folds : int, k for stratified CV
    raw_data : list of [epoch_len, n_voxels] normalized epoch arrays
        (from :func:`brainiak_tpu_torch.fcma.preprocessing
        .prepare_fcma_data`)
    raw_data2 : optional second-mask epoch list for region x region FCMA
    voxel_unit : voxels per block on the CPU and in ``run(clf)``
        (``run('svm')`` on CUDA takes the whole volume in one launch)
    svm_C, svm_iters : dual-SVM hyperparameters; the SMO step budget is
        ``svm_iters * n_epochs`` two-coordinate updates per dual, and
        ``run`` warns when a returned KKT gap says the budget was short
    use_pallas : accepted for compatibility with the JAX package; on
        CUDA the kernels always run, on the CPU their plain versions
    precision : 'highest' (default) | 'high' | 'default' for the plain
        matmul paths (see :mod:`brainiak_tpu_torch.device`); the
        kernels compute in fp32 FMA
    device : 'cuda' (default) or 'cpu'; with no CUDA device and no
        explicit 'cpu' the constructor raises ``RuntimeError``
    mesh : optional :class:`~brainiak_tpu_torch.parallel.mesh.Mesh`
        with a ``'voxel'`` axis (a mesh without one raises
        ``ValueError``): each block of ``voxel_unit`` times the axis
        size voxels (on CUDA, the whole volume for ``run('svm')``) is
        split over its positions, each running K1 (``run('svm')``) or
        K3 (``run(clf)``) on its device; ``data2`` is placed once on
        each distinct device, where one SMO solves that device's
        voxels.  A position may repeat a device.  Across processes
        each rank runs its own positions and every rank returns the
        whole result.
    use_distla : 'auto' | True | False: the sharded-Gram path.  ``data2``
        is split over the mesh's voxel axis (zero-padded to a multiple
        of it) instead of replicated; each block of ``voxel_unit``
        voxels goes whole to every position, which runs K1 against its
        voxels of ``data2``, and the partial Grams are summed
        (:func:`~brainiak_tpu_torch.ops.distla.block_gram`).  'auto'
        engages it when a mesh is given and the stacked ``data2``'s
        float32 bytes exceed ``replicated_budget_bytes``.  It serves
        ``run('svm')`` only: under 'auto' a host-CV ``run(clf)`` falls
        back to the replicated layout for that call (with a warning);
        ``True`` raises ``ValueError`` there, and without a mesh.
    replicated_budget_bytes : the budget of ``use_distla='auto'``
        (default: :func:`brainiak_tpu_torch.ops.distla
        .replicated_budget_bytes`)
    process_num, master_rank : accepted for API compatibility; no
        effect

    After ``run('svm')``, ``kkt_gaps_`` holds each voxel's worst final
    KKT violation (about 0 when every dual converged).
    """

    def __init__(self, labels, epochs_per_subj, num_folds, raw_data,
                 raw_data2=None, voxel_unit=256, mesh=None,
                 svm_C=1.0, svm_iters=10, process_num=None,
                 master_rank=0, use_pallas='auto', precision='highest',
                 use_distla='auto', replicated_budget_bytes=None,
                 device="cuda"):
        if mesh is not None and DEFAULT_VOXEL_AXIS not in mesh.shape:
            raise ValueError(
                f"mesh axes {mesh.axis_names} have no "
                f"'{DEFAULT_VOXEL_AXIS}' axis to split the voxels over")
        self.device = resolve_device(device)
        self.labels = np.asarray(labels)
        self.epochs_per_subj = epochs_per_subj
        self.num_folds = num_folds
        self.raw_data = raw_data
        self.raw_data2 = raw_data2
        self.voxel_unit = voxel_unit
        self.mesh = mesh
        self.svm_C = svm_C
        self.svm_iters = svm_iters
        self.precision = resolve_precision(precision)
        self.use_pallas = use_pallas
        self.num_voxels = raw_data[0].shape[1]
        self.num_voxels2 = raw_data2[0].shape[1] if raw_data2 is not None \
            else self.num_voxels
        if raw_data2 is not None and len(raw_data) != len(raw_data2):
            raise ValueError('The raw data lists must have the same number '
                             'of elements for computing the correlations '
                             'element by element')
        if self.num_voxels == 0 or self.num_voxels2 == 0:
            raise ValueError('Zero processed voxels')
        # decided here, where the sizes are known; whether the choice
        # was automatic matters at run(): the path serves the on-device
        # SVM only, and an automatic choice degrades for host CV
        self._distla_auto = use_distla == 'auto'
        if use_distla == 'auto':
            budget = distla.replicated_budget_bytes() \
                if replicated_budget_bytes is None \
                else int(replicated_budget_bytes)
            data2_bytes = (len(raw_data) * raw_data[0].shape[0]
                           * self.num_voxels2 * 4)
            use_distla = mesh is not None and data2_bytes > budget
        elif use_distla and mesh is None:
            raise ValueError(
                "use_distla=True requires a mesh with a voxel axis "
                "(the sharded-Gram path shards data2 over it)")
        self.use_distla = bool(use_distla)

    def _voxel_positions(self):
        """``(devices, ranks)`` of the voxel positions: the mesh's
        along its voxel axis, else one position on ``device``; ranks
        None in one process."""
        if self.mesh is None:
            return [self.device], None
        return (axis_devices(self.mesh, DEFAULT_VOXEL_AXIS),
                axis_ranks(self.mesh, DEFAULT_VOXEL_AXIS))

    def _stack(self):
        """[E, T, V] float32 stacks of raw_data (and raw_data2), cached
        across run() calls.  Without a mesh, two tensors on
        ``device``; with one, replicated :class:`~brainiak_tpu_torch
        .parallel.mesh.Sharded` stacks, a copy on each distinct device
        of this process's voxel positions, but for ``data2`` on the
        distla path, split over the voxel positions (zero-padded up to
        a multiple of them).  Each copy or piece is laid out as K3's
        route for these subjects reads it in place
        (:func:`~brainiak_tpu_torch.ops.fcma_kernels.corr_layout`), so
        no block of ``run(clf)`` copies data2.  The cache is keyed on
        the input objects (the lists and their arrays), the mesh and
        the layout; mutating an array in place is not detected."""
        key = (self.raw_data, self.raw_data2, self.mesh,
               self.use_distla) + tuple(self.raw_data) + (
            tuple(self.raw_data2) if self.raw_data2 is not None else ())
        cached = getattr(self, "_stack_cache", None)
        if cached is not None and len(cached[0]) == len(key) and \
                all(a is b for a, b in zip(cached[0], key)):
            return cached[1]

        def place(host, dev):
            out = corr_layout(host.shape, self.epochs_per_subj, dev)
            out.copy_(torch.from_numpy(host))
            return out

        def stack(arrays):
            return np.stack([np.asarray(a, dtype=np.float32)
                             for a in arrays])

        host1 = stack(self.raw_data)
        host2 = stack(self.raw_data2) if self.raw_data2 is not None \
            else None
        if self.mesh is None:
            data1 = place(host1, self.device)
            data2 = data1 if host2 is None else place(host2, self.device)
        else:
            devices, ranks = self._voxel_positions()
            me = process_index()
            mine = list(dict.fromkeys(
                d for k, d in enumerate(devices)
                if ranks is None or ranks[k] == me))

            def replicate(host):
                return Sharded([place(host, d) for d in mine], mine, 0, ())

            data1 = replicate(host1)
            if self.use_distla:
                host2 = host1 if host2 is None else host2
                n = len(devices)
                pad = (-host2.shape[2]) % n
                if pad:
                    host2 = np.pad(host2, ((0, 0), (0, 0), (0, pad)))
                w = host2.shape[2] // n
                data2 = Sharded(
                    [place(host2[:, :, k * w:(k + 1) * w], d)
                     if ranks is None or ranks[k] == me else None
                     for k, d in enumerate(devices)],
                    devices, 2, (DEFAULT_VOXEL_AXIS,), ranks, host2.shape)
            else:
                data2 = data1 if host2 is None else replicate(host2)
        self._stack_cache = (key, (data1, data2))
        return data1, data2

    def _slice_block(self, data1, start, stop):
        """The [E, T, stop - start] block of selected voxels."""
        return data1[:, :, start:stop].contiguous()

    def run(self, clf='svm'):
        """Score every voxel; returns [(voxel_id, accuracy)] sorted by
        accuracy descending.

        clf : 'svm' runs the batched on-device kernel-SVM CV; an sklearn
            estimator runs host cross-validation per voxel (SVC with
            ``kernel='precomputed'`` gets the Gram matrices, anything
            else the normalized correlation vectors).

        With :mod:`brainiak_tpu_torch.obs` enabled the selection runs
        under a ``fcma.voxel_selection`` span with one ``fcma.block``
        span per voxel block and a ``fcma.svm_cv`` span around the
        batched SMO solve, as in the JAX package; disabled (default)
        the spans are no-ops.  No span synchronizes the card: a block's
        span times its launches, and the SMO's closing fetch to the
        host charges the compute to ``fcma.svm_cv``.
        """
        clf_label = clf if isinstance(clf, str) else type(clf).__name__
        with obs_spans.span("fcma.voxel_selection",
                            attrs={"clf": clf_label,
                                   "n_voxels": self.num_voxels}):
            return self._run(clf)

    def _run(self, clf):
        on_device_svm = isinstance(clf, str) and clf == 'svm'
        if self.use_distla and not on_device_svm:
            if not self._distla_auto:
                raise ValueError(
                    "the distla sharded-Gram path only supports the "
                    "on-device SVM (run('svm')); pass "
                    "use_distla=False for host cross-validation")
            # auto-engaged: the classifier is known only here.  Run
            # this call on the replicated layout, which may exceed the
            # budget that engaged the path, and restore it after.
            logger.warning(
                "use_distla='auto' engaged (replicating data2 "
                "exceeds the budget) but host cross-validation "
                "needs the replicated layout; falling back for "
                "this run() call")
            self.use_distla = False
            try:
                return self._run(clf)
            finally:
                self.use_distla = True
        data1, data2 = self._stack()
        devices, ranks = self._voxel_positions()
        me = process_index()
        if self.use_distla:
            # the parallelism is over data2's voxels: blocks stay whole
            block = self.voxel_unit
        elif on_device_svm and all(d.type == "cuda" for d in devices):
            # K1 never materializes [B, E, V]: no memory reason to block
            block = self.num_voxels
        else:
            block = self.voxel_unit * len(devices)

        accs = np.zeros(self.num_voxels)
        gaps = np.zeros(self.num_voxels)
        grams = {}   # device -> [(start, stop, shrunk Grams)]
        for start in range(0, self.num_voxels, block):
            with obs_spans.span("fcma.block", attrs={"start": start}):
                stop = min(start + block, self.num_voxels)
                if self.use_distla:
                    kernels = _shrink(distla.block_gram(
                        data1.map(lambda d: self._slice_block(d, start,
                                                              stop)),
                        data2, self.mesh, self.epochs_per_subj,
                        precision=self.precision))
                    grams.setdefault(kernels.device, []).append(
                        (start, stop, kernels))
                    continue
                for k, (a, b) in enumerate(_split(start, stop,
                                                  len(devices))):
                    if a == b or (ranks is not None and ranks[k] != me):
                        continue
                    dev = devices[k]
                    blk = self._slice_block(_on(data1, dev), a, b)
                    if on_device_svm:
                        grams.setdefault(dev, []).append((a, b, _shrink(
                            fcma_gram(blk, _on(data2, dev),
                                      self.epochs_per_subj,
                                      precision=self.precision))))
                        continue
                    corr = fcma_corr_normalize(blk, _on(data2, dev),
                                               self.epochs_per_subj,
                                               precision=self.precision)
                    kernels = _gram_and_shrink(corr, self.precision)
                    accs[a:b] = self._host_cv(clf, kernels, corr)

        if on_device_svm:
            with obs_spans.span("fcma.svm_cv") as svm_span:
                n_solved = 0
                for dev, parts in grams.items():
                    kernels = torch.cat([k for _, _, k in parts])
                    dev_accs, dev_gaps = svm_cv_accuracy(
                        kernels, self.labels, self.num_folds,
                        C=self.svm_C, n_iters=self.svm_iters,
                        return_gap=True, device=dev)
                    pos = 0
                    for a, b, _ in parts:
                        accs[a:b] = dev_accs[pos:pos + b - a]
                        gaps[a:b] = dev_gaps[pos:pos + b - a]
                        pos += b - a
                    n_solved += pos
                svm_span.set("n_voxels", n_solved)
        if ranks is not None and not self.use_distla:
            accs, gaps = _gather_scores(accs, gaps)
        if on_device_svm:
            self.kkt_gaps_ = gaps
            worst = float(np.max(gaps))
            if worst > 0.05:
                # not libsvm's 1e-3 tolerance: duals plateau near 1e-2
                # while accuracies stay within one boundary sample of a
                # converged run; beyond ~5e-2 decisions start to move
                logger.warning(
                    "SMO budget svm_iters=%d left %d/%d voxel duals "
                    "with a large KKT gap (worst %.2e); accuracies may "
                    "be degraded — raise svm_iters", self.svm_iters,
                    int(np.sum(gaps > 0.05)), len(gaps), worst)
        results = [(i, float(a)) for i, a in enumerate(accs)]
        results.sort(key=lambda tup: tup[1], reverse=True)
        return results

    def _host_cv(self, clf, kernels, corr):
        """Host cross-validation of a scikit-learn estimator per voxel,
        with ``StratifiedKFold(shuffle=False)`` folds; each fold fits a
        fresh copy of ``clf`` and takes its ``score``, as
        ``cross_val_score`` does.  A precomputed-kernel estimator gets
        the [train, train] / [test, train] blocks of each Gram."""
        precomputed = getattr(clf, 'kernel', None) == 'precomputed'
        data = (kernels if precomputed else corr).cpu().numpy()
        folds = list(stratified_kfold(self.labels, self.num_folds))
        accs = np.empty(data.shape[0])
        for i in range(data.shape[0]):
            scores = []
            for train, test in folds:
                est = copy.deepcopy(clf)
                if precomputed:
                    x_train = data[i][np.ix_(train, train)]
                    x_test = data[i][np.ix_(test, train)]
                else:
                    x_train, x_test = data[i][train], data[i][test]
                est.fit(x_train, self.labels[train])
                scores.append(est.score(x_test, self.labels[test]))
            accs[i] = np.mean(scores)
        return accs
