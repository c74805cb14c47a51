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
"""

import copy
import logging

import numpy as np
import torch

from ..device import matmul_precision, resolve_device, resolve_precision
from ..ops.fcma_kernels import corr_layout, fcma_corr_normalize, fcma_gram
from ..ops.svm import stratified_kfold, svm_cv_accuracy

logger = logging.getLogger(__name__)

__all__ = ["VoxelSelector"]

_MULTI_GPU = ("{} needs the multi-GPU slice of the PyTorch port "
              "(ROADMAP queue A, slice 4), which is not ported yet")


def _shrink(kernels):
    """The reference's magnitude shrink: scale so K[0,0] has at most 2
    integer digits, for stable SVM duals."""
    k00 = kernels[:, 0, 0].clamp(min=1.0)
    ndigits = torch.floor(torch.log10(k00)) + 1
    proportion = torch.where(ndigits > 2, 10.0 ** (2 - ndigits),
                             torch.ones_like(ndigits))
    return kernels * proportion[:, None, None]


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
    mesh, use_distla : multi-device paths; ``mesh`` and
        ``use_distla=True`` raise ``NotImplementedError``
    process_num, master_rank, replicated_budget_bytes : accepted for
        API compatibility; no effect

    After ``run('svm')``, ``kkt_gaps_`` holds each voxel's worst final
    KKT violation (about 0 when every dual converged).
    """

    def __init__(self, labels, epochs_per_subj, num_folds, raw_data,
                 raw_data2=None, voxel_unit=256, mesh=None,
                 svm_C=1.0, svm_iters=10, process_num=None,
                 master_rank=0, use_pallas='auto', precision='highest',
                 use_distla='auto', replicated_budget_bytes=None,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError(_MULTI_GPU.format("mesh="))
        if use_distla is True:
            raise NotImplementedError(_MULTI_GPU.format("use_distla=True"))
        self.device = resolve_device(device)
        self.labels = np.asarray(labels)
        self.epochs_per_subj = epochs_per_subj
        self.num_folds = num_folds
        self.raw_data = raw_data
        self.raw_data2 = raw_data2
        self.voxel_unit = voxel_unit
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

    def _stack(self):
        """[E, T, V] float32 tensors of raw_data (and raw_data2) on the
        device, cached across run() calls.  They are laid out as K3's
        route for these subjects reads them in place
        (:func:`~brainiak_tpu_torch.ops.fcma_kernels.corr_layout`), so
        no block of ``run(clf)`` copies data2.  The cache is keyed on
        the input objects (the lists and their arrays); mutating an
        array in place is not detected."""
        key = (self.raw_data, self.raw_data2) + tuple(self.raw_data) + (
            tuple(self.raw_data2) if self.raw_data2 is not None else ())
        cached = getattr(self, "_stack_cache", None)
        if cached is not None and len(cached[0]) == len(key) and \
                all(a is b for a, b in zip(cached[0], key)):
            return cached[1]

        def stack(arrays):
            host = torch.from_numpy(np.stack(
                [np.asarray(a, dtype=np.float32) for a in arrays]))
            out = corr_layout(host.shape, self.epochs_per_subj,
                              self.device)
            out.copy_(host)
            return out

        data1 = stack(self.raw_data)
        data2 = stack(self.raw_data2) if self.raw_data2 is not None \
            else data1
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
        """
        on_device_svm = isinstance(clf, str) and clf == 'svm'
        data1, data2 = self._stack()
        block = self.voxel_unit
        if on_device_svm and data1.is_cuda:
            # K1 never materializes [B, E, V]: no memory reason to block
            block = self.num_voxels

        results = []
        grams = []
        for start in range(0, self.num_voxels, block):
            stop = min(start + block, self.num_voxels)
            blk = self._slice_block(data1, start, stop)
            if on_device_svm:
                grams.append(_shrink(fcma_gram(
                    blk, data2, self.epochs_per_subj,
                    precision=self.precision)))
                continue
            corr = fcma_corr_normalize(blk, data2, self.epochs_per_subj,
                                       precision=self.precision)
            kernels = _gram_and_shrink(corr, self.precision)
            accs = self._host_cv(clf, kernels, corr)
            results.extend((start + i, float(a)) for i, a in
                           enumerate(accs))

        if on_device_svm:
            all_accs, gaps = svm_cv_accuracy(
                torch.cat(grams), self.labels, self.num_folds,
                C=self.svm_C, n_iters=self.svm_iters, return_gap=True,
                device=self.device)
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
            results = [(i, float(a)) for i, a in enumerate(all_accs)]

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
