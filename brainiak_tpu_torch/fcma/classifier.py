"""Correlation-based classification (FCMA stage 2) on a CUDA device.

PyTorch counterpart of ``brainiak_tpu.fcma.classifier``.  A sample is
a pair of epoch arrays ([T, V1], [T, V2], epoch-normalized); its
features are the correlations of every (region 1 voxel, region 2
voxel) pair, Fisher-z'd and z-scored within groups of
``epochs_per_subj`` samples when that is above 1.  The estimator
(scikit-learn style, ``fit`` / ``predict`` / ``decision_function``)
runs on the host on numpy arrays.

* A precomputed-kernel estimator (``clf.kernel == 'precomputed'``)
  with ``num_processed_voxels`` below region 1's width and
  ``num_training_samples`` given gets the sample Gram from one launch
  of kernel K4 (:func:`brainiak_tpu_torch.ops.fcma_kernels
  .fcma_sample_gram`) over all samples: the [N, V1 * V2] features never
  reach device memory.  On the CPU the same wrapper runs its plain
  version.
* Otherwise the features are formed on ``device`` in plain PyTorch (the
  JAX package forms them outside any Pallas kernel too), and a
  precomputed-kernel estimator gets ``features @ features.T``.

The Gram is shrunk as the reference does (``num_digits_``), and test
similarity vectors are scaled the same way.
"""

import logging

import numpy as np
import torch

from ..device import matmul_precision, resolve_device
from ..ops.fcma_kernels import fcma_sample_gram
from ..ops.fisherz import within_subject_normalization

logger = logging.getLogger(__name__)

__all__ = ["Classifier"]


def _accuracy(y, pred, sample_weight=None):
    """Share of correct predictions, weighted by ``sample_weight``
    (the semantics of scikit-learn's ``accuracy_score``)."""
    y = np.asarray(y)
    pred = np.asarray(pred)
    if len(y) != len(pred):
        raise ValueError(f"Found input variables with inconsistent "
                         f"numbers of samples: [{len(y)}, {len(pred)}]")
    return float(np.average(y == pred, weights=sample_weight))


class Classifier:
    """FCMA classifier over correlation features.

    Parameters
    ----------
    clf : an estimator with scikit-learn's ``fit`` / ``predict`` /
        ``decision_function``; one whose ``kernel`` attribute is
        ``'precomputed'`` (such as ``SVC(kernel='precomputed')``) gets
        sample Grams instead of features.
    num_processed_voxels : int; below region 1's width, a
        precomputed-kernel fit needs ``num_training_samples`` and its
        Gram comes from kernel K4 without forming the features (which
        take the place of the JAX package's voxel portions).
    epochs_per_subj : int, the samples of one normalization group; 0
        (or 1) uses the raw correlations.
    use_pallas : accepted for compatibility with the JAX package; on
        CUDA the portioned fit always runs K4, on the CPU its plain
        version.
    device : 'cuda' (default) or 'cpu'; with no CUDA device and no
        explicit 'cpu' the constructor raises ``RuntimeError``.
    """

    def __init__(self, clf, num_processed_voxels=2000, epochs_per_subj=0,
                 use_pallas='auto', device="cuda"):
        self.device = resolve_device(device)
        self.clf = clf
        self.num_processed_voxels = num_processed_voxels
        self.epochs_per_subj = epochs_per_subj
        self.use_pallas = use_pallas
        self.num_digits_ = 0

    # -- helpers ----------------------------------------------------------
    def _is_precomputed(self):
        return getattr(self.clf, "kernel", None) == "precomputed"

    def _stack_pairs(self, X):
        """[N, T, V] float32 tensors of both regions on the device,
        region 1 the wider."""
        for x in X:
            if len(x) != 2:
                raise ValueError('there must be two parts for each '
                                 'correlation computation')
        X1, X2 = zip(*X)
        num_voxels1 = X1[0].shape[1]
        num_voxels2 = X2[0].shape[1]
        if num_voxels1 < num_voxels2:
            X1, X2 = X2, X1
            num_voxels1, num_voxels2 = num_voxels2, num_voxels1

        def stack(arrays):
            return torch.from_numpy(np.stack(
                [np.asarray(a, dtype=np.float32) for a in arrays])).to(
                    self.device)

        return stack(X1), stack(X2), num_voxels1, num_voxels2

    @staticmethod
    def _features(x1, x2, norm_unit):
        """[N, V1 * V2] correlation features, within-subject normalized
        when ``norm_unit > 1``."""
        with matmul_precision(None):
            corr = torch.bmm(x1.transpose(1, 2), x2)
        n, b, v = corr.shape
        if norm_unit > 1:
            corr = within_subject_normalization(
                corr.reshape(1, n, b * v), norm_unit)
        return corr.reshape(n, b * v)

    def _digit_shrink(self, kernel):
        """The reference's magnitude shrink of a Gram (tensor) into a
        numpy array, recorded in num_digits_ so test similarity vectors
        scale identically."""
        kernel = kernel.cpu().numpy()
        num_digits = len(str(int(kernel[0, 0])))
        self.num_digits_ = num_digits
        if num_digits > 2:
            kernel *= 10 ** (2 - num_digits)
        return kernel

    # -- estimator API ----------------------------------------------------
    def fit(self, X, y, num_training_samples=None):
        """Train on correlation features of (region1, region2) pairs.

        With ``num_training_samples``, X holds the training samples
        first and the test samples after them; the test similarity
        vectors are computed here, and ``predict()`` / ``score(None,
        y)`` use them.
        """
        if len(X) != len(y):
            raise ValueError('the number of samples must be equal to the '
                             'number of labels')
        x1, x2, num_voxels1, num_voxels2 = self._stack_pairs(X)
        precomputed = self._is_precomputed()
        if not precomputed and num_training_samples is not None:
            num_training_samples = None
            logger.warning(
                'num_training_samples should not be set for classifiers '
                'other than SVM with precomputed kernels')
        self.num_voxels_ = num_voxels1
        self.num_features_ = num_voxels1 * num_voxels2
        self.num_samples_ = len(X)
        norm_unit = self.epochs_per_subj

        if not precomputed:
            data = self._features(x1, x2, norm_unit).cpu().numpy()
            self.training_data_ = None
        elif self.num_processed_voxels < self.num_voxels_:
            if num_training_samples is None:
                raise RuntimeError(
                    'the kernel matrix will be computed portion by '
                    'portion, the test samples must be predefined by '
                    'specifying num_training_samples')
            if num_training_samples >= self.num_samples_:
                raise ValueError('the number of training samples '
                                 'must be smaller than '
                                 'the number of total samples')
            data = self._digit_shrink(fcma_sample_gram(x1, x2, norm_unit))
            self.training_data_ = None
        else:
            feats = self._features(x1, x2, norm_unit)
            with matmul_precision(None):
                kernel = torch.matmul(feats, feats.T)
            data = self._digit_shrink(kernel)
            self.training_data_ = feats.cpu().numpy()

        self.test_raw_data_ = None
        if num_training_samples is not None:
            self.test_data_ = data[num_training_samples:,
                                   0:num_training_samples]
            data = data[0:num_training_samples, 0:num_training_samples]
        else:
            self.test_data_ = None
        self.clf = self.clf.fit(data, y[0:num_training_samples])
        return self

    def _prepare_test_data(self, X):
        x1, x2, num_voxels1, num_voxels2 = self._stack_pairs(X)
        if self.num_features_ != num_voxels1 * num_voxels2:
            raise ValueError('the number of features does not match the '
                             'model')
        num_test_samples = len(X)
        self.test_raw_data_ = X
        feats = self._features(x1, x2, num_test_samples)
        if self._is_precomputed():
            if self.training_data_ is None:
                raise ValueError('when using precomputed kernel of SVM, '
                                 'all training data must be provided')
            train = torch.tensor(self.training_data_,
                                 dtype=torch.float32, device=self.device)
            with matmul_precision(None):
                data = torch.matmul(feats, train.T).cpu().numpy()
            if self.num_digits_ > 2:
                data *= 10 ** (2 - self.num_digits_)
        else:
            data = feats.cpu().numpy()
        self.test_data_ = data

    def _require_test_data(self, method):
        """X=None is only valid when fit() precomputed test similarity
        vectors (num_training_samples with a precomputed-kernel
        estimator)."""
        if getattr(self, "test_data_", None) is None:
            raise ValueError(
                f"{method}(X=None) requires test data prepared "
                "during fit (pass num_training_samples with a "
                "precomputed-kernel SVM), or pass X explicitly")

    def predict(self, X=None):
        """Predict labels; X=None reuses test data prepared during
        fit."""
        if X is not None:
            self._prepare_test_data(X)
        else:
            self._require_test_data("predict")
        return self.clf.predict(self.test_data_)

    def _is_equal_to_test_raw_data(self, X):
        if self.test_raw_data_ is None or \
                len(X) != len(self.test_raw_data_):
            return False
        for new, old in zip(X, self.test_raw_data_):
            if not np.array_equal(new[0], old[0]) or \
                    not np.array_equal(new[1], old[1]):
                return False
        return True

    def decision_function(self, X=None):
        """Decision values; X=None reuses test data prepared during
        fit, and X equal to the last test data reuses its features."""
        if X is not None and not self._is_equal_to_test_raw_data(X):
            self._prepare_test_data(X)
        elif X is None:
            self._require_test_data("decision_function")
        return self.clf.decision_function(self.test_data_)

    def score(self, X, y, sample_weight=None):
        """Mean accuracy (weighted by ``sample_weight``); X is ignored
        when the Gram was computed by K4 and test similarity vectors
        were prepared in fit."""
        if self._is_precomputed() and self.training_data_ is None:
            return _accuracy(y, self.predict(), sample_weight)
        return _accuracy(y, self.predict(X), sample_weight)
