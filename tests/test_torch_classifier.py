"""FCMA stage 2 of brainiak_tpu_torch (``fcma.classifier``,
``fcma.util``, ``convert.classifier_from_jax``) against the JAX
package on the CPU.

Inputs follow the JAX package's own fixtures
(tests/fcma/test_classification.py): z-scored random epochs, the even
ones sorted in time.  Tolerances:

* decision values within 5e-3 (the JAX package's own parity figure)
  and predictions equal, wherever no feature sits at the Fisher-z
  clamp: two-region samples (disjoint voxels, no r near 1) and raw
  features (``epochs_per_subj=0``);
* two-region samples: test similarities within 1e-4 of the shrunk
  Gram's K[0, 0];
* self-pair samples ``zip(data, data)`` with normalized features hold
  r = 1 for every voxel with itself, where the clamped Fisher-z flips
  between about 4.95 and 8.66 on the last ulp of r (the two packages'
  matmuls round it differently) and the z-score spreads the difference
  over the sample group.  There the features agree to 1e-4 outside the
  sample groups that hold an |r| > 0.999 (the clamp-confinement rule
  of the kernels' tests), predictions are equal, and decision values
  are within CLAMP_ATOL (an SVC on the Gram; 4.2e-2 seen) or
  LR_CLAMP_ATOL (a logistic regression on the features themselves,
  decision values of about +-4; 0.13 seen).  The witness that the
  clamp is the cause: on self pairs whose every r is exact in f32 in
  any summation order (``_exact_epochs``), r = 1 rounds alike in both
  packages, and the features agree everywhere and decision values to
  5e-3.
"""

import logging
import math

import numpy as np
import pytest
import torch
from numpy.random import RandomState
from scipy.stats.mstats import zscore
from sklearn import svm
from sklearn.linear_model import LogisticRegression

from brainiak_tpu.fcma.classifier import Classifier as JaxClassifier
from brainiak_tpu.fcma.util import compute_correlation as jax_corr
from brainiak_tpu_torch.convert import classifier_from_jax
from brainiak_tpu_torch.fcma import Classifier
from brainiak_tpu_torch.fcma.util import compute_correlation
from brainiak_tpu_torch.ops.fcma_kernels import fcma_sample_gram

DECISION_ATOL = 5e-3
CLAMP_ATOL = 5e-2
LR_CLAMP_ATOL = 0.2
LABELS = [0, 1] * 10


def _epochs(n, n_voxels, seed=1234567890):
    """The JAX package's fixture recipe, with a generator of its own."""
    prng = RandomState(seed)
    out = []
    for idx in range(n):
        mat = prng.rand(12, n_voxels).astype(np.float32)
        if idx % 2 == 0:
            mat = np.sort(mat, axis=0)
        mat = np.nan_to_num(zscore(mat, axis=0, ddof=0))
        out.append(mat / math.sqrt(mat.shape[0]))
    return out


def _exact_epochs(n, n_voxels, seed=0):
    """Normalized epochs of 16 TRs whose every entry is +-1/4, each
    voxel's column balanced (8 of each sign): every product is 1/16,
    so every r is a multiple of 1/8, exact in f32 whatever the order
    of the sum, and a voxel's r with itself is exactly 1."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        cols = [rng.permutation([1.0] * 8 + [-1.0] * 8)
                for _ in range(n_voxels)]
        out.append((np.stack(cols, axis=1) / 4).astype(np.float32))
    return out


def _svc():
    return svm.SVC(kernel='precomputed', shrinking=False, C=1,
                   gamma='auto')


def _pair(make, **kwargs):
    """The same configuration in the JAX package and in the port."""
    return (JaxClassifier(make(), **kwargs),
            Classifier(make(), device="cpu", **kwargs))


def _assert_same_predictions(jax_clf, port, X=None, atol=DECISION_ATOL):
    np.testing.assert_array_equal(port.predict(X), jax_clf.predict(X))
    if atol is not None:
        np.testing.assert_allclose(port.decision_function(X),
                                   jax_clf.decision_function(X),
                                   atol=atol, rtol=0)


def _assert_features_close_off_clamp(got, want, pairs, norm_unit):
    """[N, V1 * V2] features agree to 1e-4 outside the sample groups
    that hold an |r| > 0.999."""
    x1 = np.stack([a for a, _ in pairs]).astype(np.float64)
    x2 = np.stack([b for _, b in pairs]).astype(np.float64)
    near = np.abs(np.einsum('ntb,ntv->nbv', x1, x2)) > 0.999
    near = near.reshape(len(pairs) // norm_unit, norm_unit, -1)
    clean = ~np.broadcast_to(near.any(axis=1, keepdims=True), near.shape)
    clean = clean.reshape(len(pairs), -1)
    assert 0.5 < clean.mean() < 1
    np.testing.assert_allclose(got[clean], want[clean], atol=1e-4)


def _shrunk_k00(x1, x2, norm_unit, num_digits):
    gram = fcma_sample_gram(torch.from_numpy(np.stack(x1)),
                            torch.from_numpy(np.stack(x2)), norm_unit)
    return abs(float(gram[0, 0])) * 10.0 ** min(0, 2 - num_digits)


@pytest.mark.parametrize("epochs_per_subj", [0, 4])
def test_single_portion_self_pairs_match_jax(epochs_per_subj):
    data = _epochs(20, 5)
    jax_clf, port = _pair(_svc, epochs_per_subj=epochs_per_subj)
    train = list(zip(data[:12], data[:12]))
    for clf in (jax_clf, port):
        clf.fit(train, LABELS[:12])
    assert port.num_digits_ == jax_clf.num_digits_
    assert port.num_features_ == jax_clf.num_features_ == 25
    assert port.num_voxels_ == 5 and port.num_samples_ == 12
    test = list(zip(data[12:], data[12:]))
    if epochs_per_subj:
        _assert_features_close_off_clamp(port.training_data_,
                                         jax_clf.training_data_, train,
                                         epochs_per_subj)
        _assert_same_predictions(jax_clf, port, test, atol=CLAMP_ATOL)
    else:
        np.testing.assert_allclose(port.training_data_,
                                   jax_clf.training_data_, atol=1e-6)
        _assert_same_predictions(jax_clf, port, test)
    assert port.score(test, LABELS[12:]) == jax_clf.score(test, LABELS[12:])


@pytest.mark.parametrize("epochs_per_subj", [0, 4])
def test_portioned_self_pairs_match_jax(epochs_per_subj):
    """num_processed_voxels=2 < 5: the port's fit takes K4's plain
    version, the JAX package's its portioned XLA Gram."""
    data = _epochs(20, 5)
    pairs = list(zip(data, data))
    jax_clf, port = _pair(_svc, num_processed_voxels=2,
                          epochs_per_subj=epochs_per_subj)
    for clf in (jax_clf, port):
        clf.fit(pairs, LABELS, num_training_samples=12)
    assert port.training_data_ is None and port.test_raw_data_ is None
    assert port.test_data_.shape == (8, 12)
    assert port.num_digits_ == jax_clf.num_digits_
    _assert_same_predictions(
        jax_clf, port, atol=CLAMP_ATOL if epochs_per_subj else
        DECISION_ATOL)
    weights = np.arange(1, 9)
    assert port.score(None, LABELS[12:], sample_weight=weights) == \
        pytest.approx(jax_clf.score(None, LABELS[12:],
                                    sample_weight=weights))


@pytest.mark.parametrize("epochs_per_subj", [0, 4])
@pytest.mark.parametrize("widths", [(3, 7), (9, 4)])
def test_portioned_two_regions_test_data_match_jax(epochs_per_subj,
                                                   widths):
    """Disjoint regions of either order (the wider becomes region 1):
    test similarities agree to 1e-4 of K[0, 0]."""
    r1, r2 = _epochs(20, widths[0]), _epochs(20, widths[1], seed=7)
    jax_clf, port = _pair(_svc, num_processed_voxels=2,
                          epochs_per_subj=epochs_per_subj)
    for clf in (jax_clf, port):
        clf.fit(list(zip(r1, r2)), LABELS, num_training_samples=12)
    assert port.num_voxels_ == max(widths)
    assert port.num_digits_ == jax_clf.num_digits_
    k00 = _shrunk_k00(r1, r2, epochs_per_subj, port.num_digits_)
    assert np.all(np.abs(port.test_data_ - jax_clf.test_data_)
                  <= 1e-4 * k00)
    _assert_same_predictions(jax_clf, port)


def test_asymmetric_regions_match_jax_in_both_orders():
    small, large = _epochs(20, 3), _epochs(20, 7, seed=11)
    preds = []
    for a, b in ((small, large), (large, small)):
        jax_clf, port = _pair(_svc, epochs_per_subj=4)
        for clf in (jax_clf, port):
            clf.fit(list(zip(a[:12], b[:12])), LABELS[:12])
        assert port.num_features_ == jax_clf.num_features_ == 21
        test = list(zip(a[12:], b[12:]))
        _assert_same_predictions(jax_clf, port, test)
        preds.append(port.predict(test))
    np.testing.assert_array_equal(preds[0], preds[1])


@pytest.mark.parametrize("self_pairs", [True, False])
def test_logistic_regression_features_match_jax(self_pairs):
    """A classifier without a precomputed kernel gets the features."""
    data = _epochs(20, 5)
    other = data if self_pairs else _epochs(20, 4, seed=3)
    jax_clf, port = _pair(LogisticRegression, epochs_per_subj=4)
    for clf in (jax_clf, port):
        clf.fit(list(zip(data[:12], other[:12])), LABELS[:12])
    assert port.training_data_ is None
    test = list(zip(data[12:], other[12:]))
    _assert_same_predictions(jax_clf, port, test,
                             atol=LR_CLAMP_ATOL if self_pairs else
                             DECISION_ATOL)
    assert port.test_data_.shape == (8, 5 * (5 if self_pairs else 4))
    if self_pairs:
        _assert_features_close_off_clamp(port.test_data_,
                                         jax_clf.test_data_, test, 8)


@pytest.mark.parametrize("make,kwargs", [
    (_svc, {}), (_svc, {"num_processed_voxels": 2}),
    (LogisticRegression, {})], ids=["svc", "svc-portioned", "logistic"])
def test_self_pairs_match_jax_where_r_is_exact(make, kwargs):
    """Self pairs whose r = 1 is exact in both packages: the clamp
    takes the same branch in both, the features agree everywhere and
    decision values to 5e-3."""
    data = _exact_epochs(20, 5)
    jax_clf, port = _pair(make, epochs_per_subj=4, **kwargs)
    pairs = list(zip(data, data))
    if kwargs:
        for clf in (jax_clf, port):
            clf.fit(pairs, LABELS, num_training_samples=12)
        _assert_same_predictions(jax_clf, port)
        return
    for clf in (jax_clf, port):
        clf.fit(pairs[:12], LABELS[:12])
    if port.training_data_ is not None:
        np.testing.assert_allclose(port.training_data_,
                                   jax_clf.training_data_, atol=1e-5)
    _assert_same_predictions(jax_clf, port, pairs[12:])
    np.testing.assert_allclose(port.test_data_, jax_clf.test_data_,
                               atol=1e-5)


def test_num_training_samples_warning(caplog):
    data = _epochs(12, 5)
    port = Classifier(LogisticRegression(), epochs_per_subj=4,
                      device="cpu")
    with caplog.at_level(logging.WARNING,
                         logger="brainiak_tpu_torch.fcma.classifier"):
        port.fit(list(zip(data, data)), LABELS[:12],
                 num_training_samples=8)
    assert any("num_training_samples" in r.message
               for r in caplog.records)
    assert port.test_data_ is None
    assert len(port.predict(list(zip(data, data)))) == 12


def test_fit_errors():
    data = _epochs(8, 5)
    pairs = list(zip(data, data))
    port = Classifier(_svc(), num_processed_voxels=2, epochs_per_subj=2,
                      device="cpu")
    with pytest.raises(RuntimeError, match="num_training_samples"):
        port.fit(pairs, LABELS[:8])
    with pytest.raises(ValueError, match="training samples"):
        port.fit(pairs, LABELS[:8], num_training_samples=8)
    with pytest.raises(ValueError, match="number of labels"):
        port.fit(pairs, LABELS[:7])
    with pytest.raises(ValueError, match="multiple"):
        Classifier(_svc(), num_processed_voxels=2, epochs_per_subj=3,
                   device="cpu").fit(pairs, LABELS[:8],
                                     num_training_samples=6)


def test_predict_without_prepared_test_data_raises():
    data = _epochs(8, 5)
    port = Classifier(_svc(), epochs_per_subj=2, device="cpu")
    port.fit(list(zip(data, data)), LABELS[:8])
    with pytest.raises(ValueError, match="predict"):
        port.predict()
    with pytest.raises(ValueError, match="decision_function"):
        port.decision_function()
    assert len(port.predict(list(zip(data[:4], data[:4])))) == 4
    with pytest.raises(ValueError, match="number of features"):
        port.predict(list(zip(data[:4], _epochs(4, 3))))


def test_classifier_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Classifier(_svc())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_correlation(np.ones((2, 3)), np.ones((2, 3)))


def test_compute_correlation_matches_jax_and_numpy():
    rng = np.random.RandomState(0)
    a = rng.randn(6, 40)
    b = rng.randn(9, 40)
    b[3] = 2.0
    got = compute_correlation(a, b, device="cpu")
    assert got.dtype == np.float32 and got.shape == (6, 9)
    np.testing.assert_allclose(got, jax_corr(a, b), atol=1e-6)
    want = np.corrcoef(a, b)[:6, 6:]
    want[:, 3] = 0.0
    np.testing.assert_allclose(got, want, atol=1e-5)
    nans = compute_correlation(a, b, return_nans=True, device="cpu")
    assert np.isnan(nans[:, 3]).all()
    with pytest.raises(ValueError, match="2D"):
        compute_correlation(a[0], b, device="cpu")
    with pytest.raises(ValueError, match="Dimension"):
        compute_correlation(a, b[:, :5], device="cpu")


@pytest.mark.parametrize("n_processed,n_train", [(2000, None), (2, 12)])
def test_classifier_from_jax_predicts_the_same(n_processed, n_train):
    """A fit in the JAX package, carried across by its attributes,
    predicts what the JAX classifier predicts (two-region samples)."""
    pairs = list(zip(_epochs(20, 5), _epochs(20, 6, seed=5)))
    jax_clf = JaxClassifier(_svc(), num_processed_voxels=n_processed,
                            epochs_per_subj=4)
    if n_train is None:
        jax_clf.fit(pairs[:12], LABELS[:12])
    else:
        jax_clf.fit(pairs, LABELS, num_training_samples=n_train)
    port = classifier_from_jax(jax_clf, device="cpu")
    assert port.clf is jax_clf.clf
    assert (port.num_digits_, port.num_features_, port.num_samples_) == \
        (jax_clf.num_digits_, jax_clf.num_features_, jax_clf.num_samples_)
    test = pairs[12:] if n_train is None else None
    _assert_same_predictions(jax_clf, port, test)
