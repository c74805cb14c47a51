"""brainiak_tpu_torch.ops.svm against the JAX package on the CPU.

Tolerances: SMO alphas and bias atol 1e-5 on well-conditioned kernels
(f32); CV accuracies equal on identical kernels for the golden fixture,
and elsewhere equal on >= 95% of voxels and never off by more than one
test sample per fold (near-boundary samples flip with rounding).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.random import RandomState
from scipy.stats.mstats import zscore
from sklearn import model_selection, svm

from brainiak_tpu.ops import svm as jsvm
from brainiak_tpu_torch.ops import svm as tsvm


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _kernels(seed, b, n, d=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, d).astype(np.float32)
    return np.einsum('bnd,bmd->bnm', x, x).astype(np.float32)


def _labels(n, n_classes=2):
    return np.arange(n) % n_classes


@pytest.mark.parametrize("fit", ["svm_fit_dual", "svm_fit_dual_ipm"])
def test_fit_dual_matches_jax(fit):
    k = _kernels(0, 1, 12)[0] + 0.5 * np.eye(12, dtype=np.float32)
    y = np.where(_labels(12) == 0, 1.0, -1.0).astype(np.float32)
    box = np.ones(12, np.float32)
    box[[2, 7]] = 0.0  # excluded samples
    want = getattr(jsvm, fit)(jnp.asarray(k), jnp.asarray(y),
                              jnp.asarray(box), n_iters=40)
    got = getattr(tsvm, fit)(torch.from_numpy(k), torch.from_numpy(y),
                             torch.from_numpy(box), n_iters=40)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-5)
    assert float(got[2]) < 1e-3 and float(want[2]) < 1e-3
    assert np.all(got[0].numpy()[[2, 7]] == 0)


def test_fit_dual_batched_and_decision():
    ks = _kernels(1, 3, 10) + 0.5 * np.eye(10, dtype=np.float32)
    y = np.where(_labels(10) == 0, 1.0, -1.0).astype(np.float32)
    box = np.ones(10, np.float32)
    alpha, bias, gap = tsvm.svm_fit_dual(torch.from_numpy(ks),
                                         torch.from_numpy(y),
                                         torch.from_numpy(box), n_iters=30)
    assert alpha.shape == (3, 10) and bias.shape == (3,)
    for b in range(3):
        a1, b1, _ = tsvm.svm_fit_dual(torch.from_numpy(ks[b]),
                                      torch.from_numpy(y),
                                      torch.from_numpy(box), n_iters=30)
        np.testing.assert_allclose(alpha[b].numpy(), a1.numpy(), atol=1e-6)
        dec = tsvm.svm_decision(torch.from_numpy(ks[b]), a1,
                                torch.from_numpy(y), b1)
        want = jsvm.svm_decision(jnp.asarray(ks[b]), jnp.asarray(a1.numpy()),
                                 jnp.asarray(y), float(b1))
        np.testing.assert_allclose(dec.numpy(), np.asarray(want),
                                   atol=1e-5)


def test_fit_dual_matches_sklearn_svc():
    k = (_kernels(2, 1, 16)[0] / 6.0).astype(np.float64)
    labels = _labels(16)
    y = np.where(labels == 0, 1.0, -1.0)
    alpha, bias, _ = tsvm.svm_fit_dual(torch.from_numpy(k),
                                       torch.from_numpy(y),
                                       torch.ones(16, dtype=torch.float64),
                                       n_iters=200)
    clf = svm.SVC(kernel='precomputed', C=1.0, tol=1e-8).fit(k, labels)
    dec = tsvm.svm_decision(torch.from_numpy(k), alpha,
                            torch.from_numpy(y), bias).numpy()
    # sklearn's positive class is the later label (1 -> y = -1 here)
    np.testing.assert_allclose(dec, -clf.decision_function(k), atol=1e-4)


@pytest.mark.parametrize("n,n_splits,n_classes", [
    (8, 2, 2), (12, 4, 2), (13, 3, 3), (20, 5, 4), (9, 3, 2)])
def test_stratified_kfold_matches_sklearn(n, n_splits, n_classes):
    rng = np.random.RandomState(n)
    labels = rng.permutation(_labels(n, n_classes))
    got = list(tsvm.stratified_kfold(labels, n_splits))
    want = list(model_selection.StratifiedKFold(
        n_splits=n_splits, shuffle=False).split(np.zeros(n), labels))
    assert len(got) == len(want)
    for (gtr, gte), (wtr, wte) in zip(got, want):
        np.testing.assert_array_equal(gtr, wtr)
        np.testing.assert_array_equal(gte, wte)


def test_stratified_kfold_refuses():
    with pytest.raises(ValueError, match="greater than the number"):
        list(tsvm.stratified_kfold([0, 1, 0], 4))
    with pytest.raises(ValueError, match="members in each class"):
        list(tsvm.stratified_kfold([0, 1, 0, 1, 2, 2], 4))


def _create_epoch(prng, col=5):
    mat = prng.rand(12, col).astype(np.float32)
    mat = np.nan_to_num(zscore(mat, axis=0, ddof=0))
    return mat / math.sqrt(mat.shape[0])


def _golden_kernels():
    """The JAX package's Grams of the reference golden fixture."""
    from brainiak_tpu.fcma.voxelselector import (
        _block_kernel_matrices)
    prng = RandomState(1234567890)
    data = np.stack([_create_epoch(prng) for _ in range(8)])
    kernels, _ = _block_kernel_matrices(jnp.asarray(data),
                                        jnp.asarray(data), 4)
    return np.asarray(kernels)


def test_cv_accuracy_exact_on_golden_kernels():
    """Identical kernels: the port, the JAX package and sklearn agree
    exactly on the golden fixture, within one epoch of its counts."""
    kernels = _golden_kernels()
    labels = [0, 1, 0, 1, 0, 1, 0, 1]
    got = tsvm.svm_cv_accuracy(kernels, labels, 2, C=1.0, n_iters=10,
                               device="cpu")
    want = np.asarray(jsvm.svm_cv_accuracy(jnp.asarray(kernels), labels,
                                           2, C=1.0, n_iters=10))
    np.testing.assert_array_equal(got, want)
    skf = model_selection.StratifiedKFold(n_splits=2, shuffle=False)
    host = [model_selection.cross_val_score(
        svm.SVC(kernel='precomputed', shrinking=False, C=1), k,
        y=labels, cv=skf).mean() for k in kernels.astype(np.float64)]
    np.testing.assert_array_equal(got, host)
    counts = np.round(8 * got).astype(int)
    assert np.allclose(counts, [7, 4, 6, 4, 4], atol=1)


@pytest.mark.parametrize("n_classes,solver", [(2, "smo"), (3, "smo"),
                                              (2, "ipm")])
def test_cv_accuracy_matches_jax(n_classes, solver):
    n, n_folds = 12, 3
    kernels = _kernels(5 + n_classes, 40, n) / 6.0
    labels = _labels(n, n_classes)
    got, gaps = tsvm.svm_cv_accuracy(kernels, labels, n_folds,
                                     n_iters=20, return_gap=True,
                                     solver=solver, device="cpu")
    want, jgaps = jsvm.svm_cv_accuracy(jnp.asarray(kernels), labels,
                                       n_folds, n_iters=20,
                                       return_gap=True, solver=solver)
    want = np.asarray(want)
    assert got.shape == want.shape == (40,)
    assert np.mean(np.isclose(got, want, rtol=0, atol=1e-6)) >= 0.95
    # one test sample of one fold moves the mean by 1/(folds * tests)
    tests_per_fold = n // n_folds
    assert np.max(np.abs(got - want)) <= 1.0 / tests_per_fold + 1e-9
    assert gaps.shape == (40,)
    np.testing.assert_allclose(gaps, np.asarray(jgaps), atol=1e-3)


def test_cv_accuracy_chunks_agree(monkeypatch):
    kernels = _kernels(9, 10, 8) / 6.0
    labels = _labels(8)
    whole = tsvm.svm_cv_accuracy(kernels, labels, 2, n_iters=10,
                                 device="cpu")
    monkeypatch.setattr(tsvm, "_CV_CHUNK_BUDGET_FLOATS", 2 * 2 * 64 * 3)
    chunked = tsvm.svm_cv_accuracy(kernels, labels, 2, n_iters=10,
                                   device="cpu")
    np.testing.assert_array_equal(whole, chunked)
    with pytest.raises(ValueError, match="two classes"):
        tsvm.svm_cv_accuracy(kernels, np.zeros(8), 2, device="cpu")
