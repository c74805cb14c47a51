"""Semi-Supervised Shared Response Model (SS-SRM), the port's.

PyTorch counterpart of ``brainiak_tpu.funcalign.sssrm``.  The model
jointly fits functional alignment and a multinomial logistic-regression
(MLR) classifier in shared space:

    min  (1−α)·Loss_SRM(W, S; X) + (α/γ)·Loss_MLR(θ, b; WᵀZ, y) + ½‖θ‖²
    s.t. WᵢᵀWᵢ = I

by block-coordinate descent over W (each subject's on the Stiefel
manifold, :func:`~brainiak_tpu_torch.ops.optimize.stiefel_minimize`),
S (closed form) and (θ, b) (the convex MLR,
:func:`~brainiak_tpu_torch.ops.optimize.minimize_lbfgs`).  The data are
uploaded once and the BCD state stays on the device; the fitted
attributes are numpy, and ``transform`` / ``predict`` run on the host
as the JAX package's do.  No hand-written kernel: the JAX package runs
all of it as XLA ops.

The port depends on no sklearn: :func:`unique_labels` keeps sklearn's
contract for the 1-D label arrays SS-SRM takes.
"""

import logging

import numpy as np
import torch

from ..device import resolve_device
from ..ops.optimize import minimize_lbfgs, stiefel_minimize
from ..utils.utils import concatenate_not_none
from .srm import NotFittedError, _assert_all_finite, _Estimator, _host

__all__ = ["SSSRM", "unique_labels"]

logger = logging.getLogger(__name__)


def unique_labels(*ys):
    """The sorted unique labels of 1-D label arrays, with sklearn's
    checks: float labels that are not whole numbers are of an unknown
    label type (NaN is refused), labels that do not sort (strings and
    numbers in one object array) raise ``TypeError`` as NumPy's sort
    does, and strings and numbers across arrays do not mix."""
    labels = set()
    for y in ys:
        y = np.asarray(y)
        if y.ndim != 1:
            raise ValueError("Unknown label type: labels must be a 1-D "
                             "array, got shape {}".format(y.shape))
        with np.errstate(invalid="ignore"):
            continuous = y.dtype.kind == "f" and np.any(y != y.astype(int))
        if continuous:
            _assert_all_finite(y)
            raise ValueError("Unknown label type: continuous")
        if y.dtype == object and y.size and not isinstance(y.flat[0], str):
            np.unique(y)
            raise ValueError("Unknown label type: unknown")
        labels.update(np.unique(y).tolist())
    if len({isinstance(label, str) for label in labels}) > 1:
        raise ValueError("Mix of label input types (string and number)")
    return np.asarray(sorted(labels))


def _picked_log_softmax(logits, labels):
    return torch.gather(torch.log_softmax(logits, dim=1), 1,
                        labels[:, None])[:, 0]


def _fit_mlr(shared_data, labels, weights, alpha_gamma, n_classes,
             max_iters=200):
    """Weighted multinomial logistic regression (θ, b) update: minimize
    -(α/γ)·Σ log softmax(xθ + b)[y] / weight + ½‖θ‖² from zeros (the
    loss is invariant to a constant added to every bias; from zero the
    iterates keep the biases' sum at zero, which makes the optimum
    unique)."""
    features = shared_data.shape[1]
    n_theta = features * n_classes

    def loss(params):
        theta = params[:n_theta].reshape(features, n_classes)
        logits = shared_data @ theta + params[n_theta:][None, :]
        return (-alpha_gamma * torch.sum(
            _picked_log_softmax(logits, labels) / weights)
            + 0.5 * torch.sum(theta ** 2))

    x0 = torch.zeros(n_theta + n_classes, dtype=shared_data.dtype,
                     device=shared_data.device)
    x, _ = minimize_lbfgs(loss, x0, max_iters=max_iters)
    return x[:n_theta].reshape(features, n_classes), x[n_theta:]


def _fit_w_subject(x_align, x_sup, labels, w0, s, theta, bias, const_align,
                   const_sup, max_iters=30):
    """Stiefel-manifold W update of one subject with labelled data."""

    def cost(w):
        f1 = const_align * torch.sum((x_align - w @ s) ** 2)
        logits = (theta.T @ (w.T @ x_sup)).T + bias[None, :]
        return f1 + const_sup * torch.sum(
            _picked_log_softmax(logits, labels))

    return stiefel_minimize(cost, w0, max_iters=max_iters)


def _fit_w_subject_unsup(x_align, w0, s, const_align, max_iters=30):
    """Stiefel-manifold W update of one subject without labels."""

    def cost(w):
        return const_align * torch.sum((x_align - w @ s) ** 2)

    return stiefel_minimize(cost, w0, max_iters=max_iters)


class SSSRM(_Estimator):
    """Semi-Supervised SRM.

    Parameters
    ----------
    n_iter : int, default 10
        Block-coordinate descent iterations.
    features : int, default 50
        Shared-space dimensionality K.
    gamma : float, default 1.0
        Scale of the MLR loss.
    alpha : float in (0, 1), default 0.5
        Mix of the supervised and the alignment losses.
    rand_seed : int, default 0
        Seed of the initial maps (``np.random.RandomState`` and a NumPy
        QR, so the JAX package starts from the same W).
    device : str or torch.device, default "cuda"
        Where the fit runs (raises without a card unless ``"cpu"``).

    Attributes after fit (numpy): ``w_``, ``s_``, ``theta_``,
    ``bias_``, ``classes_``.
    """

    _param_names = ("n_iter", "features", "gamma", "alpha", "rand_seed",
                    "device")

    def __init__(self, n_iter=10, features=50, gamma=1.0, alpha=0.5,
                 rand_seed=0, device="cuda"):
        self.n_iter = n_iter
        self.features = features
        self.gamma = gamma
        self.alpha = alpha
        self.rand_seed = rand_seed
        self.device = device

    def fit(self, X, y, Z):
        """Fit from alignment data X (a list of [voxels_i, TRs]),
        labels y and labelled data Z (lists; an entry of y and Z may be
        ``None``), in float32 on the device."""
        return self._fit(X, y, Z, torch.float32)

    def _fit(self, X, y, Z, dtype):
        logger.info('Starting SS-SRM')
        if not 0.0 < self.alpha < 1.0:
            raise ValueError("Alpha parameter should be in range (0.0, "
                             "1.0)")
        if self.gamma <= 0.0:
            raise ValueError("Gamma parameter should be positive.")
        if len(X) <= 1 or len(y) <= 1 or len(Z) <= 1:
            raise ValueError("There are not enough subjects in the input "
                             "data to train the model.")
        if len(X) != len(y) or len(X) != len(Z):
            raise ValueError("Different number of subjects in data.")
        if X[0].shape[1] < self.features:
            raise ValueError(
                "There are not enough samples to train the model with "
                "{0:d} features.".format(self.features))
        number_trs = X[0].shape[1]
        for subject in range(len(X)):
            _assert_all_finite(X[subject])
            if X[subject].shape[1] != number_trs:
                raise ValueError("Different number of alignment samples "
                                 "between subjects.")
            if Z[subject] is not None:
                _assert_all_finite(Z[subject])
                if X[subject].shape[0] != Z[subject].shape[0]:
                    raise ValueError(
                        "Different number of voxels between alignment and "
                        "classification data (subject {0:d})."
                        .format(subject))
                if Z[subject].shape[1] != y[subject].size:
                    raise ValueError(
                        "Different number of samples and labels in subject "
                        "{0:d}.".format(subject))
        dev = resolve_device(self.device)
        new_y = self._init_classes(y)
        w, s, theta, bias = self._sssrm(X, Z, new_y, dtype, dev)
        self.w_ = [_host(wi) for wi in w]
        self.s_ = _host(s)
        self.theta_ = _host(theta)
        self.bias_ = _host(bias)
        return self

    def _init_classes(self, y):
        """Map labels to [0, C)."""
        self.classes_ = unique_labels(concatenate_not_none(y))
        return [np.digitize(yi, self.classes_) - 1 if yi is not None
                else None for yi in y]

    def _init_w(self, data_align, dtype, dev):
        """The initial maps: NumPy QR factors of uniform draws of
        ``np.random.RandomState(rand_seed)``, one subject after
        another, on ``dev``."""
        rng = np.random.RandomState(self.rand_seed)
        w = []
        for x in data_align:
            q, _ = np.linalg.qr(rng.random_sample((x.shape[0],
                                                   self.features)))
            w.append(torch.tensor(q, dtype=dtype, device=dev))
        return w

    def _sssrm(self, data_align, data_sup, labels, dtype, dev):
        """The BCD loop on ``dev`` in ``dtype``: the data uploaded once,
        returns ``(w, s, theta, bias)`` as tensors."""
        n_classes = self.classes_.size

        def up(a):
            return None if a is None else torch.tensor(
                np.asarray(a), dtype=dtype, device=dev)

        x = [up(a) for a in data_align]
        z = [up(a) for a in data_sup]
        yl = [None if a is None else torch.tensor(a, dtype=torch.long,
                                                  device=dev)
              for a in labels]
        w = self._init_w(data_align, dtype, dev)
        s = self._compute_shared_response(x, w)
        theta, bias = self._update_classifier(z, yl, w, n_classes)
        for iteration in range(self.n_iter):
            logger.info('Iteration %d', iteration + 1)
            w = self._update_w(x, z, yl, w, s, theta, bias)
            s = self._compute_shared_response(x, w)
            theta, bias = self._update_classifier(z, yl, w, n_classes)
        return w, s, theta, bias

    @staticmethod
    def _compute_shared_response(data, w):
        """S = mean_i Wᵢᵀ Xᵢ."""
        s = None
        for wi, xi in zip(w, data):
            part = wi.T @ xi
            s = part if s is None else s + part
        return s / len(w)

    def _update_classifier(self, data, labels, w, n_classes):
        data_stacked, labels_stacked, weights = self._stack_list(
            data, labels, w)
        return _fit_mlr(data_stacked, labels_stacked, weights,
                        self.alpha / self.gamma, n_classes)

    def _update_w(self, data_align, data_sup, labels, w, s, theta, bias):
        new_w = []
        for subject in range(len(data_align)):
            const_align = (1 - self.alpha) * 0.5 / \
                data_align[subject].shape[1]
            if data_sup[subject] is not None:
                const_sup = -self.alpha / self.gamma / \
                    data_sup[subject].shape[1]
                wi, _ = _fit_w_subject(
                    data_align[subject], data_sup[subject], labels[subject],
                    w[subject], s, theta, bias, const_align, const_sup)
            else:
                wi, _ = _fit_w_subject_unsup(data_align[subject],
                                             w[subject], s, const_align)
            new_w.append(wi)
        return new_w

    @staticmethod
    def _stack_list(data, data_labels, w):
        """Stack the subjects' shared-space samples [N, K], labels and
        per-sample weights (each subject's sample count) on the
        device."""
        shared, labels, weights = [], [], []
        for zi, yi, wi in zip(data, data_labels, w):
            if zi is not None:
                shared.append(wi.T @ zi)
                labels.append(yi)
                weights.append(torch.full((zi.shape[1],), zi.shape[1],
                                          dtype=zi.dtype,
                                          device=zi.device))
        return (torch.cat(shared, dim=1).T, torch.cat(labels),
                torch.cat(weights))

    # -- inference --------------------------------------------------------
    def _check_fitted(self, X):
        if not hasattr(self, 'w_'):
            raise NotFittedError("The model fit has not been run yet.")
        if len(X) != len(self.w_):
            raise ValueError("The number of subjects does not match the "
                             "one in the model.")

    def transform(self, X, y=None):
        """Project into shared space: sᵢ = Wᵢᵀ Xᵢ (numpy, on the
        host)."""
        self._check_fitted(X)
        return [None if x is None else self.w_[i].T @ x
                for i, x in enumerate(X)]

    def predict(self, X):
        """MLR prediction in shared space (numpy, on the host)."""
        self._check_fitted(X)
        preds = [None] * len(X)
        for i, x in enumerate(X):
            if x is not None:
                logits = (self.theta_.T @ (self.w_[i].T @ x)).T + \
                    self.bias_[None, :]
                preds[i] = self.classes_[np.argmax(logits, axis=1)]
        return preds

    def score(self, X, y, sample_weight=None):
        """Mean accuracy of :meth:`predict` over the samples of every
        subject whose data is not ``None``."""
        preds = self.predict(X)
        got = concatenate_not_none(preds)
        want = concatenate_not_none([yi for xi, yi in zip(X, y)
                                     if xi is not None])
        return float(np.average(got == want, weights=sample_weight))
