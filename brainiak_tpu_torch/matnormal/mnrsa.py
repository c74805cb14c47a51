"""Matrix-normal RSA (MNRSA) on a CUDA device.

PyTorch counterpart of ``brainiak_tpu/matnormal/mnrsa.py``: learn the
RSA covariance U = LLᵀ of the mapping from design to signal by
marginalizing over the mapping:

    Y ~ MN(0, Σ_t + [XL, X₀][XL, X₀]ᵀ, Σ_s)

The marginal likelihood is a function of a parameter dict, fit by one
L-BFGS (the port's own, as in
:class:`~brainiak_tpu_torch.matnormal.regression.MatnormalRegression`).
The naive initialization's least squares, sklearn's
``LinearRegression(fit_intercept=False)`` in the JAX package, is
``np.linalg.lstsq`` on the host (the same LAPACK driver); its
coefficients [conditions, voxels] give ``naive_U_`` = ``np.cov`` of
them, as the JAX package's ``np.cov(coef_.T)``.  The nuisance ``X_0``
is identified only through ``X_0 X_0ᵀ``.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..funcalign.srm import _Estimator
from ..ops.optimize import minimize_lbfgs
from ..utils.utils import cov2corr
from .covs import CovIdentity
from .matnormal_likelihoods import matnorm_logp_marginal_row
from .utils import (flatten_cholesky_unique, place, ravel, tril_size,
                    unflatten_cholesky_unique)

__all__ = ["MNRSA"]


class MNRSA(_Estimator):
    """Matrix-normal RSA (reference mnrsa.py:21-175).

    Parameters
    ----------
    time_cov, space_cov : CovBase strategy objects
    n_nureg : number of nuisance regressors X₀
    optimizer / optCtrl : accepted for API compatibility
    max_iters : L-BFGS iterations at most
    device : str or torch.device, default "cuda" (raises without a
        card); the fit runs in float32 there

    Attributes after fit: ``U_`` (RSA covariance), ``C_`` (correlation),
    ``L_`` (Cholesky factor), ``X_0_``, ``final_loss_``, and
    ``naive_U_`` after a naive initialization.
    """

    _param_names = ("time_cov", "space_cov", "n_nureg", "optMethod",
                    "optCtrl", "max_iters", "device")

    def __init__(self, time_cov, space_cov, n_nureg=5,
                 optimizer="L-BFGS-B", optCtrl=None, max_iters=300,
                 device="cuda"):
        self.n_T = time_cov.size
        self.n_V = space_cov.size
        self.n_nureg = n_nureg
        self.optMethod = optimizer
        self.optCtrl = optCtrl or {}
        self.max_iters = max_iters
        self.time_cov = time_cov
        self.space_cov = space_cov
        self.device = device

    def logp(self, X, Y, params):
        """Marginal MNRSA log-likelihood (reference mnrsa.py:158-175)."""
        n_c = X.shape[1]
        rsa_cov = CovIdentity(size=n_c + self.n_nureg)
        L = unflatten_cholesky_unique(params["L_flat"], n_c)
        x_stack = torch.cat([X @ L, params["X_0"]], dim=1)
        return (self.time_cov.logp(params["time"])
                + self.space_cov.logp(params["space"])
                + matnorm_logp_marginal_row(
                    Y, self.time_cov, params["time"],
                    self.space_cov, params["space"],
                    x_stack, rsa_cov, {}))

    def fit(self, X, y, naive_init=True):
        """X: brain data [TRs, voxels]; y: design [TRs, conditions]
        (sklearn orientation, flipped internally: reference
        mnrsa.py:93-156); fit in float32 on the device."""
        return self._fit(X, y, naive_init, torch.float32)

    def _fit(self, X, y, naive_init, dtype):
        dev = resolve_device(self.device)
        X, Y = np.asarray(y), np.asarray(X)  # generative orientation
        self.n_c = X.shape[1]

        if naive_init:
            coef = np.linalg.lstsq(X, Y, rcond=None)[0]
            self.naive_U_ = np.cov(coef)
            L_flat0 = flatten_cholesky_unique(
                np.linalg.cholesky(self.naive_U_
                                   + 1e-8 * np.eye(self.n_c)))
        else:
            rng = np.random.RandomState(0)
            L_flat0 = rng.standard_normal(tril_size(self.n_c))

        rng = np.random.RandomState(1)
        params0 = place({
            "L_flat": L_flat0,
            "X_0": rng.standard_normal((self.n_T, self.n_nureg)),
            "time": self.time_cov.init_params(seed=2),
            "space": self.space_cov.init_params(seed=3),
        }, dtype, dev)
        flat0, unravel = ravel(params0)
        X_t = torch.as_tensor(X, dtype=dtype, device=dev)
        Y_t = torch.as_tensor(Y, dtype=dtype, device=dev)
        flat, value = minimize_lbfgs(
            lambda flat: -self.logp(X_t, Y_t, unravel(flat)), flat0,
            max_iters=self.max_iters)
        params = unravel(flat.detach())
        L = unflatten_cholesky_unique(params["L_flat"],
                                      self.n_c).cpu().numpy()
        self.L_ = L
        self.U_ = L @ L.T
        self.C_ = cov2corr(self.U_)
        self.X_0_ = params["X_0"].cpu().numpy()
        self.time_params_ = params["time"]
        self.space_params_ = params["space"]
        self.final_loss_ = float(value)
        return self
