"""Matrix-normal regression on a CUDA device.

PyTorch counterpart of ``brainiak_tpu/matnormal/regression.py``:
Y ~ MN(Xβ, Σ_t, Σ_s), fit by maximum likelihood over β and the
covariance parameters, one L-BFGS over the flat parameter vector
(``ravel`` in ``ravel_pytree``'s order).  The L-BFGS is the port's own
(:func:`brainiak_tpu_torch.ops.optimize.minimize_lbfgs`; optax is not
on the card's machine): it reaches the JAX package's optimum, not its
iterates.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..funcalign.srm import NotFittedError, _Estimator
from ..ops.optimize import minimize_lbfgs
from .matnormal_likelihoods import matnorm_logp
from .utils import place, ravel

__all__ = ["MatnormalRegression"]


class MatnormalRegression(_Estimator):
    """MLE regression under matrix-normal noise
    (reference regression.py:15-146).

    Parameters
    ----------
    time_cov, space_cov : CovBase strategy objects
    optimizer / optCtrl : accepted for API compatibility (L-BFGS is used)
    max_iters : L-BFGS iterations at most
    device : str or torch.device, default "cuda" (raises without a
        card); the fit runs in float32 there

    Attributes after fit: ``beta_`` (NumPy, [conditions, voxels]),
    ``time_params_`` / ``space_params_`` (dicts of tensors on the
    device), ``final_loss_``.
    """

    _param_names = ("time_cov", "space_cov", "optMethod", "optCtrl",
                    "max_iters", "device")

    def __init__(self, time_cov, space_cov, optimizer="L-BFGS-B",
                 optCtrl=None, max_iters=300, device="cuda"):
        self.time_cov = time_cov
        self.space_cov = space_cov
        self.optMethod = optimizer
        self.optCtrl = optCtrl or {}
        self.max_iters = max_iters
        self.device = device
        self.n_t = time_cov.size
        self.n_v = space_cov.size

    def logp(self, X, Y, params):
        resid = Y - X @ params["beta"]
        return (matnorm_logp(resid, self.time_cov, params["time"],
                             self.space_cov, params["space"])
                + self.time_cov.logp(params["time"])
                + self.space_cov.logp(params["space"]))

    def fit(self, X, y, naive_init=True):
        """X: [TRs, conditions] design; y: [TRs, voxels] data; fit in
        float32 on the device."""
        return self._fit(X, y, naive_init, torch.float32)

    def _fit(self, X, y, naive_init, dtype):
        dev = resolve_device(self.device)
        X = torch.as_tensor(np.asarray(X), dtype=dtype, device=dev)
        y = torch.as_tensor(np.asarray(y), dtype=dtype, device=dev)
        self.n_c = X.shape[1]

        time_params = place(self.time_cov.init_params(seed=0), dtype, dev)
        space_params = place(self.space_cov.init_params(seed=1), dtype, dev)
        if naive_init:
            sigma_inv_x = self.time_cov.solve(time_params, X)
            sigma_inv_y = self.time_cov.solve(time_params, y)
            beta_init = torch.linalg.solve(X.T @ sigma_inv_x,
                                           X.T @ sigma_inv_y)
        else:
            beta_init = torch.as_tensor(np.random.randn(self.n_c, self.n_v),
                                        dtype=dtype, device=dev)
        flat0, unravel = ravel({"beta": beta_init, "time": time_params,
                                "space": space_params})
        flat, value = minimize_lbfgs(
            lambda flat: -self.logp(X, y, unravel(flat)), flat0,
            max_iters=self.max_iters)
        params = unravel(flat.detach())
        self.beta_ = params["beta"].cpu().numpy()
        self.time_params_ = params["time"]
        self.space_params_ = params["space"]
        self.final_loss_ = float(value)
        return self

    def _beta(self):
        if not hasattr(self, "beta_"):
            raise NotFittedError("The model fit has not been run yet.")
        return torch.tensor(self.beta_, device=resolve_device(self.device))

    def predict(self, X):
        """Predict data given design (reference regression.py:95-113)."""
        beta = self._beta()
        X = torch.as_tensor(np.asarray(X), dtype=beta.dtype,
                            device=beta.device)
        return (X @ beta).cpu().numpy()

    def calibrate(self, Y):
        """Decode the design from new data using the fitted model:
        X̂ = (βΣ_s⁻¹βᵀ)⁻¹ βΣ_s⁻¹Yᵀ (reference regression.py:115-146)."""
        beta = self._beta()
        Y = torch.as_tensor(np.asarray(Y), dtype=beta.dtype,
                            device=beta.device)
        sinv_y = self.space_cov.solve(self.space_params_, Y.T)
        sinv_bt = self.space_cov.solve(self.space_params_, beta.T)
        out = torch.linalg.solve(beta @ sinv_bt, beta @ sinv_y)
        return out.T.cpu().numpy()
