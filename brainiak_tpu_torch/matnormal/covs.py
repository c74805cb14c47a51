"""Noise covariance strategy classes.

PyTorch counterpart of ``brainiak_tpu/matnormal/covs.py``.  Each class
is a stateless description whose learnable parameters live in a dict
of tensors: ``init_params(seed)`` creates it (float64 tensors on the
CPU, drawn from ``np.random.RandomState(seed)`` as the JAX package
draws them, so both packages start from the same numbers; the
estimators move them to their device and dtype), and ``logdet`` /
``solve`` / ``logp`` are functions of it that autograd differentiates.

API: ``init_params(seed) -> dict``; ``solve(params, X) -> Σ⁻¹X``;
``logdet(params)``; ``logp(params)`` (prior, default 0); ``prec`` /
``cov`` for inspection.  ``prec`` and ``cov`` take the dtype and
device of the parameters, or of ``like=`` where there are none
(:class:`CovIdentity`), else the default dtype on the CPU.
"""

import math
from functools import reduce

import numpy as np
import torch
from scipy.special import logit

from ..utils.kronecker_solvers import (
    kept_indices,
    solve_kept,
    solve_lower_triangular_kron,
    solve_upper_triangular_kron,
)
from .utils import (_leaves, flatten_cholesky_unique, tril_size,
                    unflatten_cholesky_unique)

__all__ = [
    "CovBase",
    "CovIdentity",
    "CovAR1",
    "CovIsotropic",
    "CovDiagonal",
    "CovDiagonalGammaPrior",
    "CovUnconstrainedCholesky",
    "CovUnconstrainedCholeskyWishartReg",
    "CovUnconstrainedInvCholesky",
    "CovKroneckerFactored",
]


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _eye(n, params, like=None):
    ref = next(_leaves(params), like)
    if ref is None:
        return torch.eye(n)
    return torch.eye(n, dtype=ref.dtype, device=ref.device)


class CovBase:
    """Base covariance strategy (reference covs.py:35-87)."""

    def __init__(self, size):
        self.size = size

    def init_params(self, seed=0):
        return {}

    def logdet(self, params):
        raise NotImplementedError

    def solve(self, params, X):
        raise NotImplementedError

    def logp(self, params):
        """Log-prior over the covariance parameters (regularization)."""
        return 0.0

    def prec(self, params, like=None):
        return self.solve(params, _eye(self.size, params, like))

    def cov(self, params, like=None):
        # inv_ex: no host sync for its singularity check
        return torch.linalg.inv_ex(self.prec(params, like))[0]


class CovIdentity(CovBase):
    """Identity covariance (reference covs.py:89-126)."""

    def logdet(self, params):
        return 0.0

    def solve(self, params, X):
        return X

    def prec(self, params, like=None):
        return _eye(self.size, params, like)

    def cov(self, params, like=None):
        return _eye(self.size, params, like)


class CovIsotropic(CovBase):
    """Scaled identity (reference covs.py:234-277)."""

    def __init__(self, size, var=None):
        super().__init__(size)
        self._var0 = var

    def init_params(self, seed=0):
        if self._var0 is None:
            rng = np.random.RandomState(seed)
            return {"log_var": _t(rng.standard_normal(1))}
        return {"log_var": _t([np.log(self._var0)])}

    def logdet(self, params):
        return self.size * params["log_var"][0]

    def solve(self, params, X):
        return X / torch.exp(params["log_var"][0])


class CovDiagonal(CovBase):
    """Independent per-element variances (reference covs.py:279-325)."""

    def __init__(self, size, diag_var=None):
        super().__init__(size)
        self._diag_var0 = diag_var

    def init_params(self, seed=0):
        if self._diag_var0 is None:
            rng = np.random.RandomState(seed)
            return {"logprec": _t(rng.standard_normal(self.size))}
        return {"logprec": _t(np.log(1.0 / np.asarray(self._diag_var0)))}

    def logdet(self, params):
        return -torch.sum(params["logprec"])

    def solve(self, params, X):
        return torch.exp(params["logprec"])[:, None] * X


class CovDiagonalGammaPrior(CovDiagonal):
    """Diagonal covariance with an inverse-gamma prior on the precisions
    (reference covs.py:327-341)."""

    def __init__(self, size, sigma=None, alpha=1.5, beta=1e-10):
        super().__init__(size, sigma)
        self.alpha = alpha
        self.beta = beta

    def logp(self, params):
        x = torch.exp(params["logprec"])
        a, b = self.alpha, self.beta
        # InverseGamma(a, b) log-density summed over elements
        return torch.sum(a * math.log(b) - math.lgamma(a)
                         - (a + 1) * torch.log(x) - b / x)


class CovAR1(CovBase):
    """AR(1) covariance with optional scan-onset blocks
    (reference covs.py:127-229): precision
    (I − ρD + ρ²F)/σ² built from dense Toeplitz templates, kept on the
    host and copied once to each dtype and device they are used in."""

    def __init__(self, size, rho=None, sigma=None, scan_onsets=None):
        super().__init__(size)
        if scan_onsets is None:
            self.run_sizes = [size]
        else:
            self.run_sizes = list(np.ediff1d(np.r_[scan_onsets, size]))
        off = np.zeros((size, size))
        diag = np.zeros((size, size))
        start = 0
        for r in self.run_sizes:
            for i in range(r - 1):
                off[start + i, start + i + 1] = 1
                off[start + i + 1, start + i] = 1
            inner = np.zeros(r)
            if r > 2:
                inner[1:-1] = 1
            diag[start:start + r, start:start + r] = np.diag(inner)
            start += r
        self.offdiag_template = off
        self.diag_template = diag
        self._rho0 = rho
        self._sigma0 = sigma
        self._placed = {}

    def init_params(self, seed=0):
        rng = np.random.RandomState(seed)
        log_sigma = (rng.standard_normal(1) if self._sigma0 is None
                     else np.log(np.atleast_1d(self._sigma0)))
        rho_unc = (rng.standard_normal(1) if self._rho0 is None
                   else np.atleast_1d(logit(self._rho0 / 2 + 0.5)))
        return {"log_sigma": _t(log_sigma), "rho_unc": _t(rho_unc)}

    def _templates(self, ref):
        """(I, D, F, run sizes) in ``ref``'s dtype on its device."""
        key = (ref.dtype, ref.device)
        if key not in self._placed:
            self._placed[key] = tuple(
                torch.as_tensor(m, dtype=ref.dtype, device=ref.device)
                for m in (np.eye(self.size), self.offdiag_template,
                          self.diag_template, self.run_sizes))
        return self._placed[key]

    def _rho_sigma(self, params):
        rho = 2 * torch.sigmoid(params["rho_unc"][0]) - 1
        return rho, torch.exp(params["log_sigma"][0])

    def logdet(self, params):
        rho, _ = self._rho_sigma(params)
        run_sizes = self._templates(rho)[3]
        return torch.sum(2 * run_sizes * params["log_sigma"][0]
                         - torch.log(1 - rho ** 2))

    def prec(self, params, like=None):
        rho, sigma = self._rho_sigma(params)
        eye, off, diag, _ = self._templates(rho)
        return (eye - rho * off + rho ** 2 * diag) / sigma ** 2

    def solve(self, params, X):
        return self.prec(params) @ X


class CovUnconstrainedCholesky(CovBase):
    """Unconstrained covariance via its Cholesky factor
    (reference covs.py:343-404)."""

    def __init__(self, size=None, Sigma=None):
        if (size is None) == (Sigma is None):
            raise RuntimeError("Must pass either Sigma or size but not "
                               "both")
        if Sigma is not None:
            size = Sigma.shape[0]
        super().__init__(size)
        self._Sigma0 = Sigma

    def init_params(self, seed=0):
        if self._Sigma0 is None:
            rng = np.random.RandomState(seed)
            flat = rng.standard_normal(tril_size(self.size))
        else:
            flat = flatten_cholesky_unique(np.linalg.cholesky(self._Sigma0))
        return {"L_flat": _t(flat)}

    def L(self, params):
        return unflatten_cholesky_unique(params["L_flat"], self.size)

    def logdet(self, params):
        return 2 * torch.sum(torch.log(torch.diagonal(self.L(params))))

    def solve(self, params, X):
        X2 = X if X.dim() == 2 else X[:, None]
        out = torch.cholesky_solve(X2, self.L(params), upper=False)
        return out if X.dim() == 2 else out[:, 0]


class CovUnconstrainedCholeskyWishartReg(CovUnconstrainedCholesky):
    """Cholesky-parameterized covariance with the weakly-informative
    Wishart regularization of Chung et al. 2015
    (reference covs.py:406-429)."""

    def __init__(self, size, Sigma=None):
        super().__init__(size=size)
        self.df = size + 2
        self.scale_diag = 1e5

    def logp(self, params):
        # WishartTriL(df, scale=1e5 I).log_prob(Sigma) up to terms constant
        # in Sigma: 0.5*(df - p - 1)*log|Sigma| - 0.5*tr(scale^-2 Sigma)
        L = self.L(params)
        p = self.size
        logdet_sigma = 2 * torch.sum(torch.log(torch.diagonal(L)))
        trace_term = torch.sum(L ** 2) / (self.scale_diag ** 2)
        half_df = 0.5 * (self.df - p - 1)
        return half_df * logdet_sigma - 0.5 * trace_term


class CovUnconstrainedInvCholesky(CovBase):
    """Unconstrained covariance via its precision Cholesky, which saves
    a Cholesky solve a step (reference covs.py:431-497).

    As in the reference, the precision is parameterized as LinvᵀLinv,
    so initializing from ``invSigma`` seeds the optimizer at a
    precision with the same determinant but not elementwise equal to
    ``invSigma`` (reference covs.py:461-466 has the same property)."""

    def __init__(self, size=None, invSigma=None):
        if (size is None) == (invSigma is None):
            raise RuntimeError("Must pass either invSigma or size but not "
                               "both")
        if invSigma is not None:
            size = invSigma.shape[0]
        super().__init__(size)
        self._invSigma0 = invSigma

    def init_params(self, seed=0):
        if self._invSigma0 is None:
            rng = np.random.RandomState(seed)
            flat = rng.standard_normal(tril_size(self.size))
        else:
            flat = flatten_cholesky_unique(
                np.linalg.cholesky(self._invSigma0))
        return {"Linv_flat": _t(flat)}

    def Linv(self, params):
        return unflatten_cholesky_unique(params["Linv_flat"], self.size)

    def logdet(self, params):
        return -2 * torch.sum(torch.log(torch.diagonal(self.Linv(params))))

    def solve(self, params, X):
        Linv = self.Linv(params)
        return Linv.T @ (Linv @ X)

    def prec(self, params, like=None):
        Linv = self.Linv(params)
        return Linv.T @ Linv


class CovKroneckerFactored(CovBase):
    """Kronecker-product covariance from per-factor Cholesky factors
    (reference covs.py:499-622); optional element mask (a host boolean
    vector over the ``prod(sizes)`` elements).  With a mask, the kept
    indices and each factor's kept counts are copied once to each
    device they are used on, and a solve forms the dense Kronecker
    factor once for its two triangular solves."""

    def __init__(self, sizes, Sigmas=None, mask=None):
        if not isinstance(sizes, list):
            raise TypeError("sizes is not a list")
        self.sizes = sizes
        self.nfactors = len(sizes)
        super().__init__(int(np.prod(sizes)))
        self._Sigmas0 = Sigmas
        self.mask = None if mask is None else np.asarray(mask)
        self._placed = {}

    def init_params(self, seed=0):
        rng = np.random.RandomState(seed)
        flats = []
        for i, n in enumerate(self.sizes):
            if self._Sigmas0 is None:
                flats.append(_t(rng.standard_normal(tril_size(n))))
            else:
                flats.append(_t(flatten_cholesky_unique(
                    np.linalg.cholesky(self._Sigmas0[i]))))
        return {"L_flats": flats}

    def L(self, params):
        return [unflatten_cholesky_unique(f, n)
                for f, n in zip(params["L_flats"], self.sizes)]

    def logdet(self, params):
        Ls = self.L(params)
        if self.mask is None:
            n_prod = float(np.prod(self.sizes))
            total = 0.0
            for L, n in zip(Ls, self.sizes):
                total = total + torch.sum(
                    torch.log(torch.diagonal(L))) * (n_prod / n)
            return 2.0 * total
        counts = self._masked(Ls[0])[1]
        total = 0.0
        for L, c in zip(Ls, counts):
            total = total + torch.sum(torch.log(torch.diagonal(L)) * c)
        return 2.0 * total

    def _masked(self, ref):
        """(kept indices, each factor's kept counts) on ``ref``'s
        device, the counts in its dtype."""
        key = (ref.dtype, ref.device)
        if key not in self._placed:
            mask_reshaped = self.mask.reshape(self.sizes)
            self._placed[key] = (kept_indices(self.mask, ref.device), [
                torch.as_tensor(mask_reshaped.sum(tuple(
                    j for j in range(self.nfactors) if j != i)),
                    dtype=ref.dtype, device=ref.device)
                for i in range(self.nfactors)])
        return self._placed[key]

    def solve(self, params, X):
        Ls = self.L(params)
        if self.mask is None:
            z = solve_lower_triangular_kron(Ls, X)
            return solve_upper_triangular_kron(Ls, z)
        dense = reduce(torch.kron, Ls)
        idx = self._masked(dense)[0]
        z = solve_kept(dense, X, idx)
        return solve_kept(dense, z, idx, adjoint=True)
