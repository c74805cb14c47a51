"""Matrix-normal log-likelihoods.

PyTorch counterpart of ``brainiak_tpu/matnormal/matnormal_likelihoods.py``.
Covariance arguments are (cov_object, params) pairs following the
:class:`~brainiak_tpu_torch.matnormal.covs.CovBase` API.

Two differences from the JAX package, neither of which moves a value
beyond rounding where no covariance has a mask:

- ``tr(Σ_c⁻¹Xᵀ · Σ_r⁻¹X)`` is summed elementwise,
  ``Σ (Σ_c⁻¹Xᵀ) ⊙ (Σ_r⁻¹X)ᵀ``, instead of forming the [cols, cols]
  product whose trace it takes;
- the row and column counts of the density are those a covariance
  sees.  A masked ``CovKroneckerFactored`` zeroes the masked-out
  elements of its solve, so those rows (or
  columns) of ``x`` enter neither the quadratic form nor the
  log-determinant, and the density is that of the observed submatrix.
  The JAX package counts every row and column of ``x``: its density
  then weighs the other side's log-determinant by elements the
  quadratic form never sees, and is unbounded along the scale that the
  two sides trade (``tests/test_torch_matnormal.py``
  ``test_masked_density_counts_observed_columns``).
"""

import numpy as np
import torch

__all__ = [
    "matnorm_logp",
    "matnorm_logp_conditional_col",
    "matnorm_logp_conditional_row",
    "matnorm_logp_marginal_col",
    "matnorm_logp_marginal_row",
    "solve_det_conditional",
    "solve_det_marginal",
]

_LOG2PI = np.log(2.0 * np.pi)


def _observed(cov, n):
    """Rows (of ``n``) that ``cov``'s solve and log-determinant see."""
    mask = getattr(cov, "mask", None)
    return n if mask is None else int(np.count_nonzero(mask))


def _cholesky(a):
    """``a``'s Cholesky factor, NaN where ``a`` is not positive
    definite (as ``jnp.linalg.cholesky`` gives it), with no host sync:
    the L-BFGS line search reads a NaN loss as +inf and steps back."""
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _solve(a, b):
    """``a⁻¹ b`` by LU, without the host sync of ``torch.linalg.solve``'s
    singularity check (a singular ``a`` gives inf or NaN, as in the
    JAX package)."""
    return torch.linalg.solve_ex(a, b)[0]


def _chol_solves(lemma_factor, rhs):
    """``(L Lᵀ)⁻¹ rhs`` by two general solves, as the JAX package
    takes them."""
    return _solve(lemma_factor.T, _solve(lemma_factor, rhs))


def solve_det_marginal(x, sigma, sigma_params, A, Q, Q_params):
    """(Σ + AQAᵀ)⁻¹x by the Woodbury identity and its log-determinant by
    the matrix determinant lemma (reference
    matnormal_likelihoods.py:27-109)."""
    lemma_factor = _cholesky(
        Q.prec(Q_params, like=A) + A.T @ sigma.solve(sigma_params, A))
    logdet = (Q.logdet(Q_params) + sigma.logdet(sigma_params)
              + 2 * torch.sum(torch.log(torch.diagonal(lemma_factor))))
    atrp_sinv = A.T @ sigma.prec(sigma_params, like=A)
    prod_term = _chol_solves(lemma_factor, atrp_sinv)
    eye = torch.eye(sigma.size, dtype=A.dtype, device=A.device)
    solve = sigma.solve(sigma_params, eye - A @ prod_term) @ x
    return solve, logdet


def solve_det_conditional(x, sigma, sigma_params, A, Q, Q_params):
    """(Σ − AQ⁻¹Aᵀ)⁻¹x via the inversion lemma and its log-determinant via
    the determinant lemma (reference matnormal_likelihoods.py:112-160)."""
    # (Q − Aᵀ Σ⁻¹ A)
    lemma_factor = _cholesky(
        Q.cov(Q_params, like=A) - A.T @ sigma.solve(sigma_params, A))
    logdet = (-Q.logdet(Q_params) + sigma.logdet(sigma_params)
              + 2 * torch.sum(torch.log(torch.diagonal(lemma_factor))))
    atrp_sinv = A.T @ sigma.prec(sigma_params, like=A)
    prod_term = _chol_solves(lemma_factor, atrp_sinv)
    eye = torch.eye(sigma.size, dtype=A.dtype, device=A.device)
    solve = sigma.solve(sigma_params, eye + A @ prod_term) @ x
    return solve, logdet


def _mnorm_logp_internal(colsize, rowsize, logdet_row, logdet_col,
                         solve_row, solve_col):
    denominator = (-rowsize * colsize * _LOG2PI
                   - colsize * logdet_row - rowsize * logdet_col)
    numerator = -torch.sum(solve_col * solve_row.T)
    return 0.5 * (numerator + denominator)


def _sizes(x, row_cov, col_cov):
    return (_observed(row_cov, x.shape[0]), _observed(col_cov, x.shape[1]))


def matnorm_logp(x, row_cov, row_params, col_cov, col_params):
    """Centered matrix-normal log-density
    (reference matnormal_likelihoods.py:202-231)."""
    rowsize, colsize = _sizes(x, row_cov, col_cov)
    solve_col = col_cov.solve(col_params, x.T)
    solve_row = row_cov.solve(row_params, x)
    return _mnorm_logp_internal(
        colsize, rowsize, row_cov.logdet(row_params),
        col_cov.logdet(col_params), solve_row, solve_col)


def matnorm_logp_marginal_row(x, row_cov, row_params, col_cov, col_params,
                              marg, marg_cov, marg_params):
    """logp of Y ~ MN(0, R + AQAᵀ, C)
    (reference matnormal_likelihoods.py:233-272)."""
    rowsize, colsize = _sizes(x, row_cov, col_cov)
    solve_col = col_cov.solve(col_params, x.T)
    solve_row, logdet_row = solve_det_marginal(
        x, row_cov, row_params, marg, marg_cov, marg_params)
    return _mnorm_logp_internal(
        colsize, rowsize, logdet_row, col_cov.logdet(col_params),
        solve_row, solve_col)


def matnorm_logp_marginal_col(x, row_cov, row_params, col_cov, col_params,
                              marg, marg_cov, marg_params):
    """logp of Y ~ MN(0, R, C + AᵀQA)
    (reference matnormal_likelihoods.py:274-316)."""
    rowsize, colsize = _sizes(x, row_cov, col_cov)
    solve_row = row_cov.solve(row_params, x)
    solve_col, logdet_col = solve_det_marginal(
        x.T, col_cov, col_params, marg, marg_cov, marg_params)
    return _mnorm_logp_internal(
        colsize, rowsize, row_cov.logdet(row_params), logdet_col,
        solve_row, solve_col)


def matnorm_logp_conditional_row(x, row_cov, row_params, col_cov,
                                 col_params, cond, cond_cov, cond_params):
    """logp with the row covariance conditioned on another variable
    (reference matnormal_likelihoods.py:318-372)."""
    rowsize, colsize = _sizes(x, row_cov, col_cov)
    solve_col = col_cov.solve(col_params, x.T)
    solve_row, logdet_row = solve_det_conditional(
        x, row_cov, row_params, cond, cond_cov, cond_params)
    return _mnorm_logp_internal(
        colsize, rowsize, logdet_row, col_cov.logdet(col_params),
        solve_row, solve_col)


def matnorm_logp_conditional_col(x, row_cov, row_params, col_cov,
                                 col_params, cond, cond_cov, cond_params):
    """logp with the column covariance conditioned on another variable
    (reference matnormal_likelihoods.py:375-429)."""
    rowsize, colsize = _sizes(x, row_cov, col_cov)
    solve_row = row_cov.solve(row_params, x)
    solve_col, logdet_col = solve_det_conditional(
        x.T, col_cov, col_params, cond, cond_cov, cond_params)
    return _mnorm_logp_internal(
        colsize, rowsize, row_cov.logdet(row_params), logdet_col,
        solve_row, solve_col)
