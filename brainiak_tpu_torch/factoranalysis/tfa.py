"""Topographical Factor Analysis (TFA) on a CUDA device.

PyTorch counterpart of ``brainiak_tpu/factoranalysis/tfa.py``.  The
model: one subject's data X [n_voxel, n_tr] ≈ F(C, W) · Wmat where F is
a Gaussian RBF factor matrix over scanner coordinates.  Fitting
alternates a ridge solve for the weight matrix with a bounded
nonlinear least-squares update of centres and widths on stochastically
subsampled voxels and TRs.

The RBF op and the ridge solve run on ``device``
(:mod:`brainiak_tpu_torch.ops.rbf`), and the bounded NLLS is the
port's own L-BFGS with a sigmoid box transform and autograd gradients
(:func:`~brainiak_tpu_torch.ops.optimize.minimize_bounded`; the JAX
package's is optax's, so iterates differ and optima agree).  The
``nlss_method`` / ``jac`` / ``x_scale`` / ``tr_solver`` knobs are
accepted for API compatibility; ``nlss_loss`` supports 'linear' and
'soft_l1'.  A fit computes in its data's dtype; the subsample draws,
the packing and the Hungarian reorder stay on the host, as there.  The
factor centres are seeded by the port's own k-means
(:mod:`._kmeans`, in float64 whatever the data's dtype: a float32 tie
on a regular grid would move the seeding).
"""

import logging
import math

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment
from scipy.spatial import distance

from ..device import resolve_device
from ..funcalign.srm import _Estimator
from ..ops.optimize import minimize_bounded
from ..ops.rbf import rbf_factors, rbf_residual_sum, rbf_weight_products
from ..resilience.guards import (array_digest, check_state,
                                 pack_rng_state, run_resilient_loop,
                                 unpack_rng_state)
from ..utils.utils import from_sym_2_tri, from_tri_2_sym
from ._kmeans import kmeans

logger = logging.getLogger(__name__)

__all__ = ["TFA"]

#: Voxel chunk of the fits' fused contractions.  On the card a chunk
#: of the Python loop costs its launches (the JAX package's scan step
#: of 1024 voxels is a TPU tile), so a subsample of up to this many
#: voxels is one chunk; only the summation order differs.
_FIT_CHUNK = 8192


def _solve_weights(data, F, weight_method="rr"):
    """W = (FᵀF + beta·I)⁻¹ Fᵀ X (ridge, beta = var(data)) or OLS
    (reference tfa.py:569-598), from a materialized factor matrix."""
    k = F.shape[1]
    beta = torch.var(data, unbiased=False) if weight_method == "rr" \
        else 0.0
    eye = torch.eye(k, dtype=F.dtype, device=F.device)
    return torch.linalg.solve(F.T @ F + beta * eye, F.T @ data)


def _solve_weights_fused(data, R, centers, widths, weight_method="rr",
                         chunk=_FIT_CHUNK):
    """The same ridge / OLS solve with ``FᵀF`` / ``FᵀX`` accumulated by
    the chunked contraction
    (:func:`~brainiak_tpu_torch.ops.rbf.rbf_weight_products`)."""
    k = centers.shape[0]
    beta = torch.var(data, unbiased=False) if weight_method == "rr" \
        else 0.0
    g, b = rbf_weight_products(R, centers, widths, data, chunk=chunk)
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    return torch.linalg.solve(g + beta * eye, b)


def _rho_sum(sq, nlss_loss):
    if nlss_loss == "soft_l1":
        return torch.sum(2.0 * (torch.sqrt(1.0 + sq) - 1.0))
    return torch.sum(sq)


def _full_sym(tri, n_dim):
    """Full symmetric matrix from its packed upper-triangular vector."""
    u = from_tri_2_sym(tri, n_dim)
    return u + u.T - np.diag(np.diag(u))


def _match_centers(prior_centers, posterior_centers):
    """Hungarian assignment of posterior factors to prior factors by
    centre distance; returns the posterior column order."""
    cost = distance.cdist(prior_centers, posterior_centers, 'euclidean')
    return linear_sum_assignment(cost)[1]


def _nlls_objective(params, R, X, W, data_sigma, sample_scaling,
                    tmpl_centers, tmpl_cov_inv, tmpl_widths,
                    tmpl_widths_var_reci, *, K, n_dim, nlss_loss,
                    has_template, chunk=_FIT_CHUNK):
    """0.5·Σ rho(r_i²) over packed (centres, widths), the reference's
    residual stack (tfa.py:652-736): the data term sigma·(X − F·W)
    rebuilt chunk by chunk, plus per-factor centre Mahalanobis and
    width penalties when a template is present."""
    centers = params[:K * n_dim].reshape(K, n_dim)
    widths = params[K * n_dim:]
    total = rbf_residual_sum(R, centers, widths, X, W, data_sigma,
                             nlss_loss=nlss_loss, chunk=chunk)
    if has_template:
        diff = centers - tmpl_centers
        maha = (diff[:, None, :] @ tmpl_cov_inv @ diff[:, :, None])[:, 0, 0]
        total = total + _rho_sum(sample_scaling * maha, nlss_loss)
        wdist = sample_scaling * tmpl_widths_var_reci.reshape(-1) * \
            (widths - tmpl_widths.reshape(-1)) ** 2
        total = total + _rho_sum(wdist, nlss_loss)
    return 0.5 * total


def _fit_centers_widths(init, lower, upper, R, X, W, data_sigma,
                        sample_scaling, tmpl_centers, tmpl_cov_inv,
                        tmpl_widths, tmpl_widths_var_reci, *, K, n_dim,
                        nlss_loss, max_iters, has_template):
    """Bounded NLLS over packed (centres, widths): ``(x, value)`` of
    :func:`minimize_bounded` on :func:`_nlls_objective`."""

    def objective(params):
        return _nlls_objective(
            params, R, X, W, data_sigma, sample_scaling, tmpl_centers,
            tmpl_cov_inv, tmpl_widths, tmpl_widths_var_reci, K=K,
            n_dim=n_dim, nlss_loss=nlss_loss, has_template=has_template)

    return minimize_bounded(objective, init, lower, upper,
                            max_iters=max_iters)


class TFA(_Estimator):
    """Topographical Factor Analysis (reference tfa.py:52-1024).

    Parameters follow the reference: K factors, ``max_iter`` outer
    iterations with ``threshold`` max-abs-diff convergence,
    ``weight_method`` 'rr' (ridge) or 'ols', bounds from
    ``lower_ratio``/``upper_ratio`` of the coordinate spread, stochastic
    subsampling to ``max_num_voxel`` × ``max_num_tr`` per iteration with
    ``seed``.  ``device`` is ``"cuda"`` (default; raises without a card)
    or ``"cpu"``.

    Attributes after fit: ``local_posterior_`` (packed centers+widths),
    ``F_`` [n_voxel, K], ``W_`` [K, n_tr].
    """

    _param_names = ("max_iter", "threshold", "K", "nlss_method",
                    "nlss_loss", "jac", "x_scale", "tr_solver",
                    "weight_method", "upper_ratio", "lower_ratio",
                    "max_num_tr", "max_num_voxel", "seed", "verbose",
                    "lbfgs_iters", "device")

    def __init__(self, max_iter=10, threshold=1.0, K=50, nlss_method='trf',
                 nlss_loss='linear', jac='2-point', x_scale=1.0,
                 tr_solver=None, weight_method='rr', upper_ratio=1.8,
                 lower_ratio=0.02, max_num_tr=500, max_num_voxel=5000,
                 seed=100, verbose=False, lbfgs_iters=60, device="cuda"):
        self.miter = max_iter
        self.threshold = threshold
        self.K = K
        self.nlss_method = nlss_method
        self.nlss_loss = nlss_loss
        self.jac = jac
        self.x_scale = x_scale
        self.tr_solver = tr_solver
        self.weight_method = weight_method
        self.upper_ratio = upper_ratio
        self.lower_ratio = lower_ratio
        self.max_num_tr = max_num_tr
        self.max_num_voxel = max_num_voxel
        self.seed = seed
        self.verbose = verbose
        self.lbfgs_iters = lbfgs_iters
        self.device = device

    @property
    def max_iter(self):
        return self.miter

    @max_iter.setter
    def max_iter(self, value):
        self.miter = value

    # -- configuration ----------------------------------------------------
    def set_K(self, K):
        self.K = K
        return self

    def set_prior(self, prior):
        self.local_prior = prior
        return self

    def set_seed(self, seed):
        self.seed = seed
        return self

    # -- device and dtype -------------------------------------------------
    def _work_dtype(self, *arrays):
        """The fit's dtype once ``fit`` has set it, else the inputs'
        (at least float32)."""
        fit = getattr(self, "_dtype", None)
        if fit is not None:
            return fit
        return np.result_type(*[np.asarray(a).dtype for a in arrays],
                              np.float32)

    def _tensor(self, a, dtype=None, device=None):
        dtype = self._work_dtype(a) if dtype is None else dtype
        dev = resolve_device(self.device) if device is None else device
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=dev)

    # -- packed parameter vector layout (reference tfa.py:309-523) --------
    def get_map_offset(self):
        nfield = 4
        self.map_offset = np.zeros(nfield).astype(int)
        field_size = self.K * np.array(
            [self.n_dim, 1, self.cov_vec_size, 1])
        for i in np.arange(nfield - 1) + 1:
            self.map_offset[i] = self.map_offset[i - 1] + field_size[i - 1]
        return self.map_offset

    def get_centers(self, estimation):
        return estimation[0:self.map_offset[1]].reshape(self.K, self.n_dim)

    def get_widths(self, estimation):
        return estimation[self.map_offset[1]:self.map_offset[2]] \
            .reshape(self.K, 1)

    def get_centers_mean_cov(self, estimation):
        return estimation[self.map_offset[2]:self.map_offset[3]] \
            .reshape(self.K, self.cov_vec_size)

    def get_widths_mean_var(self, estimation):
        return estimation[self.map_offset[3]:].reshape(self.K, 1)

    def set_centers(self, estimation, centers):
        estimation[0:self.map_offset[1]] = centers.ravel()

    def set_widths(self, estimation, widths):
        estimation[self.map_offset[1]:self.map_offset[2]] = widths.ravel()

    def set_centers_mean_cov(self, estimation, centers_mean_cov):
        estimation[self.map_offset[2]:self.map_offset[3]] = \
            centers_mean_cov.ravel()

    def set_widths_mean_var(self, estimation, widths_mean_var):
        estimation[self.map_offset[3]:] = widths_mean_var.ravel()

    # -- initialization ---------------------------------------------------
    def _get_max_sigma(self, R):
        """2 · (max per-dim std of coordinates)² (reference tfa.py:600-618)."""
        return 2.0 * math.pow(np.nanmax(np.std(R, axis=0)), 2)

    def init_centers_widths(self, R):
        """k-means++ centres (n_init=10, seeded from 100) and max-sigma
        widths (reference tfa.py:328-350)."""
        centers, _ = kmeans(R, self.K, n_init=10, random_state=100,
                            device=resolve_device(self.device))
        widths = self._get_max_sigma(R) * np.ones((self.K, 1))
        return centers, widths

    def init_prior(self, R):
        centers, widths = self.init_centers_widths(R)
        prior = np.zeros(self.K * (self.n_dim + 1))
        self.set_centers(prior, centers)
        self.set_widths(prior, widths)
        self.set_prior(prior)
        return self

    def get_template(self, R):
        """Template prior: k-means centres and widths, plus a constant
        covariance cov(R)·K^(-2/3) and width variance (reference
        tfa.py:352-385)."""
        centers, widths = self.init_centers_widths(R)
        template_prior = np.zeros(
            self.K * (self.n_dim + 2 + self.cov_vec_size))
        template_centers_cov = np.cov(R.T) * math.pow(self.K, -2 / 3.0)
        template_widths_var = self._get_max_sigma(R)
        self.set_centers(template_prior, centers)
        self.set_widths(template_prior, widths)
        self.set_centers_mean_cov(
            template_prior,
            np.tile(from_sym_2_tri(template_centers_cov), self.K))
        self.set_widths_mean_var(
            template_prior, np.tile(template_widths_var, self.K))
        return template_prior, template_centers_cov, template_widths_var

    def get_bounds(self, R):
        """Box bounds: centers within coordinate range, widths within
        [lower_ratio, upper_ratio]·max_sigma (reference tfa.py:620-650)."""
        max_sigma = self._get_max_sigma(R)
        lower = np.zeros(self.K * (self.n_dim + 1))
        lower[0:self.K * self.n_dim] = np.tile(np.nanmin(R, axis=0),
                                               self.K)
        lower[self.K * self.n_dim:] = self.lower_ratio * max_sigma
        upper = np.zeros(self.K * (self.n_dim + 1))
        upper[0:self.K * self.n_dim] = np.tile(np.nanmax(R, axis=0),
                                               self.K)
        upper[self.K * self.n_dim:] = self.upper_ratio * max_sigma
        return lower, upper

    # -- factor / weight computation --------------------------------------
    def get_unique_R(self, R):
        """Unique coordinate values per dim + inverse indices (kept for
        API parity; the factor op does not need them, reference
        tfa.py:879-906)."""
        unique_R = []
        inds = []
        for d in np.arange(self.n_dim):
            tmp_unique, tmp_inds = np.unique(R[:, d], return_inverse=True)
            unique_R.append(tmp_unique)
            inds.append(tmp_inds)
        return unique_R, inds

    def _factors(self, R, centers, widths, dtype):
        return rbf_factors(self._tensor(R, dtype),
                           self._tensor(centers, dtype),
                           self._tensor(widths, dtype)).cpu().numpy()

    def get_factors(self, unique_R, inds, centers, widths):
        """RBF factor matrix [n_voxel, K] (reference tfa.py:525-567).

        Accepts the reference's (unique_R, inds) calling convention but
        reconstructs R and evaluates the factor op."""
        R = np.stack([u[i] for u, i in zip(unique_R, inds)], axis=1)
        return self._factors(R, centers, widths,
                             self._work_dtype(R, centers, widths))

    def get_weights(self, data, F):
        """Ridge/OLS weight solve (reference tfa.py:569-598)."""
        dtype = self._work_dtype(data, F)
        return _solve_weights(self._tensor(data, dtype),
                              self._tensor(F, dtype),
                              self.weight_method).cpu().numpy()

    # -- convergence ------------------------------------------------------
    def _assign_posterior(self):
        """Hungarian matching of posterior to prior centers
        (reference tfa.py:242-260)."""
        prior_centers = self.get_centers(self.local_prior)
        posterior_centers = self.get_centers(self.local_posterior_)
        posterior_widths = self.get_widths(self.local_posterior_)
        col_ind = _match_centers(prior_centers, posterior_centers)
        self.set_centers(self.local_posterior_, posterior_centers[col_ind])
        self.set_widths(self.local_posterior_, posterior_widths[col_ind])
        return self

    def _converged(self):
        diff = self.local_prior - self.local_posterior_
        max_diff = np.max(np.fabs(diff))
        if self.verbose:
            # the reference's verbose diagnostics (tfa.py:276-281)
            _, mse = self._mse_converged()
            diff_ratio = np.sum(diff ** 2) \
                / np.sum(self.local_posterior_ ** 2)
            logger.info('tfa prior posterior max diff %f mse %f '
                        'diff_ratio %f', max_diff, mse, diff_ratio)
        return max_diff <= self.threshold, max_diff

    def _mse_converged(self):
        mse = np.mean((self.local_prior - self.local_posterior_) ** 2)
        return mse <= self.threshold, mse

    # -- fitting ----------------------------------------------------------
    def _template_tensors(self, template_centers, template_widths,
                          template_centers_mean_cov,
                          template_widths_mean_var_reci):
        """The template penalty's tensors (zeros without a template)."""
        K, n_dim = self.K, self.n_dim
        if template_centers is None:
            return tuple(self._tensor(np.zeros(s)) for s in
                         ((K, n_dim), (K, n_dim, n_dim), (K, 1), (K, 1)))
        cov_inv = np.stack([
            np.linalg.inv(_full_sym(template_centers_mean_cov[k], n_dim))
            for k in range(K)])
        return tuple(self._tensor(a) for a in (
            template_centers, cov_inv, template_widths,
            template_widths_mean_var_reci))

    def _estimate_centers_widths(self, R, X, W, init_centers, init_widths,
                                 template_centers, template_widths,
                                 template_centers_mean_cov,
                                 template_widths_mean_var_reci,
                                 X_device=None):
        """Bounded NLLS over packed (centers, widths)
        (reference tfa.py:738-821).  ``X`` is the subsample on the host
        (its std sets the data term's scale, as there), ``X_device``
        its copy on the device when the caller has one; ``W`` is a
        tensor."""
        init = np.hstack((init_centers.ravel(), init_widths.ravel()))
        data_sigma = 1.0 / math.sqrt(2.0) * np.std(X)
        if X_device is None:
            X_device = self._tensor(X)
        tmpl = self._template_tensors(
            template_centers, template_widths, template_centers_mean_cov,
            template_widths_mean_var_reci)
        x, cost = _fit_centers_widths(
            self._tensor(init), self._tensor(self.bounds[0]),
            self._tensor(self.bounds[1]), self._tensor(R), X_device, W,
            float(data_sigma), self.sample_scaling, *tmpl, K=self.K,
            n_dim=self.n_dim, nlss_loss=self.nlss_loss,
            max_iters=self.lbfgs_iters,
            has_template=template_centers is not None)
        return x.detach().cpu().numpy().astype(float), float(cost)

    def _fit_tfa_inner(self, data, R, template_centers, template_widths,
                       template_centers_mean_cov,
                       template_widths_mean_var_reci):
        """One stochastic subsample + W solve + bounded NLLS
        (reference tfa.py:908-969)."""
        nfeature, nsample = data.shape
        feature_indices = self._rng.choice(nfeature, self.max_num_voxel,
                                           replace=False)
        sample_indices = self._rng.choice(nsample, self.max_num_tr,
                                          replace=False)
        curr_data = data[feature_indices][:, sample_indices].copy()
        curr_R = R[feature_indices].copy()
        centers = self.get_centers(self.local_prior)
        widths = self.get_widths(self.local_prior)
        # one upload of the subsample; the weight solve accumulates
        # FᵀF / FᵀX chunk by chunk
        data_t = self._tensor(curr_data)
        W = _solve_weights_fused(
            data_t, self._tensor(curr_R), self._tensor(centers),
            self._tensor(widths), self.weight_method)
        self.local_posterior_, self.total_cost = \
            self._estimate_centers_widths(
                curr_R, curr_data, W, centers, widths, template_centers,
                template_widths, template_centers_mean_cov,
                template_widths_mean_var_reci, X_device=data_t)
        return self

    def _fit_tfa(self, data, R, template_prior=None,
                 checkpoint_dir=None, checkpoint_every=5):
        """Outer loop: subsample-fit until converged
        (reference tfa.py:824-877), driven by the resilient loop:
        per-iteration non-finite guard with checkpoint rollback and —
        with ``checkpoint_dir`` — preemption-safe resume including the
        subsampling RNG stream position."""
        if template_prior is None:
            template_centers = None
            template_widths = None
            template_centers_mean_cov = None
            template_widths_mean_var_reci = None
        else:
            template_centers = self.get_centers(template_prior)
            template_widths = self.get_widths(template_prior)
            template_centers_mean_cov = \
                self.get_centers_mean_cov(template_prior)
            template_widths_mean_var_reci = \
                1.0 / self.get_widths_mean_var(template_prior)
        self._rng = np.random.RandomState(self.seed)

        def pack(done):
            keys, meta = pack_rng_state(self._rng)
            return {
                "prior": np.asarray(self.local_prior, dtype=float),
                "posterior": np.asarray(
                    getattr(self, "local_posterior_", self.local_prior),
                    dtype=float),
                "rng_keys": keys, "rng_meta": meta,
                "done": np.array(float(done)),
            }

        def unpack(state):
            self.local_prior = np.array(state["prior"], dtype=float)
            self.local_posterior_ = np.array(state["posterior"],
                                             dtype=float)
            unpack_rng_state(self._rng, state["rng_keys"],
                             state["rng_meta"])

        def run_chunk(state, step, n_steps):
            unpack(state)
            done = False
            for i in range(n_steps):
                self._fit_tfa_inner(data, R, template_centers,
                                    template_widths,
                                    template_centers_mean_cov,
                                    template_widths_mean_var_reci)
                self._assign_posterior()
                check_state({"posterior": self.local_posterior_},
                            iteration=step + i + 1, where="TFA.fit")
                converged, max_diff = self._converged()
                if converged:
                    if self.verbose:
                        logger.info("TFA converged at %d iteration.",
                                    step + i)
                    done = True
                    break
                self.local_prior = self.local_posterior_
            return pack(done), done

        # the JAX package's fingerprint, formed only when a checkpoint
        # reads it (its digest is a host pass over the whole data)
        fingerprint = None if checkpoint_dir is None else np.array(
            [array_digest(data), float(data.shape[0]),
             float(data.shape[1]), float(self.K), float(self.seed)])
        state, _ = run_resilient_loop(
            run_chunk, pack(False), self.miter,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            fingerprint=fingerprint, name="TFA.fit")
        unpack(state)
        return self

    def fit(self, X, R, template_prior=None, checkpoint_dir=None,
            checkpoint_every=5):
        """Fit TFA to one subject (reference tfa.py:971-1024).

        X: [n_voxel, n_tr] data; R: [n_voxel, n_dim] coordinates.  The
        fit computes in X's dtype (at least float32).

        With ``checkpoint_dir``, the outer subsample-fit loop
        checkpoints every ``checkpoint_every`` iterations (including
        the subsampling RNG stream) under the resilience guard, and a
        later call with the same directory resumes after preemption.
        """
        if not isinstance(X, np.ndarray):
            raise TypeError("Input data should be an array")
        if X.ndim != 2:
            raise TypeError("Input data should be 2D array")
        if not isinstance(R, np.ndarray):
            raise TypeError("Input coordinate matrix should be an array")
        if R.ndim != 2:
            raise TypeError("Input coordinate matrix should be 2D array")
        if X.shape[0] != R.shape[0]:
            raise TypeError(
                "The number of voxels should be the same in X and R!")
        if self.weight_method not in ('rr', 'ols'):
            raise ValueError(
                "only 'rr' and 'ols' are accepted as weight_method!")
        resolve_device(self.device)
        self._dtype = np.result_type(X.dtype, np.float32)

        self.n_dim = R.shape[1]
        self.cov_vec_size = np.sum(np.arange(self.n_dim) + 1)
        self.map_offset = self.get_map_offset()
        self.bounds = self.get_bounds(R)
        self.max_num_voxel = min(self.max_num_voxel, X.shape[0])
        self.max_num_tr = min(self.max_num_tr, X.shape[1])
        self.sample_scaling = 0.5 * float(
            self.max_num_voxel * self.max_num_tr) / \
            float(X.shape[0] * X.shape[1])
        if template_prior is None:
            self.init_prior(R)
        else:
            self.local_prior = template_prior[0:self.map_offset[2]].copy()
        self._fit_tfa(X, R, template_prior,
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every)
        if template_prior is None:
            centers = self.get_centers(self.local_posterior_)
            widths = self.get_widths(self.local_posterior_)
            self.F_ = self._factors(R, centers, widths, self._dtype)
            self.W_ = self.get_weights(X, self.F_)
        return self
