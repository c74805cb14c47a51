"""Hierarchical Topographical Factor Analysis (HTFA) on a CUDA device.

PyTorch counterpart of ``brainiak_tpu/factoranalysis/htfa.py``.  A
global template over factor centres and widths (mean + covariance /
variance) is MAP-updated from per-subject TFA posteriors.

The JAX package runs every subject's inner TFA iteration (masked ridge
weight solve, then bounded L-BFGS over centres and widths with the
template penalty) as ONE ``vmap`` of ``minimize_bounded`` over the
subject axis.  The port's L-BFGS is a host-controlled loop (a host
read a stopping test and a line-search trial), which ``torch.func.vmap``
cannot map; so each subject's step runs in a Python loop
(:meth:`HTFA._subject_step`), at its own subsample size.  A ``vmap``
of a ``while_loop`` runs each lane as its own optimization, so the
loop computes the same function, and no padding to a common extent is
needed.  It is host-bound: the launches and syncs of one L-BFGS a
subject, one subject after another.

With ``mesh=`` the subject axis is split over the mesh's ``'subject'``
positions (contiguous blocks, the subject count rounded up to the
positions): a subject's tensors go to its position's device, and
across processes each rank fits the subjects of its own positions.
Every rank gets the [S, prior_size] posteriors back by one
``all_gather`` (:func:`~brainiak_tpu_torch.parallel.mesh
.fetch_replicated`, the analogue of the JAX package's fetch and of the
reference's Gatherv + Bcast); the MAP update of the template and the
Hungarian reorder stay on the host, replicated on every rank.

As in the JAX package, ``_assign_posterior`` reorders all four
template fields consistently (the reference reorders only the
covariance and variance fields).
"""

import logging

import numpy as np
import torch

from ..device import resolve_device
from ..funcalign.srm import _refuse_store
from ..ops.optimize import minimize_bounded
from ..ops.rbf import rbf_factors, rbf_weight_products
from ..parallel.mesh import (DEFAULT_SUBJECT_AXIS, Sharded, axis_devices,
                             axis_ranks, fetch_replicated, process_index)
from ..resilience.guards import (array_digest, check_state,
                                 run_resilient_loop)
from ..utils.utils import from_sym_2_tri, from_tri_2_sym
from .tfa import TFA, _FIT_CHUNK, _full_sym, _match_centers, _nlls_objective

logger = logging.getLogger(__name__)

__all__ = ["HTFA"]


class HTFA(TFA):
    """Hierarchical TFA over multiple subjects (reference htfa.py:62-841).

    Parameters follow the reference: K, n_subj, max_global_iter /
    max_local_iter, threshold, weight_method, bounds ratios, subsampling
    ratios/caps (voxel_ratio, tr_ratio, max_voxel, max_tr); ``mesh``
    splits the subjects over its ``'subject'`` positions;
    ``shard_subjects`` is kept for the JAX package's signature (it sizes
    the shards of a ``SubjectStore``, which the port refuses).
    ``device`` is ``"cuda"`` (default; raises without a card) or
    ``"cpu"``; with a mesh, its positions' devices.

    Attributes after fit: ``global_prior_``, ``global_posterior_``,
    ``local_posterior_`` (concatenated per-subject centers+widths),
    ``local_weights_`` (concatenated per-subject weight matrices).
    """

    _param_names = ("K", "n_subj", "max_global_iter", "max_local_iter",
                    "threshold", "nlss_method", "nlss_loss", "jac",
                    "x_scale", "tr_solver", "weight_method",
                    "upper_ratio", "lower_ratio", "voxel_ratio",
                    "tr_ratio", "max_voxel", "max_tr", "verbose",
                    "lbfgs_iters", "mesh", "shard_subjects", "device")

    def __init__(self, K, n_subj, max_global_iter=10, max_local_iter=10,
                 threshold=0.01, nlss_method='trf', nlss_loss='soft_l1',
                 jac='2-point', x_scale='jac', tr_solver=None,
                 weight_method='rr', upper_ratio=1.8, lower_ratio=0.02,
                 voxel_ratio=0.25, tr_ratio=0.1, max_voxel=5000,
                 max_tr=500, verbose=False, lbfgs_iters=60, mesh=None,
                 shard_subjects=None, device="cuda"):
        self.K = K
        self.n_subj = n_subj
        self.max_global_iter = max_global_iter
        self.max_local_iter = max_local_iter
        self.threshold = threshold
        self.nlss_method = nlss_method
        self.nlss_loss = nlss_loss
        self.jac = jac
        self.x_scale = x_scale
        self.tr_solver = tr_solver
        self.weight_method = weight_method
        self.upper_ratio = upper_ratio
        self.lower_ratio = lower_ratio
        self.voxel_ratio = voxel_ratio
        self.tr_ratio = tr_ratio
        self.max_voxel = max_voxel
        self.max_tr = max_tr
        self.verbose = verbose
        self.lbfgs_iters = lbfgs_iters
        self.mesh = mesh
        self.shard_subjects = shard_subjects
        self.device = device

    # -- convergence over the global template -----------------------------
    def _converged(self):
        prior = self.global_prior_[0:self.prior_size]
        posterior = self.global_posterior_[0:self.prior_size]
        diff = prior - posterior
        max_diff = np.max(np.fabs(diff))
        if self.verbose:
            # the reference's verbose diagnostics (htfa.py:209-214)
            _, mse = self._mse_converged()
            diff_ratio = np.sum(diff ** 2) / np.sum(posterior ** 2)
            logger.info('htfa prior posterior max diff %f mse %f '
                        'diff_ratio %f', max_diff, mse, diff_ratio)
        return max_diff <= self.threshold, max_diff

    def _mse_converged(self):
        prior = self.global_prior_[0:self.prior_size]
        posterior = self.global_posterior_[0:self.prior_size]
        mse = np.mean((prior - posterior) ** 2)
        return mse <= self.threshold, mse

    # -- MAP update -------------------------------------------------------
    def _map_update(self, prior_mean, prior_cov, global_cov_scaled,
                    new_observation):
        """Gaussian MAP update of one factor's center parameters
        (reference htfa.py:246-288)."""
        common = np.linalg.inv(prior_cov + global_cov_scaled)
        observation_mean = np.mean(new_observation, axis=1)
        posterior_mean = prior_cov.dot(common.dot(observation_mean)) + \
            global_cov_scaled.dot(common.dot(prior_mean))
        posterior_cov = prior_cov.dot(common.dot(global_cov_scaled))
        return posterior_mean, posterior_cov

    def _map_update_posterior(self):
        """MAP-update the global template from gathered subject posteriors
        (reference htfa.py:290-341)."""
        self.global_posterior_ = self.global_prior_.copy()
        prior_centers = self.get_centers(self.global_prior_)
        prior_widths = self.get_widths(self.global_prior_)
        prior_centers_mean_cov = \
            self.get_centers_mean_cov(self.global_prior_)
        prior_widths_mean_var = \
            self.get_widths_mean_var(self.global_prior_)
        center_size = self.K * self.n_dim
        posterior_size = center_size + self.K
        gathered = self.gather_posterior.reshape(self.n_subj,
                                                 posterior_size)
        all_centers = gathered[:, :center_size].reshape(
            self.n_subj, self.K, self.n_dim)
        all_widths = gathered[:, center_size:]
        for k in np.arange(self.K):
            next_centers = all_centers[:, k, :].T  # [n_dim, n_subj]
            next_widths = all_widths[:, k]

            posterior_mean, posterior_cov = self._map_update(
                prior_centers[k].T.copy(),
                from_tri_2_sym(prior_centers_mean_cov[k], self.n_dim),
                self.global_centers_cov_scaled,
                next_centers)
            self.global_posterior_[k * self.n_dim:(k + 1) * self.n_dim] = \
                posterior_mean.T
            start_idx = self.map_offset[2] + k * self.cov_vec_size
            end_idx = self.map_offset[2] + (k + 1) * self.cov_vec_size
            self.global_posterior_[start_idx:end_idx] = \
                from_sym_2_tri(posterior_cov)

            pw_var = float(prior_widths_mean_var[k, 0])
            pw = float(prior_widths[k, 0])
            common = 1.0 / (pw_var + self.global_widths_var_scaled)
            observation_mean = np.mean(next_widths)
            tmp = common * self.global_widths_var_scaled
            self.global_posterior_[self.map_offset[1] + k] = \
                pw_var * common * observation_mean + tmp * pw
            self.global_posterior_[self.map_offset[3] + k] = pw_var * tmp
        return self

    def _assign_posterior(self):
        """Hungarian matching of global posterior factors to the prior,
        reordering all four fields consistently (see module docstring)."""
        prior_centers = self.get_centers(self.global_prior_)
        posterior_centers = self.get_centers(self.global_posterior_)
        posterior_widths = self.get_widths(self.global_posterior_)
        posterior_centers_mean_cov = \
            self.get_centers_mean_cov(self.global_posterior_)
        posterior_widths_mean_var = \
            self.get_widths_mean_var(self.global_posterior_)
        col_ind = _match_centers(prior_centers, posterior_centers)
        self.set_centers(self.global_posterior_,
                         posterior_centers[col_ind])
        self.set_widths(self.global_posterior_, posterior_widths[col_ind])
        self.set_centers_mean_cov(self.global_posterior_,
                                  posterior_centers_mean_cov[col_ind])
        self.set_widths_mean_var(self.global_posterior_,
                                 posterior_widths_mean_var[col_ind])
        return self

    # -- fitting ----------------------------------------------------------
    def _prepare_subject_batch(self, shapes, R):
        """Per-subject subsample sizes, NLLS bounds and template-penalty
        scaling (reference htfa.py:697-713 clamps + tfa.py:995-999)."""
        self.sub_nvox = [min(self.max_voxel,
                             int(self.voxel_ratio * shp[0]),
                             shp[0]) for shp in shapes]
        self.sub_ntr = [min(self.max_tr,
                            int(self.tr_ratio * shp[1]),
                            shp[1]) for shp in shapes]
        self.sub_scaling = np.array(
            [0.5 * float(nv * nt) / float(shp[0] * shp[1])
             for nv, nt, shp in zip(self.sub_nvox, self.sub_ntr,
                                    shapes)])
        bounds = [self.get_bounds(r) for r in R]
        self.sub_lower = np.stack([b[0] for b in bounds])
        self.sub_upper = np.stack([b[1] for b in bounds])

    def _subject_layout(self):
        """``(device of each subject, subjects this process fits, mesh
        positions or None)``: the subjects in contiguous blocks over the
        mesh's subject positions (the count rounded up to them), each
        fitted on its position's device by the rank that owns it."""
        S = self.n_subj
        if self.mesh is None:
            dev = resolve_device(self.device)
            return [dev] * S, list(range(S)), None
        devices = axis_devices(self.mesh, DEFAULT_SUBJECT_AXIS)
        ranks = axis_ranks(self.mesh, DEFAULT_SUBJECT_AXIS)
        per = -(-S // len(devices))
        me = process_index()
        mine = [s for s in range(S)
                if ranks is None or ranks[s // per] == me]
        return ([devices[s // per] for s in range(S)], mine,
                (devices, ranks, per))

    def _gather_subsample(self, data_s, R_s, rng, s):
        """Draw one subject's stochastic voxel / TR subsample on the host
        (the JAX package's draws, in its order): ``(data, coordinates,
        ridge coefficient, data-term scale)``."""
        nv, nt = self.sub_nvox[s], self.sub_ntr[s]
        feat = rng.choice(data_s.shape[0], nv, replace=False)
        samp = rng.choice(data_s.shape[1], nt, replace=False)
        curr = data_s[feat][:, samp]
        beta = np.var(curr) if self.weight_method == 'rr' else 0.0
        sigma = np.std(curr) / np.sqrt(2.0)
        return curr, R_s[feat], float(beta), float(sigma)

    def _subject_step(self, curr, curr_R, prior_s, s, beta, sigma, tmpl,
                      device):
        """One subject's inner TFA iteration on ``device``: the ridge
        weight solve, then bounded L-BFGS over its packed (centres,
        widths) with the template penalty.  Returns ``(x, value)``
        tensors (one lane of the JAX package's batched step)."""
        K, n_dim = self.K, self.n_dim

        def put(a):
            return self._tensor(a, device=device)

        x = put(curr)
        r = put(curr_R)
        init = put(prior_s)
        centers = init[:K * n_dim].reshape(K, n_dim)
        widths = init[K * n_dim:]
        g, b = rbf_weight_products(r, centers, widths, x, chunk=_FIT_CHUNK)
        W = torch.linalg.solve(
            g + beta * torch.eye(K, dtype=g.dtype, device=g.device), b)
        tmpl = tuple(put(t) for t in tmpl)

        def objective(params):
            return _nlls_objective(
                params, r, x, W, sigma, float(self.sub_scaling[s]), *tmpl,
                K=K, n_dim=n_dim, nlss_loss=self.nlss_loss,
                has_template=True)

        return minimize_bounded(objective, init,
                                put(self.sub_lower[s]),
                                put(self.sub_upper[s]),
                                max_iters=self.lbfgs_iters)

    def _match_to_prior(self, prior_vec, posterior_vec):
        """Hungarian-match one subject's posterior factors to its prior
        (functional form of reference tfa.py:242-260)."""
        K, n_dim = self.K, self.n_dim
        pc = prior_vec[:K * n_dim].reshape(K, n_dim)
        qc = posterior_vec[:K * n_dim].reshape(K, n_dim)
        qw = posterior_vec[K * n_dim:]
        col = _match_centers(pc, qc)
        return np.concatenate([qc[col].ravel(), qw[col]])

    def _template_terms(self):
        """The replicated template-penalty terms every subject's inner
        objective shares for one global iteration."""
        K, n_dim = self.K, self.n_dim
        tmpl_centers = self.get_centers(self.global_prior_)
        tmpl_widths = self.get_widths(self.global_prior_).reshape(-1)
        tmpl_tri = self.get_centers_mean_cov(self.global_prior_)
        tmpl_reci = (
            1.0 / self.get_widths_mean_var(self.global_prior_)).reshape(-1)
        tmpl_cov_inv = np.stack(
            [np.linalg.inv(_full_sym(tmpl_tri[k], n_dim))
             for k in range(K)])
        return (tmpl_centers, tmpl_cov_inv, tmpl_widths, tmpl_reci)

    def _gather_posteriors(self, posterior, layout):
        """Every subject's row of ``posterior`` [S, prior_size] from the
        rows each rank fitted: one ``all_gather`` across processes
        (the subject count padded up to the positions and the pad
        dropped), the array itself in one process."""
        if layout is None or layout[1] is None:
            return posterior
        devices, ranks, per = layout
        padded = np.zeros((per * len(devices), posterior.shape[1]))
        padded[:posterior.shape[0]] = posterior
        me = process_index()
        chunks = [torch.from_numpy(padded[k * per:(k + 1) * per].copy())
                  if r == me else None for k, r in enumerate(ranks)]
        return fetch_replicated(Sharded(
            chunks, [torch.device("cpu")] * len(ranks), 0,
            (DEFAULT_SUBJECT_AXIS,), ranks, posterior.shape))

    def _fit_subjects(self, data, R, global_iter):
        """All subjects' inner TFA fits for one global iteration
        (reference htfa.py:732-749): each of this process's subjects
        runs its ``max_local_iter`` inner iterations in turn (a
        converged subject is frozen, as TFA's early stop), each on its
        device.  Subsampling RNGs are seeded per subject from the global
        iteration, so a subject's draws do not depend on which process
        fits it.  Returns the gathered [n_subj, prior_size] posteriors,
        the analogue of the reference's Gatherv."""
        tmpl = self._template_terms()
        devices, mine, layout = self._subject_layout()
        prior = np.tile(self.global_prior_[:self.prior_size],
                        (self.n_subj, 1))
        posterior = prior.copy()
        for s in mine:
            rng = np.random.RandomState(global_iter * self.max_local_iter)
            for n in range(self.max_local_iter):
                curr, curr_R, beta, sigma = self._gather_subsample(
                    data[s], R[s], rng, s)
                out, _ = self._subject_step(curr, curr_R, prior[s], s,
                                            beta, sigma, tmpl, devices[s])
                post_s = self._match_to_prior(
                    prior[s], out.detach().cpu().numpy().astype(float))
                posterior[s] = post_s
                if np.max(np.abs(prior[s] - post_s)) <= self.threshold:
                    break
                prior[s] = post_s
        return self._gather_posteriors(posterior, layout)

    def _fit_htfa(self, data, R, checkpoint_dir=None,
                  checkpoint_every=5):
        """Outer template loop (reference htfa.py:672-764): subject fits
        -> posterior gather -> replicated MAP update, driven by the
        resilient loop (non-finite guard with rollback; with
        ``checkpoint_dir`` the template state is persisted every
        ``checkpoint_every`` global iterations for resume)."""
        n_subj = len(R)
        self._prepare_subject_batch([d.shape for d in data], R)
        self.local_posterior_ = np.zeros(n_subj * self.prior_size)

        # Template initialized from a random subject's coordinates
        # (reference htfa.py:475-513), by numpy's global RNG.  On resume
        # the restored template supersedes this init.
        idx = np.random.choice(n_subj, 1)[0]
        self.global_prior_, self.global_centers_cov, \
            self.global_widths_var = self.get_template(R[idx])
        self.global_posterior_ = self.global_prior_.copy()

        def pack(done):
            return {
                "global_prior": np.asarray(self.global_prior_, float),
                "global_posterior": np.asarray(self.global_posterior_,
                                               float),
                "local_posterior": np.asarray(self.local_posterior_,
                                              float),
                "centers_cov": np.asarray(self.global_centers_cov,
                                          float),
                "widths_var": np.array([self.global_widths_var],
                                       dtype=float),
                "done": np.array(float(done)),
            }

        def unpack(state):
            self.global_prior_ = np.array(state["global_prior"], float)
            self.global_posterior_ = np.array(state["global_posterior"],
                                              float)
            self.local_posterior_ = np.array(state["local_posterior"],
                                             float)
            self.global_centers_cov = np.array(state["centers_cov"],
                                               float)
            self.global_widths_var = float(
                np.asarray(state["widths_var"]).reshape(-1)[0])
            self.global_centers_cov_scaled = \
                self.global_centers_cov / float(self.n_subj)
            self.global_widths_var_scaled = \
                self.global_widths_var / float(self.n_subj)

        def run_chunk(state, step, n_steps):
            unpack(state)
            done = False
            for i in range(n_steps):
                m = step + i
                if self.verbose:
                    logger.info("HTFA global iter %d", m)
                posterior = self._fit_subjects(data, R, m)
                self.local_posterior_ = posterior.ravel()
                self.gather_posterior = self.local_posterior_.copy()
                self._map_update_posterior()
                self._assign_posterior()
                check_state(
                    {"global_posterior": self.global_posterior_,
                     "local_posterior": self.local_posterior_},
                    iteration=m + 1, where="HTFA.fit")
                done, max_diff = self._converged()
                if done:
                    logger.info("converged at %d outer iter", m)
                    break
                self.global_prior_ = self.global_posterior_
            return pack(done), done

        # the JAX package's fingerprint, formed only when a checkpoint
        # reads it (its digest is a host pass over every subject)
        fingerprint = None if checkpoint_dir is None else np.array(
            [array_digest(*data),
             float(sum(d.shape[0] for d in data)), float(n_subj),
             float(self.K)])
        state, _ = run_resilient_loop(
            run_chunk, pack(False), self.max_global_iter,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            fingerprint=fingerprint, name="HTFA.fit")
        unpack(state)

        self._update_weight(data, R)
        return self

    def _update_weight(self, data, R):
        """Final per-subject factor + weight solves
        (reference htfa.py:626-670), every subject on every rank."""
        weights = []
        for s, subj_data in enumerate(data):
            base = s * self.prior_size
            centers = self.local_posterior_[
                base:base + self.K * self.n_dim].reshape(self.K,
                                                         self.n_dim)
            widths = self.local_posterior_[
                base + self.K * self.n_dim:base + self.prior_size] \
                .reshape(self.K, 1)
            F = rbf_factors(self._tensor(R[s]), self._tensor(centers),
                            self._tensor(widths)).cpu().numpy()
            weights.append(self.get_weights(subj_data, F).ravel())
        self.local_weights_ = np.concatenate(weights)
        return self

    def _check_input(self, X, R):
        if not isinstance(X, list):
            raise TypeError("Input data should be a list")
        if not isinstance(R, list):
            raise TypeError("Coordinates should be a list")
        if len(X) != len(R):
            raise TypeError("Data and coordinates lists must have equal "
                            "length")
        for x, r in zip(X, R):
            if not isinstance(x, np.ndarray) or x.ndim != 2:
                raise TypeError("Each subject data should be a 2D array")
            if not isinstance(r, np.ndarray) or r.ndim != 2:
                raise TypeError("Each coordinate matrix should be a 2D "
                                "array")
            if x.shape[0] != r.shape[0]:
                raise TypeError("The numbers of voxels in data and "
                                "coordinates differ")

    def fit(self, X, R, checkpoint_dir=None, checkpoint_every=5):
        """Fit HTFA (reference htfa.py:766-841).

        X : list of [n_voxel, n_tr] per-subject data (a fit computes in
            their common dtype, at least float32); a ``SubjectStore``
            raises ``NotImplementedError`` (the port has no data plane
            yet)
        R : list of [n_voxel, n_dim] per-subject coordinates

        With ``checkpoint_dir``, the global-template loop checkpoints
        every ``checkpoint_every`` global iterations under the
        resilience guard and a later call resumes after preemption.
        """
        _refuse_store(X)
        self._check_input(X, R)
        if self.weight_method not in ('rr', 'ols'):
            raise ValueError(
                "only 'rr' and 'ols' are accepted as weight_method!")
        if self.mesh is not None and \
                DEFAULT_SUBJECT_AXIS not in self.mesh.shape:
            raise ValueError(
                "HTFA shards subjects over the mesh's "
                f"'{DEFAULT_SUBJECT_AXIS}' axis, but the given mesh has "
                f"axes {tuple(self.mesh.shape)}")
        resolve_device(self.device)
        self._dtype = np.result_type(*[x.dtype for x in X], np.float32)
        if self.verbose:
            logger.info("Start to fit HTFA")
        self.n_dim = R[0].shape[1]
        self.cov_vec_size = np.sum(np.arange(self.n_dim) + 1)
        self.map_offset = self.get_map_offset()
        self.prior_size = self.K * (self.n_dim + 1)
        self._fit_htfa(X, R, checkpoint_dir=checkpoint_dir,
                       checkpoint_every=checkpoint_every)
        return self
