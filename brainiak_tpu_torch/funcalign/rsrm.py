"""Robust Shared Response Model (RSRM), the port's.

PyTorch counterpart of ``brainiak_tpu.funcalign.rsrm``: each subject's
data is factorized as X_i ≈ W_i R + S_i with orthonormal W_i and an
l1-sparse individual term S_i, by block-coordinate descent (a
Procrustes W update, a soft-threshold S update, the averaged shared
response R).

The subjects are stacked into one zero-padded ``[subjects, voxels,
TRs]`` tensor as SRM's are (padding is exact: zero data rows give zero
W rows and zero S rows through every update), and the BCD loop is a
Python loop of tensor operations on the device, with the state ``s``,
as large as the data, kept there for the whole fit and fetched once.
The W update is :func:`~brainiak_tpu_torch.funcalign.srm._procrustes_batch`
with no perturbation, whose Gram ``eigh`` floors the eigenvalues of
the rank-deficient Grams RSRM meets.  With a ``mesh`` the stack is
laid out along its ``'subject'`` axis, as SRM's is, in one process or
across processes: there W and S stay rank-local, the R update's
``Σ_i W_iᵀ(X_i − S_i)`` and the objective are completed by one
``all_reduce`` each, and W and S come back whole on every rank by
``fetch_replicated`` at the end (see
:mod:`brainiak_tpu_torch.funcalign.srm`).  No hand-written kernel: the
JAX package runs all of it as XLA ops.

The chunk functions follow the dtype of their tensors; the estimator
fits in float32.  Its cost records (``obs.profile.profile_program``)
wait for the rest of ``obs``.
"""

import logging

import numpy as np
import torch

from ..device import resolve_device
from ..resilience.guards import (array_digest, check_state,
                                 make_device_carry_chunk,
                                 run_resilient_loop)
from ..parallel.mesh import (all_sum, cat_pieces, fetch_rows, local_pieces,
                             local_rows, split_rows)
from . import srm
from .srm import (NotFittedError, _assert_all_finite, _carry_whole, _host,
                  _procrustes, _procrustes_batch, _tensor)

__all__ = ["RSRM"]

logger = logging.getLogger(__name__)


def _shrink(v, gamma):
    """Soft-thresholding operator."""
    return torch.sign(v) * torch.clamp(torch.abs(v) - gamma, min=0.0)


def _shared_response(x, s, w, n_subjects):
    """Σ_i W_iᵀ (X_i − S_i) / n_subjects, [K, T] on ``w``'s device,
    the positions' partial sums added in position order (and over the
    ranks by one ``all_reduce``); ``s`` and ``w`` hold this process's
    subjects."""
    total = None
    for xk, sk, wk in zip(local_pieces(x), split_rows(x, s),
                          split_rows(x, w)):
        part = torch.einsum('svk,svt->kt', wk, xk - sk).to(w.device)
        total = part if total is None else total + part
    return all_sum(x, total) / n_subjects


def _rsrm_chunk(x, w, s, r, gamma, n_steps, mesh=None):
    """``n_steps`` RSRM BCD iterations from explicit state: the
    checkpointable unit of a preemption-safe fit."""
    n_subjects = x.shape[0]
    for _ in range(n_steps):
        a = cat_pieces([torch.einsum('svt,kt->svk', xk - sk,
                                     r.to(xk.device)).to(w.device)
                        for xk, sk in zip(local_pieces(x),
                                          split_rows(x, s))])
        w = _procrustes_batch(a, mesh, perturbation=0.0, x=x)
        s = cat_pieces([_shrink(xk - torch.einsum('svk,kt->svt', wk,
                                                  r.to(xk.device)), gamma)
                        .to(w.device)
                        for xk, wk in zip(local_pieces(x),
                                          split_rows(x, w))])
        r = _shared_response(x, s, w, n_subjects)
    return w, s, r


def _rsrm_objective(x, w, s, r, gamma):
    """½ Σ_i ||X_i − W_i R − S_i||²_F + γ Σ_i |S_i|_1."""
    total = None
    for xk, sk, wk in zip(local_pieces(x), split_rows(x, s),
                          split_rows(x, w)):
        resid = xk - torch.einsum('svk,kt->svt', wk, r.to(xk.device)) - sk
        part = (0.5 * torch.sum(torch.square(resid))
                + gamma * torch.sum(torch.abs(sk))).to(w.device)
        total = part if total is None else total + part
    return all_sum(x, total)


def _fit_rsrm(x, w0, gamma, n_iter, mesh=None):
    """The whole RSRM BCD fit from ``w0`` (this process's subjects):
    ``(w, s, r, objective)``, all tensors on ``w0``'s device (``w`` and
    ``s`` this process's subjects)."""
    s0 = torch.zeros(w0.shape[:2] + (local_pieces(x)[0].shape[2],),
                     dtype=w0.dtype, device=w0.device)
    r0 = _shared_response(x, s0, w0, x.shape[0])
    w, s, r = _rsrm_chunk(x, w0, s0, r0, gamma, n_iter, mesh=mesh)
    return w, s, r, _rsrm_objective(x, w, s, r, gamma)


def _transform_new_data(x, w, gamma, n_iter):
    """Alternating projection and shrinkage for new data of a fitted
    subject: ``(r, s)``."""
    s = torch.zeros_like(x)
    r = torch.zeros((w.shape[1], x.shape[1]), dtype=x.dtype,
                    device=x.device)
    for _ in range(n_iter):
        r = w.T @ (x - s)
        s = _shrink(x - w @ r, gamma)
    return r, s


def _transform_subject(x, r, gamma, n_iter):
    """Alternating Procrustes and shrinkage for a held-out subject:
    ``(w, s)``."""
    s = torch.zeros_like(x)
    w = torch.zeros((x.shape[0], r.shape[0]), dtype=x.dtype,
                    device=x.device)
    for _ in range(n_iter):
        w = _procrustes((x - s) @ r.T, 0.0)
        s = _shrink(x - w @ r, gamma)
    return w, s


class RSRM(srm._SRMBase):
    """Robust SRM.

    Parameters
    ----------
    n_iter : int, default 10
        Block-coordinate descent iterations (and the iterations of
        ``transform`` / ``transform_subject``).
    features : int, default 50
        Shared-space dimensionality K.
    gamma : float, default 1.0
        The l1 weight of the individual terms (the shrinkage).
    rand_seed : int, default 0
        Seed of the orthonormal W init (a CPU ``torch.Generator``).
    mesh, device
        As :class:`~brainiak_tpu_torch.funcalign.srm.SRM`'s.

    Attributes after fit (numpy): ``w_`` (orthonormal maps), ``r_``
    (shared response), ``s_`` (sparse individual terms),
    ``objective_``.
    """

    _param_names = ("n_iter", "features", "gamma", "rand_seed", "mesh",
                    "device")

    def __init__(self, n_iter=10, features=50, gamma=1.0, rand_seed=0,
                 mesh=None, device="cuda"):
        super().__init__(n_iter=n_iter, features=features,
                         rand_seed=rand_seed, mesh=mesh, device=device)
        self.gamma = gamma

    def _validate(self, X):
        if self.gamma <= 0.0:
            raise ValueError("Gamma parameter should be positive.")
        if len(X) <= 1:
            raise ValueError("There are not enough subjects in the input "
                             "data to train the model.")
        if X[0].shape[1] < self.features:
            raise ValueError(
                "There are not enough timepoints to train the model with "
                "{0:d} features.".format(self.features))
        number_trs = X[0].shape[1]
        for subject in range(len(X)):
            _assert_all_finite(X[subject])
            if X[subject].shape[1] != number_trs:
                raise ValueError("Different number of alignment timepoints "
                                 "between subjects.")

    def fit(self, X, y=None, checkpoint_dir=None, checkpoint_every=5):
        """Fit the robust SRM in float32 on the device.  With
        ``checkpoint_dir``, BCD state is saved every
        ``checkpoint_every`` iterations under the resilience guard
        (non-finite rollback) and a later call resumes from the latest
        checkpoint.

        Example
        -------
        >>> rsrm = RSRM(n_iter=20, features=10, gamma=1.0)
        >>> rsrm.fit(data, checkpoint_dir="/ckpts/rsrm1")  # resumable

        Across processes as :meth:`~brainiak_tpu_torch.funcalign.srm
        .SRM.fit` (the checkpointed state, S included, whole on every
        rank).
        """
        logger.info('Starting RSRM')
        x, stacked, voxel_counts, _, _, _, w0, dev = \
            self._prepare(X, demean=False)
        if checkpoint_dir is None:
            w, s, r, objective = _fit_rsrm(x, w0, self.gamma, self.n_iter,
                                           mesh=self.mesh)
        else:
            w, s, r, objective = self._fit_checkpointed(
                x, w0, dev, array_digest(stacked), checkpoint_dir,
                checkpoint_every)
        w, s = fetch_rows(x, w), fetch_rows(x, s)
        self.w_ = [w[i, :voxel_counts[i]] for i in range(len(X))]
        self.s_ = [s[i, :voxel_counts[i]] for i in range(len(X))]
        self.r_ = _host(r)
        self.objective_ = float(objective)
        check_state({"w": w, "s": s, "r": self.r_,
                     "objective": self.objective_},
                    iteration=self.n_iter, where="RSRM.fit")
        return self

    def _fit_checkpointed(self, x, w0, dev, data_digest, checkpoint_dir,
                          checkpoint_every):
        """Chunked BCD under the resilient loop (guard, rollback,
        checkpoint and resume, fault hooks)."""
        n_subjects, voxels_pad = x.shape[0], w0.shape[1]
        trs = local_pieces(x)[0].shape[2]
        fingerprint = np.array(
            [data_digest, float(trs), float(voxels_pad),
             float(n_subjects), float(self.features),
             float(self.rand_seed), float(self.gamma)])
        s0 = torch.zeros(w0.shape[:2] + (trs,), dtype=w0.dtype,
                         device=dev)
        r0 = _shared_response(x, s0, w0, n_subjects)
        init_state = {"w": fetch_rows(x, w0),
                      "s": np.zeros((n_subjects, voxels_pad, trs),
                                    dtype=np.float32),
                      "r": _host(r0)}
        run_chunk, final_leaves = make_device_carry_chunk(
            _carry_whole(x, lambda leaves, n: _rsrm_chunk(
                x, *leaves, self.gamma, n, mesh=self.mesh),
                (True, True, False)),
            ("w", "s", "r"), dtype=torch.float32, device=dev)
        state, step = run_resilient_loop(
            run_chunk, init_state, self.n_iter,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            fingerprint=fingerprint, name="RSRM.fit")
        w, s, r = final_leaves(state, step)
        w, s = local_rows(x, w), local_rows(x, s)
        return w, s, r, _rsrm_objective(x, w, s, r, self.gamma)

    def _tensors(self, *arrays):
        """``arrays`` on ``device`` in their promoted dtype (at least
        float32)."""
        dev = resolve_device(self.device)
        dtype = np.result_type(*(np.asarray(a).dtype for a in arrays))
        return [_tensor(a, dtype, dev) for a in arrays]

    def transform(self, X, y=None):
        """``(shared responses, individual terms)`` of new data of the
        fitted subjects (``None`` entries pass through), on ``device``;
        returns numpy."""
        if not hasattr(self, 'w_'):
            raise NotFittedError("The model fit has not been run yet.")
        if len(X) != len(self.w_):
            raise ValueError("The number of subjects does not match the one"
                             " in the model.")
        r = [None] * len(X)
        s = [None] * len(X)
        for subject in range(len(X)):
            if X[subject] is not None:
                rj, sj = _transform_new_data(
                    *self._tensors(X[subject], self.w_[subject]),
                    self.gamma, self.n_iter)
                r[subject], s[subject] = _host(rj), _host(sj)
        return r, s

    def transform_subject(self, X):
        """``(w, s)`` of a held-out subject against the fitted shared
        response, on ``device``; returns numpy."""
        if not hasattr(self, 'w_'):
            raise NotFittedError("The model fit has not been run yet.")
        if X.shape[1] != self.r_.shape[1]:
            raise ValueError("The number of timepoints(TRs) does not match "
                             "the one in the model.")
        w, s = _transform_subject(*self._tensors(X, self.r_), self.gamma,
                                  self.n_iter)
        return _host(w), _host(s)
