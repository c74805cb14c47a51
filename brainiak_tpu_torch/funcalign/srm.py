"""Probabilistic and deterministic Shared Response Model (SRM), the port's.

PyTorch counterpart of ``brainiak_tpu.funcalign.srm``.  The model is
X_i ≈ W_i S with orthonormal per-subject maps W_i; the probabilistic
variant adds a Normal prior S ~ N(0, Σ_s) and per-subject noise ρ_i².

The subjects are stacked into one ``[subjects, voxels, TRs]`` tensor,
zero-padded to a common voxel count (exact for every EM quantity: the
pad rows of W stay zero, and the per-subject voxel counts enter ρ² and
the log-likelihood explicitly), and the EM loop is a Python loop of
tensor operations on ``device`` with no host read inside it: the
subject-summed ``Σ_i W_iᵀX_i/ρ_i²`` and ``X_i Sᵀ`` are one long
product each, the Σ_s solves are Cholesky solves, and the per-subject
W updates are polar factors of [V, K] matrices (a K x K ``eigh`` of
their Gram each).  None of it is a hand-written kernel: the JAX
package computes all of it as XLA ops, outside any Pallas kernel.

The chunk functions (:func:`_em_chunk`, :func:`_det_chunk`) follow the
dtype of the tensors they are given; the estimators fit in float32 on
the card and on the CPU alike.  With a ``mesh`` the stacked data is
laid out along its ``'subject'`` axis (a
:class:`~brainiak_tpu_torch.parallel.mesh.Sharded`): each position's
products run on its own device, the partial ``Σ_i W_iᵀX_i/ρ_i²`` are
added in position order on the first device, and the W solves go
through :func:`brainiak_tpu_torch.ops.distla.shard_vmap`.

Across processes (a mesh of
:func:`~brainiak_tpu_torch.parallel.mesh.initialize_distributed`, every
rank calling ``fit`` on the whole list of subjects) the stack and W
stay rank-local: each rank holds and updates its own subjects only (W
as a tensor of its subjects' rows on its first position's device).
Every sum over subjects is completed by one ``all_reduce`` of the
ranks' partial sums: ``Σ_i W_iᵀX_i/ρ_i²`` ([K, T]) an EM iteration,
DetSRM's ``Σ_i W_iᵀX_i`` an iteration, and the objectives once.  The
per-subject leaves ``rho2``, ``trace_xtx`` and ``voxel_counts`` are kept
whole on every rank: each rank computes its subjects' ``rho2`` and one
``all_gather`` an iteration brings the whole vector, so ``rho0``, the
traces and ``log_det_psi`` are computed on every rank alike.  W0 is
drawn whole on every rank (one CPU ``torch.Generator``) and each keeps
its rows, so a fit over ranks starts from the single-process W0.  At
the end W (and RSRM's S) come back whole on every rank by
:func:`~brainiak_tpu_torch.parallel.mesh.fetch_replicated`: no fit
returns a rank-partial result.

Left out for now: a ``SubjectStore`` passed to ``fit`` (the data plane,
ROADMAP item 13) raises ``NotImplementedError``; the JAX package's
cost records of its compiled programs (``obs.profile.profile_program``)
wait for the rest of ``obs``.  With ``checkpoint_dir`` each chunk runs
under the resilient loop's ``fit_chunk`` span.
"""

import logging

import numpy as np
import torch

from ..device import resolve_device
from ..ops import distla
from ..parallel.mesh import (DEFAULT_SUBJECT_AXIS, all_sum, axis_devices,
                             axis_ranks, cat_pieces, fetch_rows,
                             gather_rows, laid_out_rows, local_pieces,
                             local_rows, process_index, shard_along,
                             spans_processes, split_rows)
from ..resilience.guards import (array_digest, check_state,
                                 make_device_carry_chunk,
                                 run_resilient_loop)

__all__ = ["DetSRM", "NotFittedError", "SRM", "load"]

logger = logging.getLogger(__name__)

# Polar-factor algorithm for the tall W update: "eigh" (Gram
# eigendecomposition, exact, the default) or "ns" (matmul-only
# Newton-Schulz, see _polar_ns).  Read at each call.
POLAR_METHOD = "eigh"


class NotFittedError(ValueError, AttributeError):
    """The model fit has not been run yet (the bases of
    ``sklearn.exceptions.NotFittedError``, which the port does not
    import)."""


def _polar_ns(ap, n_iters=24):
    """Matmul-only polar factor via the coupled Newton-Schulz iteration
    on the K x K Gram: ``Y -> c^(1/2)``, ``Z -> c^(-1/2)`` for
    ``c = apᵀap / s`` (``s`` a row-sum bound on the spectral radius),
    then ``W = ap (c/s)^(-1/2) / sqrt(s)``.

    Accuracy is floored by the working precision on the squared
    condition number of the Gram (max error against the SVD polar
    factor about eps * kappa(a)^2): in float32 a faithful polar factor
    only for kappa up to about 30-100.  The caller's Newton-Schulz
    orthogonality scrub runs after either path.
    """
    k = ap.shape[1]
    c = ap.T @ ap
    # spectral bound: max absolute row sum (>= lambda_max); guard zeros
    s = torch.clamp(torch.max(torch.sum(torch.abs(c), dim=1)),
                    min=torch.finfo(ap.dtype).tiny)
    eye = torch.eye(k, dtype=ap.dtype, device=ap.device)
    # relative spectrum floor: Gram eigenvalues that round negative
    # diverge under the Newton-Schulz map; a ridge of ~100 ulp pins
    # them just inside (0, 1]
    floor = 100.0 * torch.finfo(ap.dtype).eps
    y, z = c / s + floor * eye, eye
    for _ in range(n_iters):
        m = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ m, m @ z
    return ap @ (z / torch.sqrt(s))


def _procrustes(a, perturbation=0.001):
    """Orthogonal map closest to ``a`` ([voxels, features]): U Vᵀ of
    ``a`` plus a ``perturbation`` on its diagonal (RSRM passes 0).

    For tall inputs (``v >= 4 k``) the polar factor comes from the
    Gram: ``A (AᵀA)^(-1/2)`` by a K x K ``eigh`` with a relative
    eigenvalue floor, then two Newton-Schulz steps ``W(3I - WᵀW)/2``
    scrub the orthogonality error that squaring the condition number
    costs; otherwise from the thin SVD.
    """
    v, kk = a.shape
    ap = a + perturbation * torch.eye(v, kk, dtype=a.dtype,
                                      device=a.device)
    if v >= 4 * kk:
        # "ns" only where perturbation != 0: RSRM's and FastSRM's
        # perturbation=0 calls can be severely rank-deficient, where
        # the eigh spectrum handling is the safer choice
        if POLAR_METHOD == "ns" and perturbation != 0:
            w = _polar_ns(ap)
        else:
            lam, q = torch.linalg.eigh(ap.T @ ap)
            # relative floor, with a sqrt-tiny absolute guard for an
            # all-zero input: rank-deficient Grams have eigenvalues
            # rounding to ~0 or below, and lam**-0.5 would overflow
            floor = torch.clamp(torch.finfo(a.dtype).eps * torch.max(lam),
                                min=torch.finfo(a.dtype).tiny ** 0.5)
            lam = torch.maximum(lam, floor)
            w = ap @ ((q * lam ** -0.5) @ q.T)
        eye_k = torch.eye(kk, dtype=a.dtype, device=a.device)
        for _ in range(2):
            w = 0.5 * (w @ (3.0 * eye_k - w.T @ w))
        return w
    u, _, vt = torch.linalg.svd(ap, full_matrices=False)
    return u @ vt


def _procrustes_batch(a, mesh, perturbation=0.001, x=None):
    """Per-subject Procrustes W updates of a stacked [S, V, K] batch,
    laid out along the mesh's subject axis by
    :func:`~brainiak_tpu_torch.ops.distla.shard_vmap` (a plain vmap
    without a mesh); per-subject numerics are the same either way.
    Across processes ``a`` holds this rank's subjects of the stack
    ``x``: it goes to ``shard_vmap`` laid out as ``x`` is, and this
    rank's rows come back."""
    fn = lambda m: _procrustes(m, perturbation=perturbation)  # noqa: E731
    if spans_processes(x):
        out = distla.shard_vmap(fn, mesh, DEFAULT_SUBJECT_AXIS,
                                x.shape[0])(laid_out_rows(x, a))
        return cat_pieces([c.to(a.device) for _, c, _ in out.local()])
    return distla.shard_vmap(fn, mesh, DEFAULT_SUBJECT_AXIS,
                             a.shape[0])(a)


def _init_w(rand_seed, voxels_pad, n_subjects, features, voxel_counts,
            dtype=torch.float32, device="cpu"):
    """Random orthonormal init per subject via QR, with rows beyond each
    subject's voxel count zeroed.  The uniform draw comes from a CPU
    ``torch.Generator`` seeded with ``rand_seed``, so one seed gives
    one draw whatever the device; the QR runs on ``device``.
    ``voxel_counts`` is a tensor on ``device``."""
    gen = torch.Generator().manual_seed(int(rand_seed))
    rnd = torch.rand((n_subjects, voxels_pad, features), generator=gen,
                     dtype=dtype).to(device)
    row = torch.arange(voxels_pad, device=device)[None, :, None]
    keep = row < voxel_counts[:, None, None]
    q, _ = torch.linalg.qr(torch.where(keep, rnd, 0.0))
    return torch.where(keep, q, 0.0)


def _wt_x(w, x):
    """Σ_i W_iᵀ X_i, [K, T] on ``w``'s device: one product over every
    subject, or one a position with the partial sums added in
    position order (and over the ranks by one ``all_reduce``)."""
    total = None
    for wk, xk in zip(split_rows(x, w), local_pieces(x)):
        part = torch.einsum('svk,svt->kt', wk, xk).to(w.device)
        total = part if total is None else total + part
    return all_sum(x, total)


def _x_st(x, shared):
    """X_i Sᵀ for every subject this process holds, [S, V, K] on
    ``shared``'s device."""
    return cat_pieces([torch.einsum('svt,kt->svk', xk,
                                    shared.to(xk.device)).to(shared.device)
                       for xk in local_pieces(x)])


def _cho_inverse(mat, eye):
    """(Cholesky factor, inverse) of the SPD ``mat``; no error check,
    so no host read."""
    chol, _ = torch.linalg.cholesky_ex(mat)
    return chol, torch.cholesky_solve(eye, chol)


def _em_iteration(x, w, rho2, sigma_s, trace_xtx, voxel_counts, samples,
                  mesh=None):
    """One probabilistic-SRM EM iteration on stacked data ``x`` (a
    tensor, or a subject-laid-out ``Sharded``): ``w`` holds this
    process's subjects, ``rho2``, ``trace_xtx`` and ``voxel_counts``
    every subject's."""
    features = sigma_s.shape[0]
    eye = torch.eye(features, dtype=sigma_s.dtype, device=sigma_s.device)

    rho0 = torch.sum(1.0 / rho2)
    _, inv_sigma_s = _cho_inverse(sigma_s, eye)
    _, inv_sigma_s_rhos = _cho_inverse(inv_sigma_s + eye * rho0, eye)

    wt_invpsi_x = _wt_x(w / local_rows(x, rho2)[:, None, None], x)

    shared = sigma_s @ (eye - rho0 * inv_sigma_s_rhos) @ wt_invpsi_x
    sigma_s = inv_sigma_s_rhos + shared @ shared.T / samples
    trace_sigma_s = samples * torch.trace(sigma_s)

    a = _x_st(x, shared)
    w = _procrustes_batch(a, mesh, x=x)
    rho2 = gather_rows(x, (local_rows(x, trace_xtx)
                           - 2.0 * torch.sum(w * a, dim=(1, 2))
                           + trace_sigma_s)
                       / (samples * local_rows(x, voxel_counts)))
    return w, rho2, sigma_s, shared, wt_invpsi_x, inv_sigma_s_rhos


def _srm_log_likelihood(sigma_s, rho2, voxel_counts, wt_invpsi_x,
                        inv_sigma_s_rhos, trace_xt_invsigma2_x, samples):
    """Marginal log-likelihood up to a constant."""
    features = sigma_s.shape[0]
    eye = torch.eye(features, dtype=sigma_s.dtype, device=sigma_s.device)
    rho0 = torch.sum(1.0 / rho2)
    chol, inv_sigma_s = _cho_inverse(sigma_s, eye)
    log_det_sigma_s = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    chol_rhos, _ = torch.linalg.cholesky_ex(inv_sigma_s + eye * rho0)
    log_det_rhos = 2.0 * torch.sum(torch.log(torch.diagonal(chol_rhos)))
    log_det_psi = torch.sum(torch.log(rho2) * voxel_counts)
    log_det = log_det_rhos + log_det_psi + log_det_sigma_s
    ll = -0.5 * samples * log_det - 0.5 * trace_xt_invsigma2_x
    return ll + 0.5 * torch.trace(
        wt_invpsi_x.T @ inv_sigma_s_rhos @ wt_invpsi_x)


def _em_chunk(x, trace_xtx, voxel_counts, w, rho2, sigma_s, shared,
              n_steps, mesh=None):
    """Run ``n_steps`` EM iterations from explicit state: the
    checkpointable unit of a preemption-safe fit."""
    samples = shared.shape[1]
    for _ in range(n_steps):
        w, rho2, sigma_s, shared, _, _ = _em_iteration(
            x, w, rho2, sigma_s, trace_xtx, voxel_counts, samples,
            mesh=mesh)
    return w, rho2, sigma_s, shared


def _final_log_likelihood(x, w, rho2, sigma_s, trace_xtx, voxel_counts,
                          mesh=None):
    """Marginal log-likelihood at the current EM state (shared by the
    plain and checkpointed fit paths)."""
    samples = _samples(x)
    trace_xt_invsigma2_x = torch.sum(trace_xtx / rho2)
    _, _, _, _, wt_invpsi_x, inv_sigma_s_rhos = _em_iteration(
        x, w, rho2, sigma_s, trace_xtx, voxel_counts, samples,
        mesh=mesh)
    return _srm_log_likelihood(sigma_s, rho2, voxel_counts, wt_invpsi_x,
                               inv_sigma_s_rhos, trace_xt_invsigma2_x,
                               samples)


def _samples(x):
    return local_pieces(x)[0].shape[2]


def _fit_prob_srm(x, trace_xtx, voxel_counts, w0, n_iter, mesh=None):
    """Full probabilistic-SRM EM fit from ``w0`` (this process's
    subjects), on ``w0``'s device: ``(w, rho2, sigma_s, shared,
    log-likelihood)``, all tensors (``w`` this process's subjects)."""
    n_subjects, features = x.shape[0], w0.shape[2]
    kw = dict(dtype=w0.dtype, device=w0.device)
    rho2 = torch.ones(n_subjects, **kw)
    sigma_s = torch.eye(features, **kw)
    shared = torch.zeros((features, _samples(x)), **kw)
    w, rho2, sigma_s, shared = _em_chunk(
        x, trace_xtx, voxel_counts, w0, rho2, sigma_s, shared,
        n_steps=n_iter, mesh=mesh)
    ll = _final_log_likelihood(x, w, rho2, sigma_s, trace_xtx,
                               voxel_counts, mesh=mesh)
    return w, rho2, sigma_s, shared, ll


def _det_chunk(x, w, shared, n_steps, mesh=None):
    """``n_steps`` deterministic-SRM block-coordinate descent
    iterations from explicit state: the checkpointable unit."""
    n_subjects = x.shape[0]
    for _ in range(n_steps):
        w = _procrustes_batch(_x_st(x, shared), mesh, x=x)
        shared = _wt_x(w, x) / n_subjects
    return w, shared


def _carry_whole(x, chunk, per_subject):
    """``chunk(leaves, n_steps)``, which takes and returns this
    process's rows of the leaves flagged in ``per_subject``, as a
    function of whole leaves.  The checkpointed loop holds every
    subject's state on every process, as the JAX package's does (its
    chunks fetch each leaf with ``fetch_replicated``), so that each
    rank's guard and checkpoint see the whole state: across processes
    one ``all_gather`` a flagged leaf a chunk, nothing in one
    process."""
    def run(leaves, n_steps):
        out = chunk([local_rows(x, v) if f else v
                     for v, f in zip(leaves, per_subject)], n_steps)
        return tuple(gather_rows(x, v) if f else v
                     for v, f in zip(out, per_subject))
    return run


def _det_objective(x, w, shared):
    """Σ_i ||X_i − W_i S||²_F / 2."""
    total = None
    for wk, xk in zip(split_rows(x, w), local_pieces(x)):
        resid = xk - torch.einsum('svk,kt->svt', wk, shared.to(xk.device))
        part = torch.sum(torch.square(resid)).to(w.device)
        total = part if total is None else total + part
    return all_sum(x, total) / 2.0


def _fit_det_srm(x, w0, n_iter, mesh=None):
    """Deterministic SRM block-coordinate descent from ``w0``:
    alternate Procrustes W updates with S = mean_i W_iᵀ X_i.
    Returns ``(w, shared, objective)``, all tensors."""
    shared = _wt_x(w0, x) / x.shape[0]
    w, shared = _det_chunk(x, w0, shared, n_steps=n_iter, mesh=mesh)
    return w, shared, _det_objective(x, w, shared)


def _stack_and_pad(X, dtype, demean=True):
    """Stack a list of [voxels_i, samples] arrays into
    ([S, V_max, T], voxel_counts, means, trace_xtx); optionally demeaned
    over samples (probabilistic SRM demeans; DetSRM does not)."""
    voxel_counts = np.array([d.shape[0] for d in X], dtype=np.int64)
    samples = X[0].shape[1]
    v_max = int(voxel_counts.max())
    stacked = np.zeros((len(X), v_max, samples), dtype=dtype)
    mu = []
    trace_xtx = np.zeros(len(X), dtype=dtype)
    for i, d in enumerate(X):
        d = np.asarray(d, dtype=dtype)
        m = d.mean(axis=1)
        mu.append(m)
        # the trace is of the RAW data even though the EM runs on
        # demeaned data (as in the reference implementation)
        trace_xtx[i] = np.sum(d ** 2)
        if demean:
            d = d - m[:, None]
        stacked[i, :d.shape[0]] = d
    return stacked, voxel_counts, mu, trace_xtx


def _refuse_store(X):
    """The JAX package streams a ``SubjectStore`` (anything with its
    ``read`` / ``voxel_counts`` / ``digests`` surface) from disk; the
    port has no data plane yet."""
    if all(hasattr(X, a) for a in ("read", "voxel_counts", "digests")):
        raise NotImplementedError(
            "fitting from a SubjectStore needs the data plane "
            "(data/, ROADMAP queue A item 13), which is not ported "
            "yet; pass a list of [voxels, samples] arrays")


def _assert_all_finite(d):
    d = np.asarray(d)
    if d.dtype.kind in "fc" and not np.isfinite(d).all():
        raise ValueError("Input contains NaN, infinity or a value too "
                         "large for dtype({!r}).".format(d.dtype.name))


def _host(t):
    return t.detach().cpu().numpy()


def _tensor(a, dtype, dev):
    """``a`` as a tensor on ``dev`` in the numpy ``dtype`` (at least
    float32), converted on the host before the copy."""
    dtype = np.result_type(dtype, np.float32)
    return torch.as_tensor(np.asarray(a, dtype=dtype), device=dev)


class _Estimator:
    """``get_params`` / ``set_params`` over the constructor parameters
    named in ``_param_names`` (the port imports no sklearn)."""

    _param_names = ()

    def get_params(self, deep=True):
        del deep
        return {k: getattr(self, k) for k in self._param_names}

    def set_params(self, **params):
        for k, v in params.items():
            if k not in self._param_names:
                raise ValueError(f"invalid parameter {k!r}")
            setattr(self, k, v)
        return self


class _SRMBase(_Estimator):

    _param_names = ("n_iter", "features", "rand_seed", "mesh", "device")

    def __init__(self, n_iter=10, features=50, rand_seed=0, mesh=None,
                 device="cuda"):
        self.n_iter = n_iter
        self.features = features
        self.rand_seed = rand_seed
        self.mesh = mesh
        self.device = device

    # -- the estimator interface -----------------------------------------
    def fit_transform(self, X, y=None, **fit_params):
        return self.fit(X, y, **fit_params).transform(X)

    # -- common checks ----------------------------------------------------
    def _validate(self, X):
        if len(X) <= 1:
            raise ValueError("There are not enough subjects "
                             "({0:d}) to train the model.".format(len(X)))
        samples = X[0].shape[1]
        for d in X:
            _assert_all_finite(d)
            if d.shape[1] != samples:
                raise ValueError(
                    "Different number of samples between subjects.")
        if samples < self.features:
            raise ValueError(
                "There are not enough samples to train the model with "
                "{0:d} features.".format(self.features))

    def _fit_device(self):
        """The device of the fit's state: the first position along the
        mesh's subject axis that this process holds, else ``device``
        (raises without a card unless it is the CPU)."""
        if self.mesh is not None:
            devices = axis_devices(self.mesh, DEFAULT_SUBJECT_AXIS)
            ranks = axis_ranks(self.mesh, DEFAULT_SUBJECT_AXIS)
            me = process_index()
            mine = [d for k, d in enumerate(devices)
                    if ranks is None or ranks[k] == me]
            # a rank with no position raises in shard_along
            return mine[0] if mine else devices[0]
        return resolve_device(self.device)

    def _device_place(self, stacked, dev):
        """The host stack on the device: laid out along the mesh's
        subject axis (a :class:`~brainiak_tpu_torch.parallel.mesh
        .Sharded`), or one tensor on ``dev``."""
        if self.mesh is not None:
            resolve_device(dev)
            return shard_along(stacked, self.mesh, DEFAULT_SUBJECT_AXIS, 0)
        return torch.from_numpy(stacked).to(dev)

    def _prepare(self, X, demean):
        """Validate, stack and place ``X``; draw ``w0`` (every subject's,
        then this process's rows of it).  Returns ``(x, host stack,
        voxel counts, means, trace, w0, dev)``."""
        _refuse_store(X)
        self._validate(X)
        dev = self._fit_device()
        stacked, voxel_counts, mu, trace_xtx = _stack_and_pad(
            X, np.float32, demean=demean)
        x = self._device_place(stacked, dev)
        counts = torch.from_numpy(voxel_counts.astype(np.float32)).to(dev)
        n_subjects, voxels_pad, _ = stacked.shape
        w0 = local_rows(x, _init_w(self.rand_seed, voxels_pad, n_subjects,
                                   self.features, counts,
                                   dtype=torch.float32, device=dev))
        trace = torch.from_numpy(trace_xtx).to(dev)
        return x, stacked, voxel_counts, counts, mu, trace, w0, dev

    def _fingerprint(self, digest, stacked):
        n_subjects, voxels_pad, samples = stacked.shape
        return np.array([digest, float(samples), float(voxels_pad),
                         float(n_subjects), float(self.features),
                         float(self.rand_seed)])

    # -- shared API -------------------------------------------------------
    def transform(self, X, y=None):
        """Project each subject's data into shared space: s_i = W_iᵀ X_i
        (numpy, on the host)."""
        if not hasattr(self, 'w_'):
            raise NotFittedError("The model fit has not been run yet.")
        if len(X) != len(self.w_):
            raise ValueError("The number of subjects does not match the one"
                             " in the model.")
        return [None if x is None else self.w_[i].T.dot(x)
                for i, x in enumerate(X)]

    def transform_subject(self, X):
        """Procrustes map for a held-out subject against the fitted
        shared response: U Vᵀ of ``X Sᵀ`` by an SVD on ``device``, in
        the promoted dtype of ``X`` and ``s_``; returns numpy."""
        if not hasattr(self, 'w_'):
            raise NotFittedError("The model fit has not been run yet.")
        if X.shape[1] != self.s_.shape[1]:
            raise ValueError("The number of timepoints(TRs) does not match "
                             "the one in the model.")
        dev = resolve_device(self.device)
        dtype = np.result_type(np.asarray(X).dtype, self.s_.dtype,
                               np.float32)
        x = torch.tensor(np.asarray(X, dtype=dtype), device=dev)
        s = torch.tensor(np.asarray(self.s_, dtype=dtype), device=dev)
        u, _, vt = torch.linalg.svd(x @ s.T, full_matrices=False)
        return _host(u @ vt)


class SRM(_SRMBase):
    """Probabilistic Shared Response Model.

    Parameters
    ----------
    n_iter : int, default 10
        Number of EM iterations.
    features : int, default 50
        Shared-space dimensionality K.
    rand_seed : int, default 0
        Seed of the orthonormal W init (a CPU ``torch.Generator``).
    mesh : :class:`~brainiak_tpu_torch.parallel.mesh.Mesh`, optional
        Lays the stacked data out along its ``'subject'`` axis (whose
        size must divide the number of subjects); the fit's state
        lives on the axis' first device (this process's first, across
        processes: see the module docstring).
    device : str or torch.device, default "cuda"
        Where the fit runs without a mesh (raises without a card unless
        it is ``"cpu"``), and where ``transform_subject`` runs.

    Attributes (after fit, numpy)
    -----------------------------
    w_ : list of [voxels_i, features] orthonormal maps
    s_ : [features, samples] shared response
    sigma_s_ : [features, features] shared-response covariance
    mu_ : list of [voxels_i] voxel means
    rho2_ : [subjects] noise variances
    logprob_ : final marginal log-likelihood (up to a constant)
    """

    def fit(self, X, y=None, checkpoint_dir=None, checkpoint_every=5):
        """Fit the model in float32 on the device, with one host fetch
        at the end.  With ``checkpoint_dir``, EM state is saved every
        ``checkpoint_every`` iterations and a later call resumes from
        the latest checkpoint; the checkpointed loop runs under the
        resilience guard (non-finite EM state rolls back to the last
        good checkpoint, and persistent divergence aborts with
        :class:`~brainiak_tpu_torch.resilience.DivergenceError`).
        Across processes every rank calls ``fit`` with every subject,
        and every rank gets the whole model.  With ``checkpoint_dir``
        there every rank holds the whole EM state, guards it and saves
        it to ``checkpoint_dir``, as the JAX package's ranks do: a
        directory the ranks share gets the same files from each, each
        written to a temporary name and renamed atomically, and a
        resume restores the whole state on every rank, which keeps its
        own subjects.

        Example
        -------
        >>> srm = SRM(n_iter=20, features=10)
        >>> srm.fit(data, checkpoint_dir="/ckpts/srm_run1")  # preempted
        >>> srm.fit(data, checkpoint_dir="/ckpts/srm_run1")  # resumes
        """
        logger.info('Starting Probabilistic SRM')
        x, stacked, voxel_counts, counts, mu, trace, w0, dev = \
            self._prepare(X, demean=True)
        if checkpoint_dir is None:
            w, rho2, sigma_s, shared, ll = _fit_prob_srm(
                x, trace, counts, w0, self.n_iter, mesh=self.mesh)
        else:
            # the digest of the host stack and the voxel means (the
            # stack is demeaned, so X and X + c would otherwise collide)
            fingerprint = self._fingerprint(array_digest(stacked, *mu),
                                            stacked)
            w, rho2, sigma_s, shared, ll = self._fit_checkpointed(
                x, trace, counts, w0, dev, fingerprint, checkpoint_dir,
                checkpoint_every)

        w = fetch_rows(x, w)
        self.w_ = [w[i, :voxel_counts[i]] for i in range(len(X))]
        self.s_ = _host(shared)
        self.sigma_s_ = _host(sigma_s)
        self.mu_ = mu
        self.rho2_ = _host(rho2)
        self.logprob_ = float(ll)
        # non-finite guard on the fitted state (the checkpointed path
        # guards every chunk; the plain path is guarded here)
        check_state({"w": w, "rho2": self.rho2_, "sigma_s": self.sigma_s_,
                     "shared": self.s_, "logprob": self.logprob_},
                    iteration=self.n_iter, where="SRM.fit")
        logger.info('Objective function %f', self.logprob_)
        return self

    def _fit_checkpointed(self, x, trace, counts, w0, dev, fingerprint,
                          checkpoint_dir, checkpoint_every):
        """Chunked EM under the resilient loop: npz checkpoints
        between chunks, non-finite guard with rollback, and the fault
        injection hooks."""
        n_subjects, features = x.shape[0], w0.shape[2]
        samples = _samples(x)
        init_state = {
            "w": fetch_rows(x, w0),
            "rho2": np.ones(n_subjects, dtype=np.float32),
            "sigma_s": np.eye(features, dtype=np.float32),
            "shared": np.zeros((features, samples), dtype=np.float32),
        }
        run_chunk, final_leaves = make_device_carry_chunk(
            _carry_whole(x, lambda leaves, n: _em_chunk(
                x, trace, counts, *leaves, n_steps=n, mesh=self.mesh),
                (True, False, False, False)),
            ("w", "rho2", "sigma_s", "shared"), dtype=torch.float32,
            device=dev)
        state, step = run_resilient_loop(
            run_chunk, init_state, self.n_iter,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            fingerprint=fingerprint, name="SRM.fit",
            progress_objective="rho2", progress_direction="min")
        w, rho2, sigma_s, shared = final_leaves(state, step)
        w = local_rows(x, w)
        ll = _final_log_likelihood(x, w, rho2, sigma_s, trace, counts,
                                   mesh=self.mesh)
        return w, rho2, sigma_s, shared, ll

    def save(self, file):
        """Persist the fitted model as .npz, in the JAX package's
        format: stacked arrays for uniform voxel counts (readable with
        pickle disabled), object arrays for ragged ones."""
        if not hasattr(self, 'w_'):
            raise NotFittedError("The model fit has not been run yet.")
        if len({w.shape for w in self.w_}) == 1:
            w_arr = np.stack(self.w_)
            mu_arr = np.stack(self.mu_)
        else:
            w_arr = np.empty(len(self.w_), dtype=object)
            mu_arr = np.empty(len(self.mu_), dtype=object)
            for i in range(len(self.w_)):
                w_arr[i] = self.w_[i]
                mu_arr[i] = self.mu_[i]
        np.savez_compressed(
            file,
            w_=w_arr,
            s_=self.s_,
            sigma_s_=self.sigma_s_,
            mu_=mu_arr,
            rho2_=self.rho2_,
            kwargs=np.array([self.features, self.n_iter, self.rand_seed]))


def load(file, device="cuda"):
    """Load a fitted SRM saved by :meth:`SRM.save` (or by the JAX
    package's); ``device`` is the loaded model's."""
    loaded = np.load(file, allow_pickle=True)
    features, n_iter, rand_seed = (int(v) for v in loaded['kwargs'])
    srm = SRM(n_iter=n_iter, features=features, rand_seed=rand_seed,
              device=device)
    srm.w_ = [np.asarray(s) for s in loaded['w_']]
    srm.s_ = np.asarray(loaded['s_'])
    srm.sigma_s_ = np.asarray(loaded['sigma_s_'])
    srm.mu_ = [np.asarray(s) for s in loaded['mu_']]
    srm.rho2_ = np.asarray(loaded['rho2_'])
    return srm


class DetSRM(_SRMBase):
    """Deterministic SRM: minimize Σ_i ||X_i − W_i S||²_F with
    orthonormal W_i by block-coordinate descent (parameters and
    ``device`` as :class:`SRM`; fitted ``w_``, ``s_`` and
    ``objective_``)."""

    def fit(self, X, y=None, checkpoint_dir=None, checkpoint_every=5):
        """Fit the deterministic SRM in float32 on the device.  With
        ``checkpoint_dir``, BCD state is saved every
        ``checkpoint_every`` iterations under the resilience guard and
        a later call resumes from the latest checkpoint.

        Example
        -------
        >>> det = DetSRM(n_iter=30, features=10)
        >>> det.fit(data, checkpoint_dir="/ckpts/det_run1")  # resumable

        Across processes as :meth:`SRM.fit`.
        """
        logger.info('Starting Deterministic SRM')
        x, stacked, voxel_counts, _, _, _, w0, dev = \
            self._prepare(X, demean=False)
        if checkpoint_dir is None:
            w, shared, objective = _fit_det_srm(x, w0, self.n_iter,
                                                mesh=self.mesh)
        else:
            fingerprint = self._fingerprint(array_digest(stacked),
                                            stacked)
            w, shared, objective = self._fit_checkpointed(
                x, w0, dev, fingerprint, checkpoint_dir,
                checkpoint_every)

        w = fetch_rows(x, w)
        self.w_ = [w[i, :voxel_counts[i]] for i in range(len(X))]
        self.s_ = _host(shared)
        self.objective_ = float(objective)
        check_state({"w": w, "shared": self.s_,
                     "objective": self.objective_},
                    iteration=self.n_iter, where="DetSRM.fit")
        logger.info('Objective function %f', self.objective_)
        return self

    def _fit_checkpointed(self, x, w0, dev, fingerprint, checkpoint_dir,
                          checkpoint_every):
        """Chunked BCD under the resilient loop (as
        :meth:`SRM._fit_checkpointed`)."""
        shared0 = _wt_x(w0, x) / x.shape[0]
        init_state = {"w": fetch_rows(x, w0), "shared": _host(shared0)}
        run_chunk, final_leaves = make_device_carry_chunk(
            _carry_whole(x, lambda leaves, n: _det_chunk(
                x, *leaves, n_steps=n, mesh=self.mesh), (True, False)),
            ("w", "shared"), dtype=torch.float32, device=dev)
        state, step = run_resilient_loop(
            run_chunk, init_state, self.n_iter,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            fingerprint=fingerprint, name="DetSRM.fit")
        w, shared = final_leaves(state, step)
        w = local_rows(x, w)
        return w, shared, _det_objective(x, w, shared)
