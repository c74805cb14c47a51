"""Massive voxel-wise encoding models: batched ridge / banded ridge.

PyTorch counterpart of ``brainiak_tpu/encoding/ridge.py``: tens of
thousands of independent per-voxel ridge regressions sharing one
design, a per-voxel lambda selected by k-fold cross-validation
("Scaling up ridge regression for brain encoding in a massive
individual fMRI dataset", https://arxiv.org/pdf/2403.19421).

The solver is the eigendecomposition trick: with ``G = Xᵀ X = Q Λ Qᵀ``
computed once (through :func:`brainiak_tpu_torch.ops.distla.gram`, so
the budget dispatcher picks one ``torch.matmul`` or, with a mesh and
over the budget, the SUMMA ring, whose steps are kernel K5), every
ridge solution is a diagonal rescale in the eigenbasis::

    W(λ) = Q diag(1 / (Λ + λ)) Qᵀ Xᵀ Y

Each CV fold's train Gram is ``G - G_f``, so one batched ``eigh`` over
the folds prepares the whole sweep.  The JAX package's jitted
programs are plain functions on tensors here (:func:`_fold_algebra`,
:func:`_prepare`, :func:`_sweep`, :func:`_banded_sweep`,
:func:`_refit`, :func:`_banded_refit`), and its ``vmap`` over a
lambda or candidate block is a broadcast over the block's leading
axis.

:class:`BandedRidgeEncoder` (a lambda a feature band) solves each
candidate's ridge ``(G + diag(λ_band)) W = Xᵀ Y`` by one batched LU
solve a candidate and fold.  The JAX package solves it by the scaling
trick instead: ridge at ``λ = 1`` on ``X·diag(s)``, ``s =
1/sqrt(λ_band)``, one ``eigh`` of the scaled Gram ``diag(s) G diag(s)``
a candidate and fold.  That is the same solution, but the scaled
Gram's condition number grows with the square of the bands' lambda
ratio (10^12 for a candidate of 0.01 against 10^4), so in float32 its
eigenvalues near 1 carry an error of eps·||diag(s) G diag(s)||, and
on a wide design (two bands of 512 features, 4,000 TRs) the float32
CV then selects other candidates than a float64 CV on a few percent of
the voxels.  ``G + diag(λ_band)`` is as well conditioned as the design
allows.

The sweep is driven block by block through
:func:`~brainiak_tpu_torch.resilience.guards.run_resilient_loop`: with
``checkpoint_dir=`` the per-voxel CV scores persist every
``checkpoint_every`` blocks, and a preempted fit resumes at the last
completed block.  Blocks are equal-sized (the last one padded).  The
peak transient of the sweep is the predicted held-out block ``[block,
K, T/K, V]`` and its eigenbasis coefficients ``[block, K, F, V]``:
bound it with ``lambda_block=`` (ridge) / ``candidate_block=``
(banded).
"""

import logging

import numpy as np
import torch

from ..device import matmul_precision, resolve_device
from ..obs import spans as obs_spans
from ..ops import distla
from ..parallel.mesh import Sharded, fetch_replicated
from ..resilience.guards import array_digest, run_resilient_loop

logger = logging.getLogger(__name__)

__all__ = [
    "BandedRidgeEncoder",
    "DEFAULT_LAMBDAS",
    "RidgeEncoder",
]

#: Default lambda grid (log-spaced; sorted ascending, so per-voxel
#: argmax ties resolve to the SMALLEST adequate lambda).
DEFAULT_LAMBDAS = (0.01, 0.1, 1.0, 10.0, 100.0, 1000.0, 10000.0)


def _ein(eq, *ops, op_dtype=torch.float32):
    """``torch.einsum`` with operands in ``op_dtype`` (the precision's
    operand type) and the result in the first operand's dtype."""
    out = ops[0].dtype
    if op_dtype == out:
        return torch.einsum(eq, *ops)
    return torch.einsum(eq, *[o.to(op_dtype) for o in ops]).to(out)


def _fold_scores(pred, y):
    """Per-voxel Pearson r between predictions and held-out data over
    the time axis (axis -2); zero where either side is constant (a
    huge lambda drives predictions to a constant — score it neutral,
    never NaN)."""
    pc = pred - pred.mean(dim=-2, keepdim=True)
    yc = y - y.mean(dim=-2, keepdim=True)
    cov = (pc * yc).sum(dim=-2)
    den = torch.sqrt((pc * pc).sum(dim=-2) * (yc * yc).sum(dim=-2))
    return torch.where(den > 0, cov / torch.where(den > 0, den, 1.0), 0.0)


def _eigh(g):
    """Eigendecomposition with the eigenvalues clamped at 0 (float32
    noise on a PSD matrix)."""
    evals, q = torch.linalg.eigh(g)
    return torch.clamp(evals, min=0.0), q


def _fold_algebra(x, y, g_total, k, t_f, op_dtype):
    """The fold decomposition both prepares share: the contiguous folds
    of the (device-resident) full arrays, and the per-fold Grams and
    cross-products subtracted from the totals (``G_train = G - G_f``).
    Returns ``(x_folds, y_folds, g_tr, b_tr, b_total)``."""
    x_folds = x[:k * t_f].reshape(k, t_f, x.shape[1])
    y_folds = y[:k * t_f].reshape(k, t_f, y.shape[1])
    b_total = _ein('tf,tv->fv', x, y, op_dtype=op_dtype)
    g_folds = _ein('ktf,ktg->kfg', x_folds, x_folds, op_dtype=op_dtype)
    b_folds = _ein('ktf,ktv->kfv', x_folds, y_folds, op_dtype=op_dtype)
    return (x_folds, y_folds, g_total[None] - g_folds,
            b_total[None] - b_folds, b_total)


def _prepare(x, y, g_total, k, t_f, op_dtype):
    """Ridge sweep preparation: the fold algebra, the batched train-Gram
    eigendecompositions and the eigenbasis projections the sweep
    consumes.  Returns ``(evals, a, p, y_folds, b_total)``."""
    x_folds, y_folds, g_tr, b_tr, b_total = _fold_algebra(
        x, y, g_total, k, t_f, op_dtype)
    evals, q = _eigh(g_tr)
    a = _ein('kfg,kfv->kgv', q, b_tr, op_dtype=op_dtype)
    p = _ein('ktf,kfg->ktg', x_folds, q, op_dtype=op_dtype)
    return evals, a, p, y_folds, b_total


def _sweep(evals, a, p, y_folds, lambdas, op_dtype):
    """The ridge CV sweep of a lambda block: per lambda (the block's
    leading axis), the diagonal rescale in the eigenbasis, the held-out
    prediction and the per-voxel correlation, averaged over folds.
    Returns [block, V]."""
    w = a[None] / (evals[None, ..., None] + lambdas[:, None, None, None])
    pred = _ein('ktf,bkfv->bktv', p, w, op_dtype=op_dtype)
    return _fold_scores(pred, y_folds[None]).mean(dim=1)


def _banded_solve(g, b, penalties):
    """``(g + diag(p))⁻¹ b`` for each penalty row ``p`` of ``penalties``
    [B, F] (a lambda a feature): [B, ..., F, V], batched over the
    block and ``g``'s leading axes."""
    return torch.linalg.solve(g[None] + torch.diag_embed(penalties).view(
        (penalties.shape[0],) + (1,) * (g.dim() - 2) + g.shape[-2:]),
        b[None])


def _banded_sweep(g_tr, b_tr, x_folds, y_folds, penalties, op_dtype):
    """The banded CV sweep of a candidate block: per candidate (one
    lambda a feature, its band's), solve the ridge on each fold's train
    Gram, score the held-out predictions.  Returns [block, V]."""
    w = _banded_solve(g_tr, b_tr, penalties)           # [B, K, F, V]
    pred = _ein('ktf,bkfv->bktv', x_folds, w, op_dtype=op_dtype)
    return _fold_scores(pred, y_folds[None]).mean(dim=1)


def _refit(g_total, b_total, lam_sel, op_dtype):
    """The full-data refit at the per-voxel selected lambdas: one
    eigendecomposition of the total Gram, then a per-voxel diagonal
    rescale."""
    evals, q = _eigh(g_total)
    a = _ein('fg,fv->gv', q, b_total, op_dtype=op_dtype)
    w = a / (evals[:, None] + lam_sel[None, :])
    return _ein('fg,gv->fv', q, w, op_dtype=op_dtype)


def _banded_refit(g_total, b_total, penalties, mask):
    """The banded full-data refit of a candidate block: per candidate,
    the ridge on the total Gram, keeping only the voxel columns whose
    CV selected it (the one-hot ``mask``); the block's candidates
    summed."""
    w = _banded_solve(g_total, b_total, penalties)       # [B, F, V]
    return (w * mask[:, None, :]).sum(dim=0)


class RidgeEncoder:
    """Voxel-wise ridge encoding model with a CV lambda sweep on the
    device.

    Fits ``V`` independent ridge regressions ``y_v ≈ X w_v`` sharing
    one design ``X [T, F]``, selecting a per-voxel lambda from
    ``lambdas`` by contiguous k-fold cross-validation (held-out
    per-voxel Pearson r, averaged over folds; ties take the smallest
    lambda), then refitting on all data at the selected lambdas.

    Parameters
    ----------
    lambdas : sequence of positive floats, default DEFAULT_LAMBDAS
        Candidate regularization grid (sorted ascending internally).
    n_folds : int, default 5
        Contiguous CV folds over the first ``K * (T // K)`` samples;
        remainder rows stay in every training fold.
    fit_intercept : bool, default True
        Center ``X`` and ``Y``; predictions add the stored means back.
    standardize : bool, default False
        Additionally scale design columns to unit std before fitting
        (zero-variance columns keep scale 1).
    lambda_block : int, optional
        Sweep the grid in equal blocks of this many lambdas (default:
        the whole grid in one block).  Bounds the sweep's transient
        memory and sets the checkpoint granularity.
    mesh : :class:`~brainiak_tpu_torch.parallel.mesh.Mesh`, optional
        Passed to :func:`brainiak_tpu_torch.ops.distla.gram`: the
        ``Xᵀ X`` Gram takes the SUMMA ring over the mesh (kernel K5)
        when the replicated working set exceeds the distla budget.
    precision : 'highest' (default) / 'high' / 'default', optional
        Operand precision of the plain matmuls
        (:mod:`brainiak_tpu_torch.device`).
    device : ``"cuda"`` (default; raises without a card) or ``"cpu"``.

    Attributes (after fit)
    ----------------------
    W_ : [F, V] per-voxel coefficients (standardized design space).
    lambda_ : [V] the CV-selected lambda per voxel.
    cv_scores_ : [L, V] mean held-out correlation per (lambda, voxel).
    lambdas_ : [L] the ascending grid actually swept.
    x_mean_, x_scale_, y_mean_ : the preprocessing parameters
        ``predict`` applies (zeros/ones when disabled).
    """

    def __init__(self, lambdas=None, n_folds=5, fit_intercept=True,
                 standardize=False, lambda_block=None, mesh=None,
                 precision=None, device="cuda"):
        self.lambdas = tuple(DEFAULT_LAMBDAS if lambdas is None
                             else lambdas)
        self.n_folds = int(n_folds)
        self.fit_intercept = bool(fit_intercept)
        self.standardize = bool(standardize)
        self.lambda_block = lambda_block
        self.mesh = mesh
        self.precision = precision
        self.device = device

    # -- shared plumbing ----------------------------------------------
    def _validate_grid(self):
        grid = np.asarray(self.lambdas, dtype=np.float32)
        if grid.ndim != 1 or grid.size == 0:
            raise ValueError("lambdas must be a non-empty 1-D grid")
        if not np.all(np.isfinite(grid)) or np.any(grid <= 0):
            raise ValueError(
                "lambdas must be finite and positive "
                f"(got {self.lambdas!r})")
        return np.sort(grid)

    def _prepare_data(self, X, Y):
        x = np.asarray(X, dtype=np.float32)
        y = np.asarray(Y, dtype=np.float32)
        if x.ndim != 2 or y.ndim != 2 or x.shape[0] != y.shape[0]:
            raise ValueError(
                f"expected X [T, F] and Y [T, V] with matching T; "
                f"got {x.shape} and {y.shape}")
        if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
            raise ValueError(
                "X/Y contain NaN/Inf; encoding fits require finite "
                "data (mask or impute missing voxels first)")
        if self.n_folds < 2:
            raise ValueError(
                f"n_folds must be >= 2, got {self.n_folds}")
        t_f = x.shape[0] // self.n_folds
        if t_f < 2:
            raise ValueError(
                f"{x.shape[0]} samples cannot form {self.n_folds} "
                "folds of >= 2 samples (correlation scoring needs "
                "at least 2 held-out rows per fold)")
        self.x_mean_ = (x.mean(axis=0) if self.fit_intercept
                        else np.zeros(x.shape[1], np.float32))
        self.y_mean_ = (y.mean(axis=0) if self.fit_intercept
                        else np.zeros(y.shape[1], np.float32))
        xs = x - self.x_mean_
        if self.standardize:
            scale = xs.std(axis=0)
            self.x_scale_ = np.where(scale > 0, scale,
                                     1.0).astype(np.float32)
            xs = xs / self.x_scale_
        else:
            self.x_scale_ = np.ones(x.shape[1], np.float32)
        yc = y - self.y_mean_
        return xs, yc, t_f

    def _gram(self, xs, dev):
        """``Xᵀ X`` on ``dev`` through the distla budget dispatcher (one
        ``torch.matmul`` under the budget; with a mesh, the SUMMA ring
        over it, gathered to every rank across processes)."""
        g = distla.gram(xs, mesh=self.mesh, precision=self.precision,
                        normalize=False, device=dev)
        if isinstance(g, Sharded):
            g = torch.from_numpy(fetch_replicated(g))
        return g.to(dev)

    def _sweep_blocks(self, program, fixed_args, grid, block, n_vox,
                      checkpoint_dir, checkpoint_every, fingerprint,
                      name, dev):
        """Drive ``program(*fixed_args, block_rows)`` over equal-sized
        blocks of ``grid`` rows under :func:`run_resilient_loop`,
        filling the host [n_grid, V] score matrix.  Blocks are padded
        (repeating the last row); with ``checkpoint_dir`` a preempted
        sweep resumes at the last completed block."""
        n = grid.shape[0]
        n_blocks = -(-n // block)

        def run_chunk(state, step, n_steps):
            # copy-on-write: the previous state is the rollback target;
            # finished block scores land in host state, one read a block
            out = np.array(state["scores"], copy=True)
            for b in range(step, step + n_steps):
                start = b * block
                stop = min(start + block, n)
                rows = grid[start:start + block]
                if rows.shape[0] < block:
                    pad = np.repeat(rows[-1:],
                                    block - rows.shape[0], axis=0)
                    rows = np.concatenate([rows, pad], axis=0)
                with obs_spans.span("encoding.sweep_chunk",
                                    attrs={"block": b,
                                           "rows": stop - start}):
                    got = program(*fixed_args, torch.as_tensor(
                        rows, device=dev)).cpu().numpy()
                out[start:stop] = got[:stop - start]
            return {"scores": out}, False

        zeros = np.zeros((n, n_vox), dtype=np.float32)
        state, _ = run_resilient_loop(
            run_chunk, {"scores": zeros}, n_blocks,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            fingerprint=fingerprint, name=name,
            progress_objective="scores", progress_direction="max")
        return state["scores"]

    def _fingerprint(self, checkpoint_dir, xs, yc, grid, block):
        if checkpoint_dir is None:
            return None
        # the grid AND the block size participate: resilient-loop
        # steps are counted in blocks, so a resume against the same
        # data but a different grid or block size must restart, not
        # mix (or silently skip) score rows
        return np.array(
            [array_digest(xs), array_digest(yc), array_digest(grid),
             float(self.n_folds), float(grid.shape[0]),
             float(block)])

    def _check_fitted(self):
        if not hasattr(self, "W_"):
            raise ValueError(
                f"this {type(self).__name__} is not fitted yet; "
                "call fit(X, Y) first")

    # -- fit / predict ------------------------------------------------
    def fit(self, X, Y, checkpoint_dir=None, checkpoint_every=1):
        """Fit per-voxel ridge with CV lambda selection.

        X : [T, F] design (stimulus/feature embedding per TR).
        Y : [T, V] responses (voxels).
        checkpoint_dir, checkpoint_every : persist the accumulated
            CV scores every ``checkpoint_every`` lambda blocks and
            resume a preempted sweep at the last completed block.
        """
        dev = resolve_device(self.device)
        self.lambdas_ = self._validate_grid()
        xs, yc, t_f = self._prepare_data(X, Y)
        f = xs.shape[1]
        v = yc.shape[1]
        with obs_spans.span("encoding.fit",
                            attrs={"estimator": "RidgeEncoder",
                                   "n_voxels": int(v),
                                   "n_features": int(f),
                                   "n_lambdas":
                                       int(self.lambdas_.size)}), \
                matmul_precision(self.precision) as op_dtype:
            g_total = self._gram(xs, dev)
            # X and Y cross to the device once; the folds are views
            evals, a, p, y_folds, b_total = _prepare(
                torch.as_tensor(xs, device=dev),
                torch.as_tensor(yc, device=dev), g_total, self.n_folds,
                t_f, op_dtype)
            n_lam = int(self.lambdas_.size)
            block = n_lam if self.lambda_block is None \
                else max(1, min(int(self.lambda_block), n_lam))

            def sweep(*args):
                return _sweep(*args, op_dtype=op_dtype)

            scores = self._sweep_blocks(
                sweep, (evals, a, p, y_folds), self.lambdas_, block, v,
                checkpoint_dir, checkpoint_every,
                self._fingerprint(checkpoint_dir, xs, yc,
                                  self.lambdas_, block),
                name="encoding.fit", dev=dev)
            del evals, a, p, y_folds
            self.cv_scores_ = scores
            best = np.argmax(scores, axis=0)
            self.lambda_ = self.lambdas_[best]
            self.W_ = _refit(g_total, b_total,
                             torch.as_tensor(self.lambda_, device=dev),
                             op_dtype).cpu().numpy()
        return self

    def predict(self, X):
        """Predicted responses [T, V] for a new design [T, F]."""
        self._check_fitted()
        x = np.asarray(X, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.W_.shape[0]:
            raise ValueError(
                f"expected X [T, {self.W_.shape[0]}], got {x.shape}")
        xs = (x - self.x_mean_) / self.x_scale_
        return xs @ self.W_ + self.y_mean_

    def score(self, X, Y):
        """Per-voxel Pearson r [V] between ``predict(X)`` and ``Y``, on
        the host."""
        pred = self.predict(X)
        y = np.asarray(Y, dtype=np.float32)
        if y.shape != pred.shape:
            raise ValueError(
                f"expected Y {pred.shape}, got {y.shape}")
        pc = pred - pred.mean(axis=0)
        yc = y - y.mean(axis=0)
        den = np.sqrt((pc * pc).sum(axis=0) * (yc * yc).sum(axis=0))
        cov = (pc * yc).sum(axis=0)
        return np.where(den > 0, cov / np.where(den > 0, den, 1.0),
                        0.0).astype(np.float32)


class BandedRidgeEncoder(RidgeEncoder):
    """Banded ridge: one lambda per feature *band* (feature grouping,
    e.g. motion-energy vs. semantic embeddings), selected jointly per
    voxel over a candidate grid.

    Parameters (beyond :class:`RidgeEncoder`)
    -----------------------------------------
    bands : int array [F]
        Band id (0..n_bands-1) of every design column.
    candidates : [C, n_bands] array, optional
        Per-band lambda rows to sweep.  Default: the full Cartesian
        grid of ``lambdas`` over the bands, refused above
        ``max_candidates``.
    candidate_block : int, default 8
        Candidates scored per block (each costs one [F, F] solve with
        V right-hand sides per fold; the block bounds transient memory
        and sets the checkpoint granularity).
    max_candidates : int, default 4096
        Cap on the default Cartesian grid.

    After fit, ``lambda_`` is [V, n_bands] (the selected candidate
    row per voxel) and ``cv_scores_`` is [C, V].
    """

    def __init__(self, bands, lambdas=None, candidates=None,
                 n_folds=5, fit_intercept=True, standardize=False,
                 candidate_block=8, mesh=None, precision=None,
                 max_candidates=4096, device="cuda"):
        super().__init__(lambdas=lambdas, n_folds=n_folds,
                         fit_intercept=fit_intercept,
                         standardize=standardize, mesh=mesh,
                         precision=precision, device=device)
        self.bands = np.asarray(bands, dtype=np.int32)
        self.candidates = candidates
        self.candidate_block = int(candidate_block)
        self.max_candidates = int(max_candidates)

    def _candidate_grid(self):
        if self.bands.ndim != 1 or np.any(self.bands < 0):
            raise ValueError(
                "bands must be a 1-D array of non-negative band ids")
        n_bands = int(self.bands.max()) + 1
        if not np.array_equal(np.unique(self.bands),
                              np.arange(n_bands)):
            # sparse ids would silently inflate the Cartesian grid
            # (bands=[0, 5] -> a 6-band product of duplicates)
            raise ValueError(
                "bands ids must be dense 0..n_bands-1; got "
                f"{sorted(set(self.bands.tolist()))}")
        if self.candidates is not None:
            cand = np.asarray(self.candidates, dtype=np.float32)
            if cand.ndim != 2 or cand.shape[1] != n_bands:
                raise ValueError(
                    f"candidates must be [C, {n_bands}] for "
                    f"{n_bands} bands; got {cand.shape}")
            if not np.all(np.isfinite(cand)) or np.any(cand <= 0):
                raise ValueError(
                    "candidates must be finite and positive")
            return cand
        grid = self._validate_grid()
        n = grid.size ** n_bands
        if n > self.max_candidates:
            raise ValueError(
                f"the full {grid.size}^{n_bands} = {n} candidate "
                f"grid exceeds max_candidates={self.max_candidates}"
                "; pass an explicit candidates array")
        mesh_axes = np.meshgrid(*([grid] * n_bands), indexing="ij")
        return np.stack([m.ravel() for m in mesh_axes],
                        axis=1).astype(np.float32)

    def fit(self, X, Y, checkpoint_dir=None, checkpoint_every=1):
        """Fit banded ridge with joint per-voxel candidate selection
        (same resilient contract as :meth:`RidgeEncoder.fit`, chunked
        over candidate blocks)."""
        dev = resolve_device(self.device)
        self.lambdas_ = self._validate_grid()
        xs, yc, t_f = self._prepare_data(X, Y)
        f = xs.shape[1]
        v = yc.shape[1]
        if self.bands.shape[0] != f:
            raise ValueError(
                f"bands has {self.bands.shape[0]} entries for "
                f"{f} design columns")
        cand = self._candidate_grid()
        self.candidates_ = cand
        penalties = cand[:, self.bands]
        # the JAX package's scale rows, which its checkpoints' fingerprint
        # holds
        scales = (1.0 / np.sqrt(penalties)).astype(np.float32)
        block = max(1, min(self.candidate_block, cand.shape[0]))
        with obs_spans.span("encoding.fit",
                            attrs={"estimator": "BandedRidgeEncoder",
                                   "n_voxels": int(v),
                                   "n_features": int(f),
                                   "n_candidates":
                                       int(cand.shape[0])}), \
                matmul_precision(self.precision) as op_dtype:
            g_total = self._gram(xs, dev)
            x_folds, y_folds, g_tr, b_tr, b_total = _fold_algebra(
                torch.as_tensor(xs, device=dev),
                torch.as_tensor(yc, device=dev), g_total, self.n_folds,
                t_f, op_dtype)

            def sweep(*args):
                return _banded_sweep(*args, op_dtype=op_dtype)

            scores = self._sweep_blocks(
                sweep, (g_tr, b_tr, x_folds, y_folds), penalties, block, v,
                checkpoint_dir, checkpoint_every,
                self._fingerprint(checkpoint_dir, xs, yc, scales,
                                  block),
                name="encoding.fit", dev=dev)
            del x_folds, y_folds, g_tr, b_tr
            self.cv_scores_ = scores
            best = np.argmax(scores, axis=0)
            self.lambda_ = cand[best]
            self.W_ = self._banded_refit(
                g_total, b_total, penalties, best, block, f, v, dev)
        return self

    def _banded_refit(self, g_total, b_total, penalties, best, block,
                      f, v, dev):
        """Assemble the mixed-candidate [F, V] coefficient block by
        block: each block refits its candidates on all data and masks in
        exactly the voxel columns that selected one of them (a block
        nobody selected is skipped on the host)."""
        w = np.zeros((f, v), dtype=np.float32)
        n = penalties.shape[0]
        for start in range(0, n, block):
            stop = min(start + block, n)
            onehot = (best[None, :]
                      == np.arange(start, stop)[:, None])
            if not onehot.any():
                continue
            rows = penalties[start:start + block]
            if rows.shape[0] < block:
                pad = block - rows.shape[0]
                rows = np.concatenate(
                    [rows, np.repeat(rows[-1:], pad, axis=0)],
                    axis=0)
                onehot = np.concatenate(
                    [onehot, np.zeros((pad, v), dtype=bool)],
                    axis=0)
            # each block's masked [F, V] contribution lands in the host
            # coefficient (bounded memory for any candidate count)
            w += _banded_refit(
                g_total, b_total, torch.as_tensor(rows, device=dev),
                torch.as_tensor(onehot.astype(np.float32),
                                device=dev)).cpu().numpy()
        return w
