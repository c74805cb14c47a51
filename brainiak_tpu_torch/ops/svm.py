"""Batched kernel SVM (C-SVC, precomputed kernel) in plain PyTorch.

PyTorch counterpart of ``brainiak_tpu.ops.svm``: the dual problems of
all voxels, folds and class pairs are solved at once, as one batch
dimension (the JAX package's ``vmap`` written out).

The dual of C-SVC:  max_a  1'a - 1/2 a'Qa,  0 <= a_i <= C,  y'a = 0,
Q = yy' o K.  :func:`svm_fit_dual` is SMO with maximal-violating-pair
working-set selection (libsvm's algorithm) run for a fixed number of
two-coordinate steps; fold and class-pair exclusion zero the excluded
samples' box constraint, so every problem has the same shape.  The
JAX package expresses each indexed read as a one-hot contraction for
the TPU; here ``gather``/indexing give the same values.

The SMO loop is eager PyTorch: a few dozen small launches per step,
``n_iters * n`` steps.  Stratified folds are computed in NumPy
(:func:`stratified_kfold`, the ``StratifiedKFold(shuffle=False)``
assignment), so this module needs no scikit-learn.
"""

from itertools import combinations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["stratified_kfold", "svm_cv_accuracy", "svm_decision",
           "svm_fit_dual", "svm_fit_dual_ipm"]


def _flatten_problems(kernel, y, box):
    """Broadcast (kernel [..., n, n], y [..., n], box [..., n]) to one
    flat problem batch; returns the flat tensors and the batch shape."""
    kernel = torch.as_tensor(kernel)
    dt = kernel.dtype
    y = torch.as_tensor(y, device=kernel.device).to(dt)
    box = torch.as_tensor(box, device=kernel.device).to(dt)
    n = kernel.shape[-1]
    batch = torch.broadcast_shapes(kernel.shape[:-2], y.shape[:-1],
                                   box.shape[:-1])
    return (kernel.expand(*batch, n, n).reshape(-1, n, n),
            y.expand(*batch, n).reshape(-1, n),
            box.expand(*batch, n).reshape(-1, n), batch)


def _violating_sets(y, active, at_hi, at_lo):
    in_up = active & (((y > 0) & ~at_hi) | ((y < 0) & ~at_lo))
    in_low = active & (((y < 0) & ~at_hi) | ((y > 0) & ~at_lo))
    return in_up, in_low


def _kkt_gap(yg, in_up, in_low):
    """(max over I_up, min over I_low) of -y*grad and their gap."""
    hi = yg.masked_fill(~in_up, -torch.inf).amax(dim=-1)
    lo = yg.masked_fill(~in_low, torch.inf).amin(dim=-1)
    gap = hi - lo
    gap = torch.where(torch.isfinite(gap), gap.clamp(min=0.0),
                      torch.zeros_like(gap))
    return hi, lo, gap


def _mean_free(free, values):
    count = free.sum(dim=-1)
    total = torch.where(free, values, torch.zeros_like(values)).sum(dim=-1)
    return count > 0, total / count.clamp(min=1).to(values.dtype)


def svm_fit_dual(kernel, y, box, n_iters=400):
    """Solve the C-SVC dual (with the y'a = 0 equality constraint) by
    SMO with maximal-violating-pair working-set selection.

    kernel : [..., n, n] symmetric PSD Gram matrices
    y : [..., n] labels in {-1, +1} (0 allowed for excluded samples)
    box : [..., n] per-sample upper bounds (C, or 0 to exclude)
    n_iters : the step budget is ``n_iters * n`` two-coordinate
        updates (a converged problem keeps selecting a non-violating
        pair, whose update is a no-op)

    The leading dims broadcast and form the problem batch.  Returns
    (alpha [..., n], bias [...], gap [...]); ``gap`` is the final KKT
    violation, about 0 when the dual converged within the budget.
    Ties in the working-set argmax/argmin go to the first index.
    """
    kernel, y, box, batch = _flatten_problems(kernel, y, box)
    n_prob, n = y.shape
    q = (y[:, :, None] * y[:, None, :]) * kernel
    active = box > 0
    rows = torch.arange(n_prob, device=y.device)
    alpha = torch.zeros_like(y)
    grad = -torch.ones_like(y)

    for _ in range(n_iters * n):
        yg = -y * grad
        in_up, in_low = _violating_sets(y, active, alpha >= box,
                                        alpha <= 0)
        i = yg.masked_fill(~in_up, -torch.inf).argmax(dim=1)
        j = yg.masked_fill(~in_low, torch.inf).argmin(dim=1)
        q_i = q[rows, i]
        q_j = q[rows, j]
        yg_i, yg_j = yg[rows, i], yg[rows, j]
        y_i, y_j = y[rows, i], y[rows, j]
        box_i, box_j = box[rows, i], box[rows, j]
        alpha_i, alpha_j = alpha[rows, i], alpha[rows, j]
        # two-variable subproblem along the constraint-preserving
        # direction: d alpha_i = y_i * t, d alpha_j = -y_j * t
        quad = (q_i[rows, i] + q_j[rows, j]
                - 2.0 * y_i * y_j * q_i[rows, j]).clamp(min=1e-12)
        t = (yg_i - yg_j) / quad
        t_hi_i = torch.where(y_i > 0, box_i - alpha_i, alpha_i)
        t_hi_j = torch.where(y_j > 0, alpha_j, box_j - alpha_j)
        t = torch.minimum(t.clamp(min=0.0), torch.minimum(t_hi_i, t_hi_j))
        step = (yg_i - yg_j > 1e-12) & in_up[rows, i] & in_low[rows, j]
        t = torch.where(step, t, torch.zeros_like(t))
        d_i = y_i * t
        d_j = -y_j * t
        alpha[rows, i] += d_i
        alpha[rows, j] += d_j
        grad = grad + (d_i[:, None] * q_i + d_j[:, None] * q_j)

    # bias: mean of y - f over free SVs; with none free, the midpoint
    # of the remaining violating-pair interval (libsvm's rho rule)
    f = torch.matmul(kernel, (alpha * y)[:, :, None])[:, :, 0]
    free = (alpha > 1e-8 * box) & (alpha < box * (1 - 1e-6)) & active
    in_up, in_low = _violating_sets(y, active, alpha >= box, alpha <= 0)
    hi, lo, gap = _kkt_gap(-y * grad, in_up, in_low)
    mid = (hi + lo) / 2.0
    any_free, bias_free = _mean_free(free, y - f)
    bias = torch.where(any_free, bias_free,
                       torch.where(torch.isfinite(mid), mid,
                                   torch.zeros_like(mid)))
    return alpha.reshape(*batch, n), bias.reshape(batch), \
        gap.reshape(batch)


def svm_decision(train_test_kernel, alpha, y, bias):
    """Decision values for test samples: K_test,train @ (alpha*y) + b
    (leading dims broadcast)."""
    w = (alpha * y).unsqueeze(-1)
    return torch.matmul(train_test_kernel, w).squeeze(-1) + \
        torch.as_tensor(bias).unsqueeze(-1)


def svm_fit_dual_ipm(kernel, y, box, n_iters=30):
    """Solve the C-SVC dual by a primal-dual interior-point method.

    Same problem, batching and return contract as :func:`svm_fit_dual`;
    ``n_iters`` Newton steps, each a batched [n, n] Cholesky solve.

      min_a 0.5 a'Qa - 1'a   s.t.  y'a = 0,  0 <= a <= C

    Excluded samples (box == 0) become a separable dummy coordinate:
    their Q row/column is masked out, their linear term flips to +1 and
    their box widens to 1.  The equality multiplier converges to the
    SVC bias; ``gap`` reports the SMO path's KKT quantity with a
    tolerance on bound membership.
    """
    kernel, y, box, batch = _flatten_problems(kernel, y, box)
    dt = kernel.dtype
    n_prob, n = y.shape
    active = box > 0
    m = active.to(dt)
    q = (y[:, :, None] * y[:, None, :]) * kernel * (m[:, :, None]
                                                    * m[:, None, :])
    ones = torch.ones_like(y)
    c_lin = torch.where(active, -ones, ones)
    ub = torch.where(active, box, ones)

    # strictly interior, equality-feasible start
    n_pos = (y > 0).to(dt).sum(dim=1).clamp(min=1)[:, None]
    n_neg = (y < 0).to(dt).sum(dim=1).clamp(min=1)[:, None]
    n_min = torch.minimum(n_pos, n_neg)
    scale = 0.5 * ub.masked_fill(~active, torch.inf).amin(dim=1,
                                                          keepdim=True)
    a0 = torch.where(y > 0, scale * n_min / n_pos,
                     torch.where(y < 0, scale * n_min / n_neg, 0.5 * ub))
    a = torch.minimum(a0.clamp(min=1e-6), ub * (1 - 1e-6))
    z_lo = torch.ones_like(a)
    z_hi = torch.ones_like(a)
    nu = torch.zeros(n_prob, dtype=dt, device=y.device)
    eye = torch.eye(n, dtype=dt, device=y.device)
    tau = 0.95
    # keep the iterate a dtype-scaled distance inside the box: near
    # convergence ub - a underflows to 0 in fp32
    floor = (100.0 * torch.finfo(dt).eps * ub.amax(dim=1))[:, None]

    def max_step(x, dx):
        # largest s <= 1 with x + s*dx >= (1-tau)*x for dx < 0
        neg = dx < 0
        ratio = torch.where(neg, -x / torch.where(neg, dx, -ones),
                            torch.full_like(x, torch.inf))
        return torch.clamp(tau * ratio.amin(dim=1), max=1.0)

    for _ in range(n_iters):
        a = torch.minimum(torch.maximum(a, floor), ub - floor)
        s_hi = ub - a
        mu = ((z_lo * a).sum(dim=1) + (z_hi * s_hi).sum(dim=1)) / (2.0 * n)
        sig_mu = (0.1 * mu)[:, None]
        rd = (torch.matmul(q, a[:, :, None])[:, :, 0] + c_lin
              + nu[:, None] * y - z_lo + z_hi)
        r1 = -rd + (sig_mu - z_lo * a) / a - (sig_mu - z_hi * s_hi) / s_hi
        d = z_lo / a + z_hi / s_hi
        chol, _ = torch.linalg.cholesky_ex(q + torch.diag_embed(d)
                                           + 1e-6 * eye)
        sol = torch.cholesky_solve(torch.stack([y, r1], dim=2), chol)
        u, v = sol[:, :, 0], sol[:, :, 1]
        dnu = (y * v).sum(dim=1) / (y * u).sum(dim=1).clamp(min=1e-12)
        da = v - dnu[:, None] * u
        dz_lo = (sig_mu - z_lo * a - z_lo * da) / a
        dz_hi = (sig_mu - z_hi * s_hi + z_hi * da) / s_hi
        s_pri = torch.minimum(max_step(a, da), max_step(s_hi, -da))
        s_dual = torch.minimum(max_step(z_lo, dz_lo),
                               max_step(z_hi, dz_hi))
        a = a + s_pri[:, None] * da
        nu = nu + s_dual * dnu
        z_lo = z_lo + s_dual[:, None] * dz_lo
        z_hi = z_hi + s_dual[:, None] * dz_hi

    alpha = torch.where(active, torch.minimum(a.clamp(min=0.0), box),
                        torch.zeros_like(a))
    f = torch.matmul(kernel, (alpha * y)[:, :, None])[:, :, 0]
    grad = torch.matmul(q, alpha[:, :, None])[:, :, 0] - m
    tol = 1e-5 * box.clamp(min=1.0)
    at_hi = alpha > box - tol
    at_lo = alpha < tol
    in_up, in_low = _violating_sets(y, active, at_hi, at_lo)
    _, _, gap = _kkt_gap(-y * grad, in_up, in_low)
    free = ~at_hi & ~at_lo & active
    any_free, bias_free = _mean_free(free, y - f)
    bias = torch.where(any_free, bias_free, nu)
    return alpha.reshape(*batch, n), bias.reshape(batch), \
        gap.reshape(batch)


def _cv_batch(kernels, pair_y, pair_classes, truth, train_masks, c,
              n_iters, n_classes, solver="smo"):
    """Mean one-vs-one CV accuracy and worst KKT gap of each voxel.

    kernels : [Bc, n, n]; pair_y : [P, n] +-1 labels per class pair (0
    outside it); pair_classes : [P, 2]; truth : [n] class indices;
    train_masks : [F, n] (1 = train).  The Bc x F x P binary SVMs are
    one problem batch; test samples collect one-vs-one votes and the
    prediction is the vote argmax (first class on ties; libsvm votes
    the later class of a pair at exactly 0).
    """
    fit = svm_fit_dual_ipm if solver == "ipm" else svm_fit_dual
    k = kernels[:, None, None]                              # [Bc,1,1,n,n]
    y = pair_y[None, None]                                  # [1,1,P,n]
    box = c * train_masks[None, :, None, :] * pair_y.abs()[None, None]
    alpha, bias, gap = fit(k, y, box, n_iters=n_iters)     # [Bc,F,P,...]
    dec = svm_decision(k, alpha, y, bias)                   # [Bc,F,P,n]
    vote = torch.where(dec > 0, pair_classes[None, None, :, 0, None],
                       pair_classes[None, None, :, 1, None])
    votes = torch.nn.functional.one_hot(vote, n_classes).sum(dim=2)
    pred = votes.argmax(dim=-1)                             # [Bc,F,n]
    test_mask = 1.0 - train_masks
    correct = ((pred == truth).to(test_mask.dtype) * test_mask).sum(-1)
    acc = correct / test_mask.sum(-1).clamp(min=1)
    return acc.mean(dim=1), gap.amax(dim=(1, 2))


# Budget (in floats) for the live q = yy^T*K batch of one _cv_batch
# call: B_chunk * folds * pairs * n^2 floats (~256 MB).
_CV_CHUNK_BUDGET_FLOATS = 64_000_000


def stratified_kfold(labels, n_splits):
    """Yield (train_idx, test_idx) of ``StratifiedKFold(n_splits,
    shuffle=False)``: each class is dealt to the folds in blocks, in
    order of appearance, with per-fold counts from a round robin over
    the sorted labels."""
    y = np.asarray(labels)
    n = len(y)
    if n_splits < 2:
        raise ValueError(f"n_splits must be at least 2; got {n_splits}")
    if n_splits > n:
        raise ValueError(f"Cannot have number of splits n_splits="
                         f"{n_splits} greater than the number of "
                         f"samples: n_samples={n}.")
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than "
                         "the number of members in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray(
        [np.bincount(y_order[i::n_splits], minlength=n_classes)
         for i in range(n_splits)])
    test_folds = np.empty(n, dtype=int)
    for k in range(n_classes):
        test_folds[y_encoded == k] = np.arange(n_splits).repeat(
            allocation[:, k])
    for f in range(n_splits):
        yield np.flatnonzero(test_folds != f), np.flatnonzero(
            test_folds == f)


def svm_cv_accuracy(kernels, labels, num_folds, C=1.0, n_iters=50,
                    return_gap=False, solver="smo", device="cuda"):
    """Stratified k-fold CV accuracy for a batch of precomputed kernels.

    kernels : [B, n, n] per-voxel Gram matrices (tensor or array)
    labels : [n] condition labels (two or more classes; multiclass is
        one-vs-one voting like sklearn SVC, classes in sorted order)
    Returns [B] mean fold accuracies as numpy (with ``return_gap=True``
    a tuple ``(accs, gaps)``, gaps[b] the worst final KKT violation over
    that voxel's folds and pairs), matching
    ``cross_val_score(SVC(kernel='precomputed'), ...)`` with
    ``StratifiedKFold(shuffle=False)`` and an unweighted fold mean.
    """
    dev = resolve_device(device)
    if isinstance(kernels, np.ndarray):
        kernels = np.array(kernels)  # writable: torch shares the memory
    kernels = torch.as_tensor(kernels, device=dev)
    dt = kernels.dtype
    labels = np.asarray(labels)
    classes = np.unique(labels)
    if len(classes) < 2:
        raise ValueError("Need at least two classes; got "
                         f"{len(classes)}")
    n = len(labels)
    class_idx = np.searchsorted(classes, labels)

    pair_y, pair_classes = [], []
    for a, b in combinations(range(len(classes)), 2):
        y = np.zeros(n)
        y[class_idx == a] = 1.0
        y[class_idx == b] = -1.0
        pair_y.append(y)
        pair_classes.append([a, b])

    train_masks = np.zeros((num_folds, n))
    for f, (train_idx, _) in enumerate(stratified_kfold(labels,
                                                        num_folds)):
        train_masks[f, train_idx] = 1.0

    args = (torch.as_tensor(np.stack(pair_y), dtype=dt, device=dev),
            torch.as_tensor(np.asarray(pair_classes), device=dev),
            torch.as_tensor(class_idx, device=dev),
            torch.as_tensor(train_masks, dtype=dt, device=dev), float(C),
            int(n_iters), len(classes), str(solver))
    if kernels.shape[0] == 0:
        empty = np.zeros(0, dtype=np.float64)
        return (empty, empty) if return_gap else empty
    n_problems_per_voxel = num_folds * len(pair_y)
    chunk = max(1, _CV_CHUNK_BUDGET_FLOATS // (n_problems_per_voxel
                                               * n * n))
    parts = [_cv_batch(kernels[s:s + chunk], *args)
             for s in range(0, kernels.shape[0], chunk)]
    accs = torch.cat([a for a, _ in parts]).cpu().numpy()
    gaps = torch.cat([g for _, g in parts]).cpu().numpy()
    if return_gap:
        return accs, gaps
    return accs
