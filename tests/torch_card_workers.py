"""Worker functions of the port's multi-rank tests that also run on the
card (``tests/test_torch_gpu.py``, under ``--noconftest``), where only
the ``tests`` directory itself is on the path: this module imports
nothing of the ``tests`` package, nor jax."""

import numpy as np


def make_detsrm_data():
    """The data of ``tests/parallel/dist_workers.py``'s DetSRM worker:
    4 subjects x 12 voxels x 16 samples, 3 features."""
    rng = np.random.RandomState(0)
    n_subjects, voxels, samples, features = 4, 12, 16, 3
    S = rng.randn(features, samples)
    data = np.zeros((n_subjects, voxels, samples))
    for i in range(n_subjects):
        q, _ = np.linalg.qr(rng.randn(voxels, features))
        data[i] = q @ S + 0.01 * rng.randn(voxels, samples)
    return list(data)


def detsrm_card_worker(process_id, num_processes):
    """DetSRM on a ``'subject'`` mesh of two ranks that share one card;
    each rank returns the whole fit."""
    from brainiak_tpu_torch import set_fp32_defaults
    from brainiak_tpu_torch.funcalign.srm import DetSRM
    from brainiak_tpu_torch.parallel import make_mesh

    set_fp32_defaults()
    mesh = make_mesh(("subject",), (-1,))
    model = DetSRM(n_iter=5, features=3, mesh=mesh).fit(make_detsrm_data())
    return {"w": model.w_, "s_": model.s_, "objective": model.objective_}


def make_rbf_data(n_grid=8, K=2, n_tr=60, noise=0.05, seed=0):
    """``tests/factoranalysis/test_tfa.py``'s planted RBF data: ``(X,
    R, centres, widths)`` on an ``n_grid``^3 grid."""
    rng = np.random.RandomState(seed)
    grid = np.array(np.meshgrid(*[np.arange(n_grid)] * 3)) \
        .reshape(3, -1).T.astype(float)
    centers = np.array([[2.0, 2.0, 2.0], [6.0, 6.0, 5.0]])[:K]
    widths = np.array([[3.0], [4.0]])[:K]
    F = np.exp(-((grid[:, None, :] - centers[None]) ** 2).sum(-1)
               / widths.T)
    W = rng.randn(K, n_tr)
    X = F @ W + noise * rng.randn(grid.shape[0], n_tr)
    return X, grid, centers, widths


def make_rbf_subjects(n_subj, seed=0):
    """``tests/factoranalysis/test_htfa.py``'s subjects: ``(X list, R
    list, centres, widths)``."""
    X, R = [], []
    for s in range(n_subj):
        x, r, centers, widths = make_rbf_data(noise=0.05, seed=seed + s)
        X.append(x)
        R.append(r)
    return X, R, centers, widths


def fixed_centers_widths(tfa, R):
    """The seeding that the tests patch into both packages'
    ``init_centers_widths`` (the JAX package's is sklearn's k-means,
    the port's its own): the planted centres one grid unit off, and
    max-sigma widths."""
    centers = np.array([[3.0, 3.0, 3.0], [5.0, 5.0, 4.0]])[:tfa.K]
    widths = tfa._get_max_sigma(R) * np.ones((tfa.K, 1))
    return centers, widths
