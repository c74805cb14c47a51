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
