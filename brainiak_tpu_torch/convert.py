"""Carry state across from the JAX package.

FCMA stage 1 has no learned weights: a voxel selector's state is its
configuration and its epoch data.  :func:`voxel_selector_from_jax`
reads a ``brainiak_tpu`` ``VoxelSelector`` by its attributes (duck
typing, without importing the JAX package) and builds the port's
selector, so that both compute the same thing.
"""

import numpy as np

from .fcma.voxelselector import VoxelSelector

__all__ = ["voxel_selector_from_jax"]


def voxel_selector_from_jax(vs, device="cuda"):
    """The port's :class:`VoxelSelector` with the configuration and
    epoch data of ``vs`` (arrays through ``np.asarray``; the
    precision by its name)."""
    raw_data2 = None
    if vs.raw_data2 is not None:
        raw_data2 = [np.asarray(x, dtype=np.float32) for x in vs.raw_data2]
    return VoxelSelector(
        np.asarray(vs.labels), vs.epochs_per_subj, vs.num_folds,
        [np.asarray(x, dtype=np.float32) for x in vs.raw_data],
        raw_data2=raw_data2, voxel_unit=vs.voxel_unit, svm_C=vs.svm_C,
        svm_iters=vs.svm_iters, precision=vs.precision, device=device)
