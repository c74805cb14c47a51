"""Carry state across from the JAX package.

FCMA has no learned weights of its own: a voxel selector's state is
its configuration and its epoch data, a classifier's its configuration,
its host estimator and the arrays its fit left.  The functions here
read a ``brainiak_tpu`` object by its attributes (duck typing, without
importing the JAX package) and build the port's counterpart, so that
both compute the same thing.
"""

import numpy as np

from .fcma.classifier import Classifier
from .fcma.voxelselector import VoxelSelector

__all__ = ["classifier_from_jax", "voxel_selector_from_jax"]

#: fitted attributes of a Classifier: integers, then arrays (or None)
_CLASSIFIER_COUNTS = ("num_digits_", "num_voxels_", "num_features_",
                      "num_samples_")
_CLASSIFIER_ARRAYS = ("training_data_", "test_data_")


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


def classifier_from_jax(clf, device="cuda"):
    """The port's :class:`Classifier` with the configuration and the
    fitted state of the JAX package's ``clf``: its estimator object
    ``clf.clf`` (host state, passed through as it is), the digit
    shrink, the sizes, and the training and test arrays (through
    ``np.asarray``).  ``predict(X)``, and ``predict()`` after a fit
    that prepared test data, then give what ``clf`` gives."""
    out = Classifier(clf.clf, num_processed_voxels=clf.num_processed_voxels,
                     epochs_per_subj=clf.epochs_per_subj,
                     use_pallas=clf.use_pallas, device=device)
    for name in _CLASSIFIER_COUNTS:
        if hasattr(clf, name):
            setattr(out, name, int(getattr(clf, name)))
    for name in _CLASSIFIER_ARRAYS:
        if hasattr(clf, name):
            value = getattr(clf, name)
            setattr(out, name, None if value is None else np.asarray(value))
    out.test_raw_data_ = None
    return out
