"""Carry state across from the JAX package.

FCMA has no learned weights of its own: a voxel selector's state is
its configuration and its epoch data, a classifier's its configuration,
its host estimator and the arrays its fit left.  A fitted SRM's are
its maps ``w_`` and shared response ``s_`` (with ``sigma_s_``,
``mu_``, ``rho2_`` and ``logprob_``), a DetSRM's ``w_``, ``s_`` and
``objective_``; an RSRM's ``w_``, ``s_``, ``r_`` and ``objective_``,
an SS-SRM's ``w_``, ``s_``, ``theta_``, ``bias_`` and ``classes_``, a
FastSRM's ``basis_list``.  The functions here read a ``brainiak_tpu`` object by
its attributes (duck typing, without importing the JAX package) and
build the port's counterpart, so that both compute the same thing.
"""

import numpy as np

from .fcma.classifier import Classifier
from .fcma.voxelselector import VoxelSelector
from .funcalign.fastsrm import FastSRM
from .funcalign.rsrm import RSRM
from .funcalign.srm import SRM, DetSRM
from .funcalign.sssrm import SSSRM

__all__ = ["classifier_from_jax", "detsrm_from_jax", "fastsrm_from_jax",
           "rsrm_from_jax", "srm_from_jax", "sssrm_from_jax",
           "voxel_selector_from_jax"]

#: fitted attributes of the SRM estimators: per-subject lists, arrays,
#: then floats
_SRM_LISTS = ("w_", "mu_")
_SRM_ARRAYS = ("s_", "sigma_s_", "rho2_")
_SRM_FLOATS = ("logprob_", "objective_")

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


def _srm_from_jax(cls, model, device):
    out = cls(n_iter=model.n_iter, features=model.features,
              rand_seed=model.rand_seed, device=device)
    for name in _SRM_LISTS:
        if hasattr(model, name):
            setattr(out, name, [np.asarray(a) for a in getattr(model,
                                                               name)])
    for name in _SRM_ARRAYS:
        if hasattr(model, name):
            setattr(out, name, np.asarray(getattr(model, name)))
    for name in _SRM_FLOATS:
        if hasattr(model, name):
            setattr(out, name, float(getattr(model, name)))
    return out


def srm_from_jax(model, device="cuda"):
    """The port's :class:`~brainiak_tpu_torch.funcalign.srm.SRM` with
    the configuration (``n_iter``, ``features``, ``rand_seed``) and
    the fitted state of the JAX package's ``model`` (host arrays
    through ``np.asarray``), so that ``transform``,
    ``transform_subject`` and ``save`` give what ``model``'s give.
    The JAX model's mesh is not carried: it names JAX devices."""
    return _srm_from_jax(SRM, model, device)


def detsrm_from_jax(model, device="cuda"):
    """The port's :class:`~brainiak_tpu_torch.funcalign.srm.DetSRM`
    from the JAX package's fitted ``model``, as
    :func:`srm_from_jax`."""
    return _srm_from_jax(DetSRM, model, device)


def rsrm_from_jax(model, device="cuda"):
    """The port's :class:`~brainiak_tpu_torch.funcalign.rsrm.RSRM`
    with the configuration (``n_iter``, ``features``, ``gamma``,
    ``rand_seed``) and the fitted ``w_``, ``s_``, ``r_`` and
    ``objective_`` of the JAX package's ``model``, so that
    ``transform`` and ``transform_subject`` give what ``model``'s
    give."""
    out = RSRM(n_iter=model.n_iter, features=model.features,
               gamma=model.gamma, rand_seed=model.rand_seed, device=device)
    if hasattr(model, "w_"):
        out.w_ = [np.asarray(a) for a in model.w_]
        out.s_ = [np.asarray(a) for a in model.s_]
        out.r_ = np.asarray(model.r_)
        out.objective_ = float(model.objective_)
    return out


def sssrm_from_jax(model, device="cuda"):
    """The port's :class:`~brainiak_tpu_torch.funcalign.sssrm.SSSRM`
    with the configuration and the fitted ``w_``, ``s_``, ``theta_``,
    ``bias_`` and ``classes_`` of the JAX package's ``model``, so that
    ``transform`` and ``predict`` give what ``model``'s give."""
    out = SSSRM(n_iter=model.n_iter, features=model.features,
                gamma=model.gamma, alpha=model.alpha,
                rand_seed=model.rand_seed, device=device)
    if hasattr(model, "w_"):
        out.w_ = [np.asarray(a) for a in model.w_]
        for name in ("s_", "theta_", "bias_", "classes_"):
            setattr(out, name, np.asarray(getattr(model, name)))
    return out


def fastsrm_from_jax(model, device="cuda"):
    """The port's :class:`~brainiak_tpu_torch.funcalign.fastsrm.FastSRM`
    with the configuration of the JAX package's ``model`` (its atlas,
    ``n_components``, ``aggregate``, its spill directory and
    ``low_ram``) and its ``basis_list``, arrays or ``.npy`` paths kept
    as they are, so that ``transform``, ``inverse_transform`` and
    ``add_subjects`` give what ``model``'s give."""
    out = FastSRM(atlas=model.atlas, n_components=model.n_components,
                  n_iter=model.n_iter, seed=model.seed,
                  n_jobs=model.n_jobs, verbose=model.verbose,
                  aggregate=model.aggregate, device=device)
    out.temp_dir = model.temp_dir
    out.low_ram = model.low_ram
    if model.basis_list is not None:
        out.basis_list = [b if isinstance(b, str) else np.asarray(b)
                          for b in model.basis_list]
    return out
