"""Carry state across from the JAX package.

FCMA has no learned weights of its own: a voxel selector's state is
its configuration and its epoch data, a classifier's its configuration,
its host estimator and the arrays its fit left.  A fitted SRM's are
its maps ``w_`` and shared response ``s_`` (with ``sigma_s_``,
``mu_``, ``rho2_`` and ``logprob_``), a DetSRM's ``w_``, ``s_`` and
``objective_``; an RSRM's ``w_``, ``s_``, ``r_`` and ``objective_``,
an SS-SRM's ``w_``, ``s_``, ``theta_``, ``bias_`` and ``classes_``, a
FastSRM's ``basis_list``.  A matrix-normal covariance is its class and
constructor arguments, its parameters a tree of arrays (dicts and
lists); a fitted ``MatnormalRegression``'s state is ``beta_`` and the
fitted covariance parameters, an ``MNRSA``'s ``L_``, ``U_``, ``C_``,
``X_0_`` and its parameters; an inverted encoding model's its
configuration, channels and ``W_``.  The functions here read a
``brainiak_tpu`` object by its attributes (duck typing, without
importing the JAX package) and build the port's counterpart, so that
both compute the same thing.
"""

import numpy as np

from .device import resolve_device
from .fcma.classifier import Classifier
from .fcma.voxelselector import VoxelSelector
from .funcalign.fastsrm import FastSRM
from .funcalign.rsrm import RSRM
from .funcalign.srm import SRM, DetSRM
from .funcalign.sssrm import SSSRM
from .matnormal import covs as mn_covs
from .matnormal.mnrsa import MNRSA
from .matnormal.regression import MatnormalRegression
from .matnormal.utils import place
from .reconstruct.iem import InvertedEncoding1D, InvertedEncoding2D

__all__ = ["classifier_from_jax", "detsrm_from_jax", "fastsrm_from_jax",
           "iem_from_jax", "matnormal_cov_from_jax",
           "matnormal_params_from_jax", "matnormal_regression_from_jax",
           "mnrsa_from_jax", "rsrm_from_jax", "srm_from_jax",
           "sssrm_from_jax", "voxel_selector_from_jax"]

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


def _sized(cov):
    return dict(size=cov.size)


def _given_or_sized(name):
    def args(cov):
        given = getattr(cov, "_" + name + "0")
        return {name: np.asarray(given)} if given is not None \
            else dict(size=cov.size)
    return args


#: the port's constructor arguments of each JAX covariance class
_COV_ARGS = {
    "CovIdentity": _sized,
    "CovUnconstrainedCholeskyWishartReg": _sized,
    "CovIsotropic": lambda c: dict(size=c.size, var=c._var0),
    "CovDiagonal": lambda c: dict(size=c.size, diag_var=c._diag_var0),
    "CovDiagonalGammaPrior": lambda c: dict(
        size=c.size, sigma=c._diag_var0, alpha=c.alpha, beta=c.beta),
    "CovAR1": lambda c: dict(
        size=c.size, rho=c._rho0, sigma=c._sigma0,
        scan_onsets=np.cumsum([0] + [int(r) for r in c.run_sizes[:-1]])),
    "CovUnconstrainedCholesky": _given_or_sized("Sigma"),
    "CovUnconstrainedInvCholesky": _given_or_sized("invSigma"),
    "CovKroneckerFactored": lambda c: dict(
        sizes=list(c.sizes), Sigmas=c._Sigmas0, mask=c.mask),
}


def matnormal_cov_from_jax(cov):
    """The port's covariance object of the JAX package's ``cov``: the
    class of the same name, built from the same constructor arguments
    (so ``init_params`` draws the same numbers)."""
    name = type(cov).__name__
    return getattr(mn_covs, name)(**_COV_ARGS[name](cov))


def matnormal_params_from_jax(params, device="cuda", dtype=None):
    """A covariance or model parameter tree of the JAX package (dicts
    and lists of arrays) as the same tree of tensors on ``device``
    (``dtype``: the arrays' own by default)."""
    return place(params, dtype, resolve_device(device))


def matnormal_regression_from_jax(model, device="cuda"):
    """The port's
    :class:`~brainiak_tpu_torch.matnormal.regression.MatnormalRegression`
    with the JAX package's ``model``'s covariances and configuration
    and, if it was fit, its ``beta_``, fitted covariance parameters and
    ``final_loss_``, so that ``predict`` and ``calibrate`` give what
    ``model``'s give."""
    out = MatnormalRegression(
        matnormal_cov_from_jax(model.time_cov),
        matnormal_cov_from_jax(model.space_cov), optimizer=model.optMethod,
        optCtrl=model.optCtrl, max_iters=model.max_iters, device=device)
    if hasattr(model, "beta_"):
        out.n_c = model.n_c
        out.beta_ = np.asarray(model.beta_)
        out.time_params_ = matnormal_params_from_jax(model.time_params_,
                                                     device)
        out.space_params_ = matnormal_params_from_jax(model.space_params_,
                                                      device)
        out.final_loss_ = float(model.final_loss_)
    return out


def mnrsa_from_jax(model, device="cuda"):
    """The port's :class:`~brainiak_tpu_torch.matnormal.mnrsa.MNRSA`
    with the JAX package's ``model``'s covariances and configuration
    and, if it was fit, its ``L_``, ``U_``, ``C_``, ``X_0_`` (and
    ``naive_U_``), fitted covariance parameters and ``final_loss_``."""
    out = MNRSA(matnormal_cov_from_jax(model.time_cov),
                matnormal_cov_from_jax(model.space_cov),
                n_nureg=model.n_nureg, optimizer=model.optMethod,
                optCtrl=model.optCtrl, max_iters=model.max_iters,
                device=device)
    if hasattr(model, "U_"):
        out.n_c = model.n_c
        for name in ("L_", "U_", "C_", "X_0_", "naive_U_"):
            if hasattr(model, name):
                setattr(out, name, np.asarray(getattr(model, name)))
        out.time_params_ = matnormal_params_from_jax(model.time_params_,
                                                     device)
        out.space_params_ = matnormal_params_from_jax(model.space_params_,
                                                      device)
        out.final_loss_ = float(model.final_loss_)
    return out


def iem_from_jax(model, device="cuda"):
    """The port's
    :class:`~brainiak_tpu_torch.reconstruct.iem.InvertedEncoding1D` or
    ``InvertedEncoding2D`` with the configuration and channels of the
    JAX package's ``model`` and, if it was fit, its ``W_`` (in its own
    dtype), so that ``predict`` and ``score`` give what ``model``'s
    give."""
    if hasattr(model, "stimulus_mode"):
        out = InvertedEncoding1D(
            n_channels=model.n_channels, channel_exp=model.channel_exp,
            stimulus_mode=model.stimulus_mode,
            range_start=model.range_start, range_stop=model.range_stop,
            channel_density=model.channel_density,
            stimulus_resolution=model.stim_res, device=device)
        for name in ("channels_", "channel_centers_"):
            if hasattr(model, name):
                setattr(out, name, np.asarray(getattr(model, name)))
    else:
        out = InvertedEncoding2D(
            model.stim_fov[0], model.stim_fov[1],
            [len(model.stim_pixels[0]), len(model.stim_pixels[1])],
            stim_radius=model.stim_radius_px,
            chan_xlim=model.channel_limits[0],
            chan_ylim=model.channel_limits[1],
            channels=None if model.channels is None
            else np.asarray(model.channels),
            channel_exp=model.channel_exp, device=device)
    if hasattr(model, "W_"):
        out.W_ = np.asarray(model.W_)
    return out
