"""Matrix-normal models on a CUDA device: the port of
``brainiak_tpu/matnormal``.

Functional covariance classes (parameters as dicts of tensors), the
matrix-normal likelihoods, and two estimators fit by the port's
L-BFGS on the device (:class:`MatnormalRegression`, :class:`MNRSA`).
For custom losses driven by ``scipy.optimize.minimize``,
:func:`matnormal.utils.make_val_and_grad` is the ``jac=True`` bridge.
"""

from .covs import (  # noqa: F401
    CovAR1,
    CovBase,
    CovDiagonal,
    CovDiagonalGammaPrior,
    CovIdentity,
    CovIsotropic,
    CovKroneckerFactored,
    CovUnconstrainedCholesky,
    CovUnconstrainedCholeskyWishartReg,
    CovUnconstrainedInvCholesky,
)
from .mnrsa import MNRSA  # noqa: F401
from .regression import MatnormalRegression  # noqa: F401
