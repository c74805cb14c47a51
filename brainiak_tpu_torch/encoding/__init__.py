"""Massive voxel-wise encoding models on a CUDA device: the port of
``brainiak_tpu/encoding``.

Batched per-voxel ridge regression with a cross-validated lambda sweep
on the device (:class:`RidgeEncoder`) and its per-feature-band
generalization (:class:`BandedRidgeEncoder`), on the eigendecomposition
solver of "Scaling up ridge regression for brain encoding in a massive
individual fMRI dataset" (https://arxiv.org/pdf/2403.19421).  The
``Xᵀ X`` Gram runs through :func:`brainiak_tpu_torch.ops.distla.gram`
(one ``torch.matmul``, or the SUMMA ring of kernel K5 over a mesh past
the budget), and the sweep is driven resiliently
(``fit(..., checkpoint_dir=)`` resumes mid-sweep).  The JAX package's
``selfcheck`` gate is not ported.
"""

from .ridge import DEFAULT_LAMBDAS, BandedRidgeEncoder, RidgeEncoder

__all__ = [
    "DEFAULT_LAMBDAS",
    "BandedRidgeEncoder",
    "RidgeEncoder",
]
