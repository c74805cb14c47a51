"""Fisher-z transform and within-subject epoch normalization.

PyTorch counterpart of ``brainiak_tpu.ops.fisherz``.  These functions
are the plain versions that the fused correlation kernels (K1, K3 in
:mod:`brainiak_tpu_torch.ops.fcma_kernels`) are held against.
"""

import torch

__all__ = ["fisher_z", "within_subject_normalization"]

_CLAMP = 1e-4


def fisher_z(r):
    """Fisher z-transform ``0.5*log((1+r)/(1-r))`` with numerator and
    denominator floored at 1e-4 when non-positive."""
    r = torch.as_tensor(r, dtype=torch.float32)
    num = 1.0 + r
    den = 1.0 - r
    num = torch.where(num <= 0.0, torch.full_like(num, _CLAMP), num)
    den = torch.where(den <= 0.0, torch.full_like(den, _CLAMP), den)
    return 0.5 * torch.log(num / den)


def within_subject_normalization(corr, epochs_per_subj):
    """Fisher-z, then z-score each correlation across a subject's
    epochs.

    corr : [n_selected_voxels, n_epochs, n_voxels]; the epochs of each
        subject are contiguous and ``n_epochs % epochs_per_subj == 0``.

    The variance is ``E[x^2] - mean^2`` (one pass, as the JAX package
    computes it); a non-positive variance yields zeros.
    """
    b, e, v = corr.shape
    if e % epochs_per_subj != 0:
        raise ValueError(
            f"number of epochs ({e}) must be a multiple of "
            f"epochs_per_subj ({epochs_per_subj}); check that data "
            "splits respect subject boundaries")
    n_subjs = e // epochs_per_subj
    z = fisher_z(corr).reshape(b, n_subjs, epochs_per_subj, v)
    mean = z.mean(dim=2, keepdim=True)
    var = (z * z).mean(dim=2, keepdim=True) - mean * mean
    inv_std = torch.where(var <= 0.0, torch.zeros_like(var),
                          torch.rsqrt(var))
    return ((z - mean) * inv_std).reshape(b, e, v)
