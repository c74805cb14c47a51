"""Pearson correlation as a matmul of normalized rows.

PyTorch counterpart of ``brainiak_tpu.ops.correlation``: a z-score
(population) and a ``1/sqrt(n)`` scaling turn correlation into a plain
dot product, and the per-epoch correlation of a voxel block against all
voxels is one batched einsum.  These are plain PyTorch functions; the
fused kernels of :mod:`brainiak_tpu_torch.ops.fcma_kernels` hold their
plain versions against them.
"""

import math

import torch

from ..device import matmul_precision, resolve_device, resolve_precision

__all__ = [
    "compute_correlation",
    "correlate_epochs",
    "normalize_for_correlation",
    "resolve_precision",
]


def normalize_for_correlation(data, axis, return_nans=False,
                              device="cuda"):
    """Z-score (population) and scale by ``1/sqrt(n)`` along ``axis``.

    After this, a plain dot product of two normalized vectors is their
    Pearson correlation.  Zero-variance rows produce zeros unless
    ``return_nans``.  Returns a new float32 tensor on ``device``
    (``'cuda'`` by default; without a CUDA device the call raises
    ``RuntimeError`` unless ``device='cpu'``).
    """
    data = torch.as_tensor(data, dtype=torch.float32,
                           device=resolve_device(device))
    n = data.shape[axis]
    mean = data.mean(dim=axis, keepdim=True)
    std = data.std(dim=axis, keepdim=True, correction=0)
    z = (data - mean) / std
    if not return_nans:
        z = torch.where(torch.isfinite(z), z, torch.zeros_like(z))
    return z / math.sqrt(n)


def _matmul(a, b, precision):
    with matmul_precision(precision) as dtype:
        return torch.matmul(a.to(dtype), b.to(dtype)).float()


def compute_correlation(matrix1, matrix2, return_nans=False,
                        precision=None, device="cuda"):
    """Pearson correlation of the rows of ``matrix1`` with the rows of
    ``matrix2``: ``[r1, r2]`` float32 on ``device`` (as in
    :func:`normalize_for_correlation`).  ``precision`` as in
    :func:`brainiak_tpu_torch.device.resolve_precision`."""
    dev = resolve_device(device)
    matrix1 = torch.as_tensor(matrix1, dtype=torch.float32, device=dev)
    matrix2 = torch.as_tensor(matrix2, dtype=torch.float32, device=dev)
    if matrix1.shape[1] != matrix2.shape[1]:
        raise ValueError('Dimension discrepancy')
    m1 = normalize_for_correlation(matrix1, 1, return_nans=return_nans,
                                   device=dev)
    m2 = normalize_for_correlation(matrix2, 1, return_nans=return_nans,
                                   device=dev)
    return _matmul(m1, m2.T, precision)


def correlate_epochs(block_data, all_data, precision=None):
    """Per-epoch correlation of a voxel block against all voxels.

    block_data : [n_epochs, block_voxels, n_TRs] float32, normalized
        along the TR axis (:func:`normalize_for_correlation`).
    all_data : [n_epochs, n_voxels, n_TRs] float32, normalized.

    Returns corr : [block_voxels, n_epochs, n_voxels].
    """
    corr = _matmul(block_data, all_data.transpose(1, 2), precision)
    return corr.permute(1, 0, 2)
