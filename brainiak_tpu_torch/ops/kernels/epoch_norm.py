"""FCMA ingest epoch normalization (kernel K2).

PyTorch counterpart of ``brainiak_tpu.ops.kernels.epoch_norm``: the
per-epoch column z-score and ``1/sqrt(T)`` scaling that makes
correlation a plain matmul.  :func:`normalize_epochs` groups epochs by
shape and normalizes each group as one ``[N, T, V]`` batch.

:func:`batch_zscore` takes a batch tensor.  On a CUDA tensor it
launches the hand-written kernel ``csrc/epoch_norm.cu`` (which
replaces the Pallas kernel
``brainiak_tpu/ops/kernels/epoch_norm.py::_pallas_batch_zscore``; it
is memory-bound, see the source note); on a CPU tensor it runs
:func:`batch_zscore_plain`, the same function in plain PyTorch.

Numerics: population standard deviation, zero output for exactly
constant columns (max == min), and non-finite results mapped to zero,
so NaN inputs normalize to zero instead of poisoning the epoch.
"""

import ctypes
import math

import numpy as np
import torch

from ...device import resolve_device
from . import _build

__all__ = ["batch_zscore", "batch_zscore_plain", "epoch_zscore",
           "launches", "normalize_epochs", "reset_launches"]

_launches = {"epoch_zscore": 0}


def launches():
    """Kernel launch count since the last :func:`reset_launches`."""
    return _launches["epoch_zscore"]


def reset_launches():
    _launches["epoch_zscore"] = 0


def batch_zscore_plain(batch):
    """Plain PyTorch column z-score over the T axis of ``[N, T, V]``."""
    t = batch.shape[-2]
    mean = batch.mean(dim=-2, keepdim=True)
    var = ((batch - mean) ** 2).mean(dim=-2, keepdim=True)
    out = (batch - mean) / (torch.sqrt(var) * math.sqrt(t))
    constant = batch.amax(dim=-2, keepdim=True) == \
        batch.amin(dim=-2, keepdim=True)
    return torch.where(constant | ~torch.isfinite(out),
                       torch.zeros_like(out), out)


_C_FUNCS = {torch.float32: ("epoch_zscore_f32", ctypes.c_float),
            torch.float64: ("epoch_zscore_f64", ctypes.c_double)}


def _kernel_zscore(batch):
    if batch.dtype not in _C_FUNCS:
        raise TypeError(f"epoch z-score kernel takes float32 or float64, "
                        f"got {batch.dtype}")
    if batch.dim() != 3:
        raise ValueError(f"expected [N, T, V], got {tuple(batch.shape)}")
    batch = batch.contiguous()
    n, t, v = batch.shape
    out = torch.empty_like(batch)
    name, scalar = _C_FUNCS[batch.dtype]
    fn = getattr(_build.load("epoch_norm"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, scalar,
                   ctypes.c_void_p]
    stream = torch.cuda.current_stream(batch.device).cuda_stream
    with torch.cuda.device(batch.device):
        err = fn(batch.data_ptr(), out.data_ptr(), n, t, v,
                 math.sqrt(t), stream)
    _build.check(err, "epoch_zscore")
    _launches["epoch_zscore"] += 1
    return out


def batch_zscore(batch):
    """Column z-score + ``1/sqrt(T)`` of an ``[N, T, V]`` tensor: the
    K2 kernel for a CUDA tensor, :func:`batch_zscore_plain` for a CPU
    tensor.  Returns a new tensor of the same dtype."""
    if batch.is_cuda:
        return _kernel_zscore(batch)
    return batch_zscore_plain(batch)


def epoch_zscore(mat, device="cuda"):
    """Column z-score (population) + ``1/sqrt(rows)`` of one
    ``[rows, cols]`` epoch; zero-variance columns become zero.
    Returns a new numpy array."""
    return normalize_epochs([mat], device=device)[0]


def normalize_epochs(mats, device="cuda"):
    """Normalize a list of ``[rows, cols]`` epochs, grouped by shape so
    each distinct shape is one batch (on CUDA: one K2 launch).  Order
    and dtype are preserved; returns numpy arrays."""
    mats = list(mats)
    if not mats:
        return []
    dev = resolve_device(device)
    out = [None] * len(mats)
    groups = {}
    for i, mat in enumerate(mats):
        groups.setdefault((np.shape(mat), np.asarray(mat).dtype),
                          []).append(i)
    for idxs in groups.values():
        batch = torch.from_numpy(
            np.stack([np.asarray(mats[i]) for i in idxs])).to(dev)
        res = batch_zscore(batch).cpu().numpy()
        for j, i in enumerate(idxs):
            out[i] = res[j]
    return out
