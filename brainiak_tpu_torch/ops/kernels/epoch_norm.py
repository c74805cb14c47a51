"""FCMA ingest epoch normalization (kernel K2).

PyTorch counterpart of ``brainiak_tpu.ops.kernels.epoch_norm``: the
per-epoch column z-score and ``1/sqrt(T)`` scaling that makes
correlation a plain matmul.  :func:`normalize_epochs` groups epochs by
shape and normalizes each group as one ``[N, T, V]`` batch.

:func:`batch_zscore` takes a batch tensor.  On a CUDA tensor it
launches a hand-written kernel, both of which replace the Pallas
kernel ``brainiak_tpu/ops/kernels/epoch_norm.py::_pallas_batch_zscore``
and are memory-bound (see the source notes); :func:`zscore_route`
picks one:

- ``"tile"``, ``csrc/epoch_norm_tile.cu``: a block reads a ``[T, W]``
  tile of one epoch into shared memory once and writes its output
  once (W from :func:`tile_width`), wherever such a tile of 32 voxels
  fits a block's shared memory (T up to :func:`tile_max_t`);
- ``"simple"``, ``csrc/epoch_norm.cu``: one thread a column, which
  reads it from device memory three times; beyond that T, or forced.

The two give the same bits.  On a CPU tensor :func:`batch_zscore`
runs :func:`batch_zscore_plain`, the same function in plain PyTorch.

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
           "launches", "normalize_epochs", "reset_launches", "tile_max_t",
           "tile_width", "zscore_route"]

#: launches since the last reset: ``epoch_zscore`` every K2 launch,
#: ``epoch_zscore_tile`` / ``epoch_zscore_simple`` those of each route
_launches = {"epoch_zscore": 0, "epoch_zscore_tile": 0,
             "epoch_zscore_simple": 0}

#: shared memory a block may use on Hopper (bytes)
SMEM_MAX = 232448
#: the tile route's widths W (voxels a block): powers of two
TILE_MIN_W, TILE_MAX_W = 32, 1024
#: a tile's target size: several blocks share an SM
TILE_BYTES = 48 * 1024


def launches(route=None):
    """K2 launches since the last :func:`reset_launches`: all of them,
    or those of one ``route`` (``"tile"`` or ``"simple"``)."""
    key = "epoch_zscore" if route is None else f"epoch_zscore_{route}"
    if key not in _launches:
        raise ValueError(f"no K2 route {route!r}")
    return _launches[key]


def reset_launches():
    for key in _launches:
        _launches[key] = 0


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


_SCALARS = {torch.float32: ("f32", ctypes.c_float),
            torch.float64: ("f64", ctypes.c_double)}


def _itemsize(dtype):
    if dtype not in _SCALARS:
        raise TypeError(f"epoch z-score kernel takes float32 or float64, "
                        f"got {dtype}")
    return torch.finfo(dtype).bits // 8


def _tile_smem(t, w, itemsize):
    """Shared memory of a tile-route block: the [T, W] tile, then W
    means and W denominators (``tile_smem`` in the source)."""
    return (t + 2) * w * itemsize


def tile_max_t(dtype):
    """The most rows (T) the tile route takes: a tile of
    :data:`TILE_MIN_W` voxels in a block's shared memory (1814 for
    float32, 906 for float64)."""
    return SMEM_MAX // (TILE_MIN_W * _itemsize(dtype)) - 2


def tile_width(t, dtype):
    """The tile route's W for ``t`` rows: the widest power of two from
    :data:`TILE_MIN_W` to :data:`TILE_MAX_W` whose tile stays within
    :data:`TILE_BYTES` (so several blocks share an SM), else
    :data:`TILE_MIN_W`."""
    itemsize = _itemsize(dtype)
    w = TILE_MAX_W
    while w > TILE_MIN_W and _tile_smem(t, w, itemsize) > TILE_BYTES:
        w //= 2
    return w


def zscore_route(t, dtype, route=None):
    """K2's kernel on the card for ``t`` rows of ``dtype``: ``"tile"``
    (``csrc/epoch_norm_tile.cu``) up to :func:`tile_max_t`, else
    ``"simple"`` (``csrc/epoch_norm.cu``).  ``route`` forces one, as
    ``_kernel_zscore(batch, "simple")`` does to run both on the same
    inputs; ``"tile"`` is refused beyond :func:`tile_max_t`."""
    fits = t <= tile_max_t(dtype)
    if route is None:
        return "tile" if fits else "simple"
    if route not in ("tile", "simple"):
        raise ValueError(f"route must be 'tile' or 'simple', got {route!r}")
    if route == "tile" and not fits:
        raise ValueError(
            f"route 'tile' takes at most {tile_max_t(dtype)} rows of "
            f"{dtype}, got {t}")
    return route


_C_SOURCES = {"tile": ("epoch_norm_tile", "epoch_zscore_tile_"),
              "simple": ("epoch_norm", "epoch_zscore_")}


def _kernel_zscore(batch, route=None):
    """K2 on a CUDA ``[N, T, V]`` tensor, on the kernel of
    :func:`zscore_route` (``route`` forces one)."""
    if batch.dim() != 3:
        raise ValueError(f"expected [N, T, V], got {tuple(batch.shape)}")
    route = zscore_route(batch.shape[1], batch.dtype, route)
    batch = batch.contiguous()
    n, t, v = batch.shape
    out = torch.empty_like(batch)
    suffix, scalar = _SCALARS[batch.dtype]
    source, prefix = _C_SOURCES[route]
    fn = getattr(_build.load(source), prefix + suffix)
    fn.restype = ctypes.c_int
    args = [batch.data_ptr(), out.data_ptr(), n, t, v]
    argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong]
    if route == "tile":
        args.append(tile_width(t, batch.dtype))
        argtypes.append(ctypes.c_int)
    fn.argtypes = argtypes + [scalar, ctypes.c_void_p]
    stream = torch.cuda.current_stream(batch.device).cuda_stream
    with torch.cuda.device(batch.device):
        err = fn(*args, math.sqrt(t), stream)
    _build.check(err, f"epoch_zscore ({route})")
    _launches["epoch_zscore"] += 1
    _launches[f"epoch_zscore_{route}"] += 1
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
