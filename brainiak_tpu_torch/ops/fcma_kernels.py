"""Fused FCMA correlation kernels K1 (``fcma_gram``) and K3
(``fcma_corr_normalize``).

PyTorch counterpart of ``brainiak_tpu/ops/pallas_kernels.py``'s
``fcma_gram`` and ``fcma_corr_normalize``.  Both take the epoch data
time-major, ``blk [E, T, B]`` and ``data [E, T, V]`` float32,
epoch-normalized, and run per-epoch correlation -> clamped Fisher-z ->
z-score across each subject's epochs:

* K1 :func:`fcma_gram` reduces the result straight into the unshrunk
  per-voxel Gram ``[B, E, E]``; the ``[B, E, V]`` tensor never reaches
  device memory.
* K3 :func:`fcma_corr_normalize` writes the normalized correlation
  ``[B, E, V]`` once.

On a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/fcma_corr.cu`` (source note there: operation-bound at the
whole-brain shape, a voxel-tile loop inside each block, partial Grams
summed in a fixed order, no atomics).  The kernels compute in fp32
FMA whatever ``precision`` says.  On a CPU tensor the wrapper runs the
plain version in this module (:func:`fcma_gram_plain`,
:func:`fcma_corr_normalize_plain`): ``correlate_epochs`` then
``within_subject_normalization`` (then the Gram einsum), which honors
``precision``.
"""

import ctypes

import torch

from ..device import matmul_precision
from .correlation import correlate_epochs
from .fisherz import within_subject_normalization
from .kernels import _build

__all__ = ["epoch_tiles", "fcma_corr_normalize",
           "fcma_corr_normalize_plain", "fcma_gram", "fcma_gram_plain",
           "launches", "reset_launches"]

_launches = {"fcma_gram": 0, "fcma_corr_normalize": 0}

#: threads of a kernel block; a block holds 512 // ept block voxels
_THREADS = 512
#: waves of one block per SM that the V split aims for
_WAVES = 16
_TV = 32


def launches():
    """``{kernel: launch count}`` since the last reset."""
    return dict(_launches)


def reset_launches():
    for key in _launches:
        _launches[key] = 0


def fcma_corr_normalize_plain(blk, data, epochs_per_subj,
                              precision=None):
    """Plain version of K3: ``[B, E, V]`` normalized correlation."""
    corr = correlate_epochs(blk.transpose(1, 2), data.transpose(1, 2),
                            precision=precision)
    return within_subject_normalization(corr, epochs_per_subj)


def fcma_gram_plain(blk, data, epochs_per_subj, precision=None):
    """Plain version of K1: the unshrunk ``[B, E, E]`` Gram of the
    normalized correlation."""
    corr = fcma_corr_normalize_plain(blk, data, epochs_per_subj,
                                     precision=precision)
    with matmul_precision(precision) as dtype:
        corr = corr.to(dtype)
        return torch.einsum('bev,bfv->bef', corr, corr).float()


def epoch_tiles(n_epochs, epochs_per_subj, ept=None):
    """``(ept, tile_len, n_tiles)``: the kernel's epoch-tile capacity
    (16 or 32; by default 16 when ``n_epochs <= 16``), the epochs in
    each tile (whole subjects) and the tile count.

    A subject's epochs must fit one tile: more than 32 epochs per
    subject is refused (such a design runs with ``device='cpu'``).
    """
    if n_epochs % epochs_per_subj:
        raise ValueError(
            f"number of epochs ({n_epochs}) must be a multiple of "
            f"epochs_per_subj ({epochs_per_subj}); check that data "
            "splits respect subject boundaries")
    if ept is None:
        ept = 16 if n_epochs <= 16 else 32
    elif ept not in (16, 32):
        raise ValueError(f"ept must be 16 or 32, got {ept}")
    if epochs_per_subj > ept:
        raise ValueError(
            f"the fused FCMA kernels take at most {ept} epochs per "
            f"subject; got epochs_per_subj={epochs_per_subj} (run such "
            "a design with device='cpu')")
    tile_len = (ept // epochs_per_subj) * epochs_per_subj
    return ept, tile_len, -(-n_epochs // tile_len)


def _check_inputs(blk, data):
    for name, x in (("blk", blk), ("data", data)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 3:
            raise ValueError(f"{name} must be [E, T, n], got "
                             f"{tuple(x.shape)}")
    if blk.device != data.device:
        raise ValueError("blk and data must be on the same device")
    if blk.shape[:2] != data.shape[:2]:
        raise ValueError(f"blk {tuple(blk.shape)} and data "
                         f"{tuple(data.shape)} differ in [E, T]")
    return blk.contiguous(), data.contiguous()


def _n_split(device, n_blocks, n_vox):
    """V splits so that the grid fills about _WAVES waves of the SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_vtiles = max(1, -(-n_vox // _TV))
    return max(1, min(n_vtiles, 65535,
                      -(-_WAVES * sms // max(1, n_blocks))))


def _fn(name):
    fn = getattr(_build.load("fcma_corr"), name)
    fn.restype = ctypes.c_int
    n_ptr = 4 if name == "fcma_gram_f32" else 3
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    return fn


def _kernel_gram(blk, data, epochs_per_subj, ept=None):
    """K1 on the card; ``ept`` forces the epoch-tile instantiation (as
    ``chip_smoke.py`` does to time both at one shape)."""
    blk, data = _check_inputs(blk, data)
    n_e, n_t, n_b = blk.shape
    n_v = data.shape[2]
    ept, tile_len, n_tiles = epoch_tiles(n_e, epochs_per_subj, ept)
    n_pairs = n_tiles * (n_tiles + 1) // 2
    out = torch.empty((n_b, n_e, n_e), dtype=torch.float32,
                      device=blk.device)
    if n_b == 0:
        return out
    n_split = _n_split(blk.device, -(-n_b // (_THREADS // ept)) * n_pairs,
                       n_v)
    partial = torch.empty((n_split, n_pairs, n_b, ept, ept),
                          dtype=torch.float32, device=blk.device)
    stream = torch.cuda.current_stream(blk.device).cuda_stream
    with torch.cuda.device(blk.device):
        err = _fn("fcma_gram_f32")(
            blk.data_ptr(), data.data_ptr(), partial.data_ptr(),
            out.data_ptr(), n_e, n_t, n_b, n_v, epochs_per_subj, ept,
            tile_len, n_tiles, n_split, stream)
    _build.check(err, "fcma_gram")
    _launches["fcma_gram"] += 1
    return out


def _kernel_corr_normalize(blk, data, epochs_per_subj):
    blk, data = _check_inputs(blk, data)
    n_e, n_t, n_b = blk.shape
    n_v = data.shape[2]
    ept, tile_len, n_tiles = epoch_tiles(n_e, epochs_per_subj)
    out = torch.empty((n_b, n_e, n_v), dtype=torch.float32,
                      device=blk.device)
    if n_b == 0 or n_v == 0:
        return out
    n_split = _n_split(blk.device, -(-n_b // (_THREADS // ept)) * n_tiles,
                       n_v)
    stream = torch.cuda.current_stream(blk.device).cuda_stream
    with torch.cuda.device(blk.device):
        err = _fn("fcma_corr_normalize_f32")(
            blk.data_ptr(), data.data_ptr(), out.data_ptr(), n_e, n_t,
            n_b, n_v, epochs_per_subj, ept, tile_len, n_tiles, n_split,
            stream)
    _build.check(err, "fcma_corr_normalize")
    _launches["fcma_corr_normalize"] += 1
    return out


def fcma_gram(blk, data, epochs_per_subj, precision=None):
    """K1: fused correlation + normalization + per-voxel Gram.

    blk : [E, T, B]; data : [E, T, V]; returns the unshrunk
    ``[B, E, E]`` float32 Gram (callers apply the digit shrink).  A
    CUDA tensor goes to the kernel (fp32 FMA; ``precision`` is not
    used there), a CPU tensor to :func:`fcma_gram_plain`.
    """
    if blk.is_cuda:
        return _kernel_gram(blk, data, epochs_per_subj)
    return fcma_gram_plain(blk, data, epochs_per_subj, precision)


def fcma_corr_normalize(blk, data, epochs_per_subj, precision=None):
    """K3: fused correlation + within-subject normalization.

    blk : [E, T, B]; data : [E, T, V]; returns ``[B, E, V]`` float32.
    A CUDA tensor goes to the kernel (fp32 FMA; ``precision`` is not
    used there), a CPU tensor to :func:`fcma_corr_normalize_plain`.
    """
    if blk.is_cuda:
        return _kernel_corr_normalize(blk, data, epochs_per_subj)
    return fcma_corr_normalize_plain(blk, data, epochs_per_subj,
                                     precision)
