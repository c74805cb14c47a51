"""Fused FCMA correlation kernels K1 (``fcma_gram``), K3
(``fcma_corr_normalize``) and K4 (``fcma_sample_gram``).

PyTorch counterpart of ``brainiak_tpu/ops/pallas_kernels.py``'s
``fcma_gram``, ``fcma_corr_normalize`` and ``fcma_sample_gram``.  All
three take the epoch data time-major, ``[E, T, n]`` float32,
epoch-normalized, and run per-epoch correlation -> clamped Fisher-z ->
z-score across each subject's epochs:

* K1 :func:`fcma_gram` reduces the result straight into the unshrunk
  per-voxel Gram ``[B, E, E]``; the ``[B, E, V]`` tensor never reaches
  device memory.
* K3 :func:`fcma_corr_normalize` writes the normalized correlation
  ``[B, E, V]`` once.
* K4 :func:`fcma_sample_gram` is the classifier's: samples in place of
  epochs, groups of ``norm_unit`` samples in place of subjects (or the
  raw correlation when ``norm_unit <= 1``), reduced over both voxel
  axes into the unshrunk sample Gram ``[N, N]``.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fcma_corr.cu``, ``csrc/fcma_sample_gram.cu``, on the tile of
``csrc/fcma_tile.cuh``; source notes there: operation-bound at the
whole-brain shape, a voxel-tile loop inside each block, partials
summed in a fixed order, no atomics).  The main-path routes of K1, K3
and K4 run on the tensor cores in 3xTF32, which keeps fp32 accuracy,
with operands brought in by the TMA.  K1 (:func:`gram_route`) takes
``csrc/fcma_gram_tc.cu`` on one epoch tile of whole subjects (``"tc"``:
at most 32 epochs), ``csrc/fcma_gram_tcm.cu`` on more tiles up to
:data:`TCM_MAX_EPOCHS` = 104 epochs (``"tcm"``: all of a block's epochs
in shared memory, every correlation formed once, no statistics pass),
and, beyond, up to :data:`TCS_MAX_EPOCHS` = 800 epochs, two stages
over slabs of block voxels (``"tcs"``): K3's tensor-core bodies write
the slab's correlation once (``csrc/fcma_corr_tc.cu`` z-scored, or
``csrc/fcma_corr_tcl.cu``'s raw mode, the Fisher-z), and
``csrc/fcma_gram_tcs.cu`` forms its Gram in 3xTF32, z-scoring a raw
slab as it loads it.  ``csrc/fcma_corr.cu`` (``"ffma"``) runs when
forced, and on designs of more than 800 epochs.  K3 on subjects of at
most 4 epochs (:func:`corr_route` ``"tc"``) is ``csrc/fcma_corr_tc.cu``,
on longer subjects (``"tcl"``: chunks of 4 epochs, the raw Fisher-z
stored, then read back for the z-score and normalized in place)
``csrc/fcma_corr_tcl.cu``.  K4 (:func:`sample_gram_route`) takes
``csrc/fcma_sample_gram_tc.cu`` on one sample tile of whole groups
(``"tc"``), ``csrc/fcma_sample_gram_tcm.cu`` on more up to
:data:`TCM_MAX_EPOCHS` = 104 samples (``"tcm"``: K1's multi-tile body,
the block voxels summed in the Gram's own FMA chains), K1's slab route
beyond, up to :data:`TCS_MAX_EPOCHS` = 800 samples (``"tcs"``:
``csrc/fcma_corr_tcl.cu``'s raw mode, or its r mode on raw features,
then ``csrc/fcma_gram_tcs.cu``, then ``csrc/fcma_sample_gram_tcs.cu``
adds the per-block-voxel Grams in block-voxel order), and
``csrc/fcma_sample_gram.cu`` (``"ffma"``) only when forced or beyond
800 samples.  The multi-tile routes of K1 and K4 share
``csrc/tc_gram_m.cuh``.  K1's multi-tile and slab routes (the latter
for subjects of more than 4 epochs), K3's long-subject one and K4's
tensor-core ones form a correlation with ``|r| >= 1 - 2**-10`` again in
fp32 FMA (a voxel with itself).  Every other route computes in fp32
FMA; K3's FMA kernel runs only when forced.
``precision`` is not used by the kernels.  On the FMA routes a subject
(or sample group) may be longer than one epoch tile: the kernels then
run a first pass for its z-score statistics.  On a CPU tensor the wrapper
runs the plain version in this module (:func:`fcma_gram_plain`,
:func:`fcma_corr_normalize_plain`, :func:`fcma_sample_gram_plain`):
``correlate_epochs`` then ``within_subject_normalization`` (then the
Gram), which honors ``precision``.
"""

import ctypes

import torch

from ..device import matmul_precision
from .correlation import correlate_epochs
from .fisherz import within_subject_normalization
from .kernels import _build

__all__ = ["TCM_MAX_EPOCHS", "TCS_MAX_EPOCHS", "aligned_rows_layout",
           "corr_layout", "corr_route", "epoch_tiles",
           "fcma_corr_normalize",
           "fcma_corr_normalize_plain", "fcma_gram", "fcma_gram_plain",
           "fcma_sample_gram", "fcma_sample_gram_plain", "gram_route",
           "launches", "reset_launches", "sample_gram_route",
           "tcs_slabs"]

# "fcma_gram" counts every K1 launch, "fcma_gram_tc" those of them that
# took the tensor-core one-tile kernel, "fcma_gram_tcm" the tensor-core
# multi-tile one, "fcma_gram_tcs" the slab route; that route's kernels,
# one each a slab, under "fcma_gram_tcs_tc" / "_tcl" (the correlation,
# by K3's body "tc" or the raw mode of "tcl") and "fcma_gram_tcs_gram";
# "_tc" and "_tcm" the same for K3 and K4, "_tcl" K3's tensor-core
# kernel for long subjects; "fcma_sample_gram_tcs" K4's slab route, and
# its kernels, one each a slab, under "fcma_sample_gram_tcs_tcl" /
# "_r" (the correlation, by K3's long-subject body in its raw or r
# mode), "_gram" and "_sum" (the block-voxel sum)
_launches = {"fcma_gram": 0, "fcma_gram_tc": 0, "fcma_gram_tcm": 0,
             "fcma_gram_tcs": 0, "fcma_gram_tcs_tc": 0,
             "fcma_gram_tcs_tcl": 0, "fcma_gram_tcs_gram": 0,
             "fcma_corr_normalize": 0, "fcma_corr_normalize_tc": 0,
             "fcma_corr_normalize_tcl": 0,
             "fcma_sample_gram": 0, "fcma_sample_gram_tc": 0,
             "fcma_sample_gram_tcm": 0, "fcma_sample_gram_tcs": 0,
             "fcma_sample_gram_tcs_tcl": 0, "fcma_sample_gram_tcs_r": 0,
             "fcma_sample_gram_tcs_gram": 0,
             "fcma_sample_gram_tcs_sum": 0}

#: threads of a kernel block; a block holds 512 // ept block voxels
_THREADS = 512
#: waves of one block per SM that the V split aims for
_WAVES = 16
_TV = 32
#: voxels of x1 per block of the plain sample Gram
_PLAIN_BLOCK = 128
#: most epochs per subject of K3's route "tc" (a thread holds a
#: subject's epochs of one correlation in registers); longer subjects
#: take "tcl"
_TC_MAX_EPS = 4
#: most epochs (K1) or samples (K4) of the tensor-core multi-tile routes
#: (csrc/fcma_gram_tcm.cu, csrc/fcma_sample_gram_tcm.cu: their z tile of
#: all of them beside the stage ring in shared memory)
TCM_MAX_EPOCHS = 104
#: block voxels a block of that route
_TCM_BLOCK = 8
#: most epochs (K1) or samples (K4) of the slab routes "tcs"
#: (csrc/fcma_gram_tcs.cu: two stages of all E epochs of 32 voxels in
#: shared memory)
TCS_MAX_EPOCHS = 800
#: bytes of that route's slab of normalized correlation [Bc, E, V], as
#: ``distla.gram``'s default budget
_TCS_BUDGET = 8 * 2 ** 30
#: block voxels of an item of K3's tensor-core bodies, the slab's unit
_TCS_UNIT = 128
#: most V splits of its Gram, and the least 32-voxel tiles a split
_TCS_MAX_SPLIT = 8
_TCS_SPLIT_TILES = 64


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


def _check_norm_unit(n_samples, norm_unit):
    if norm_unit > 1 and n_samples % norm_unit:
        raise ValueError(
            f"number of samples ({n_samples}) must be a multiple of "
            f"norm_unit ({norm_unit}); check that data splits respect "
            "subject boundaries")


def fcma_sample_gram_plain(x1, x2, norm_unit, precision=None):
    """Plain version of K4: the unshrunk ``[N, N]`` sample Gram of the
    correlation features, built in blocks of 128 voxels of the wider
    region (the features of (x1, x2) are those of (x2, x1)), so that
    each block's product sums 128 x the narrower width of terms in fp32
    (128 x 65536 of them put the diagonal 1.6e-4 of K[0, 0] off float64
    at 216 samples of 1024 x 65536 voxels, 128 x 1024 1.8e-6)."""
    _check_norm_unit(x1.shape[0], norm_unit)
    if x2.shape[2] > x1.shape[2]:
        x1, x2 = x2, x1
    n = x1.shape[0]
    gram = torch.zeros((n, n), dtype=torch.float32, device=x1.device)
    for s in range(0, x1.shape[2], _PLAIN_BLOCK):
        blk = x1[:, :, s:s + _PLAIN_BLOCK]
        if norm_unit > 1:
            feats = fcma_corr_normalize_plain(blk, x2, norm_unit,
                                              precision=precision)
        else:
            feats = correlate_epochs(blk.transpose(1, 2),
                                     x2.transpose(1, 2),
                                     precision=precision)
        with matmul_precision(precision) as dtype:
            feats = feats.transpose(0, 1).reshape(n, -1).to(dtype)
            gram += torch.matmul(feats, feats.T).float()
    return gram


def epoch_tiles(n_epochs, epochs_per_subj, ept=None):
    """``(ept, tile_len, n_tiles)``: the kernels' epoch-tile capacity
    (16 or 32; by default 16 when ``n_epochs <= 16``), the epochs in
    each tile and the tile count.

    A tile holds whole subjects when a subject fits one
    (``tile_len`` is then a multiple of ``epochs_per_subj``).  A longer
    subject spans several full tiles (``tile_len = ept``), and the
    kernels take its z-score statistics from a first pass.
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
        tile_len = ept
    else:
        tile_len = (ept // epochs_per_subj) * epochs_per_subj
    return ept, tile_len, -(-n_epochs // tile_len)


def gram_route(n_epochs, epochs_per_subj, ept=None, route=None):
    """``(route, ept, tile_len, n_tiles)`` of K1 on the card.

    By shape: ``"tc"`` (``csrc/fcma_gram_tc.cu``) when the epochs form
    one tile of whole subjects; ``"tcm"`` (``csrc/fcma_gram_tcm.cu``)
    for more tiles up to :data:`TCM_MAX_EPOCHS` epochs; ``"tcs"``
    (slabs: ``csrc/fcma_corr_tc.cu`` or ``csrc/fcma_corr_tcl.cu``, then
    ``csrc/fcma_gram_tcs.cu``) beyond, up to :data:`TCS_MAX_EPOCHS`;
    ``"ffma"`` (``csrc/fcma_corr.cu``), which takes every tiling,
    beyond that.  ``ept`` forces the epoch-tile capacity and ``route``
    the kernel, as :func:`epoch_tiles` and ``chip_smoke.py`` do to run
    two kernels on the same inputs; ``"tc"``, ``"tcm"`` and ``"tcs"``
    are refused where they do not apply.
    """
    ept, tile_len, n_tiles = epoch_tiles(n_epochs, epochs_per_subj, ept)
    fits = n_epochs <= TCM_MAX_EPOCHS
    slabs = TCM_MAX_EPOCHS < n_epochs <= TCS_MAX_EPOCHS
    if route is None:
        route = "tc" if n_tiles == 1 else "tcm" if fits else \
            "tcs" if slabs else "ffma"
    elif route not in ("tc", "tcm", "tcs", "ffma"):
        raise ValueError(
            f"route must be 'tc', 'tcm', 'tcs' or 'ffma', got {route!r}")
    elif route == "tc" and n_tiles != 1:
        raise ValueError(
            f"route 'tc' takes one epoch tile; {n_epochs} epochs of "
            f"{epochs_per_subj} per subject need {n_tiles} of {ept}")
    elif route == "tcm" and (n_tiles == 1 or not fits):
        raise ValueError(
            f"route 'tcm' takes more than one epoch tile and at most "
            f"{TCM_MAX_EPOCHS} epochs; {n_epochs} epochs of "
            f"{epochs_per_subj} per subject make {n_tiles} of {ept}")
    elif route == "tcs" and not slabs:
        raise ValueError(
            f"route 'tcs' takes more than {TCM_MAX_EPOCHS} and at most "
            f"{TCS_MAX_EPOCHS} epochs, got {n_epochs}")
    return route, ept, tile_len, n_tiles


def tcs_slabs(n_b, n_epochs, n_vox, budget=_TCS_BUDGET):
    """``(bc, n_slabs)`` of the routes ``"tcs"`` of K1 and K4 (samples
    for epochs): block voxels a slab
    and slabs a call of ``n_b`` block voxels.  A slab of normalized
    correlation, ``[bc, E, V]`` float32, holds at most ``budget`` bytes
    but at least 4 block voxels.  ``bc`` is a multiple of 128 (the block
    voxels of an item of K3's tensor-core bodies, which would compute a
    part-filled item's padding) where the budget holds 128, else of 4
    (each slab's block voxels then start a 16-byte aligned column of
    blk); the slabs are as even as that allows, the last may be
    shorter.  A block voxel's Gram does not depend on ``bc``."""
    fit = budget // (4 * n_epochs * max(n_vox, 1))
    unit = _TCS_UNIT if fit >= _TCS_UNIT else 4
    bc_max = max(4, fit // unit * unit)
    n_slabs = max(1, -(-n_b // bc_max))
    bc = -(-n_b // n_slabs)
    bc = max(4, bc + -bc % unit)
    return min(bc, max(n_b, 1)), -(-n_b // bc)


def _tcs_split(n_vox):
    """V splits of the slab route's Gram, from V alone (so that a block
    voxel's Gram does not depend on the slab): one a
    ``_TCS_SPLIT_TILES`` tiles of 32 voxels, at most
    ``_TCS_MAX_SPLIT``."""
    n_vtiles = -(-n_vox // 32)
    return max(1, min(_TCS_MAX_SPLIT, n_vtiles // _TCS_SPLIT_TILES))


def sample_gram_route(n_samples, norm_unit, route=None):
    """``(route, ept, tile_len, n_tiles)`` of K4 on the card.

    By shape: ``"tc"`` (``csrc/fcma_sample_gram_tc.cu``) when the
    samples form one sample tile of whole groups of ``norm_unit`` (raw
    features, ``norm_unit <= 1``: groups of one); ``"tcm"``
    (``csrc/fcma_sample_gram_tcm.cu``) for more tiles up to
    :data:`TCM_MAX_EPOCHS` samples, whatever the group length (all
    samples of a block sit in shared memory); ``"tcs"`` (slabs:
    ``csrc/fcma_corr_tcl.cu``, ``csrc/fcma_gram_tcs.cu``, then
    ``csrc/fcma_sample_gram_tcs.cu``) beyond, up to
    :data:`TCS_MAX_EPOCHS`, whatever the group length; ``"ffma"``
    (``csrc/fcma_sample_gram.cu``), which takes every tiling, beyond
    that.  ``route`` forces the kernel, as ``chip_smoke.py`` does to
    run two on the same inputs; ``"tc"``, ``"tcm"`` and ``"tcs"`` are
    refused where they do not apply.
    """
    ept, tile_len, n_tiles = epoch_tiles(n_samples, max(norm_unit, 1))
    fits = n_samples <= TCM_MAX_EPOCHS
    slabs = TCM_MAX_EPOCHS < n_samples <= TCS_MAX_EPOCHS
    if route is None:
        route = "tc" if n_tiles == 1 else "tcm" if fits else \
            "tcs" if slabs else "ffma"
    elif route not in ("tc", "tcm", "tcs", "ffma"):
        raise ValueError(
            f"route must be 'tc', 'tcm', 'tcs' or 'ffma', got {route!r}")
    elif route == "tc" and n_tiles != 1:
        raise ValueError(
            f"route 'tc' takes one sample tile; {n_samples} samples in "
            f"groups of {max(norm_unit, 1)} need {n_tiles} of {ept}")
    elif route == "tcm" and (n_tiles == 1 or not fits):
        raise ValueError(
            f"route 'tcm' takes more than one sample tile and at most "
            f"{TCM_MAX_EPOCHS} samples; {n_samples} samples in groups of "
            f"{max(norm_unit, 1)} make {n_tiles} of {ept}")
    elif route == "tcs" and not slabs:
        raise ValueError(
            f"route 'tcs' takes more than {TCM_MAX_EPOCHS} and at most "
            f"{TCS_MAX_EPOCHS} samples, got {n_samples}")
    return route, ept, tile_len, n_tiles


def corr_route(n_epochs, epochs_per_subj, route=None):
    """K3's kernel on the card, whatever ``n_epochs``: ``"tc"``
    (``csrc/fcma_corr_tc.cu``) when a subject has at most 4 epochs,
    else ``"tcl"`` (``csrc/fcma_corr_tcl.cu``).  ``route`` forces one,
    or ``"ffma"`` (``csrc/fcma_corr.cu``, which takes every design), as
    ``chip_smoke.py`` does to run two on the same inputs; ``"tc"`` and
    ``"tcl"`` are refused where they do not apply."""
    epoch_tiles(n_epochs, epochs_per_subj)
    fits = epochs_per_subj <= _TC_MAX_EPS
    if route is None:
        return "tc" if fits else "tcl"
    if route not in ("tc", "tcl", "ffma"):
        raise ValueError(
            f"route must be 'tc', 'tcl' or 'ffma', got {route!r}")
    if route == "tc" and not fits:
        raise ValueError(
            f"route 'tc' takes subjects of at most {_TC_MAX_EPS} epochs, "
            f"got {epochs_per_subj}")
    if route == "tcl" and fits:
        raise ValueError(
            f"route 'tcl' takes subjects of more than {_TC_MAX_EPS} "
            f"epochs, got {epochs_per_subj}")
    return route


def _check_inputs(blk, data, names=("blk", "data"), contiguous=True):
    for name, x in zip(names, (blk, data)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 3:
            raise ValueError(f"{name} must be [E, T, n], got "
                             f"{tuple(x.shape)}")
    if blk.device != data.device:
        raise ValueError(f"{names[0]} and {names[1]} must be on the same "
                         "device")
    if blk.shape[:2] != data.shape[:2]:
        raise ValueError(f"{names[0]} {tuple(blk.shape)} and {names[1]} "
                         f"{tuple(data.shape)} differ in [E, T]")
    if not contiguous:
        return blk, data
    return blk.contiguous(), data.contiguous()


def _n_split(device, n_blocks, n_vox):
    """V splits so that the grid fills about _WAVES waves of the SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_vtiles = max(1, -(-n_vox // _TV))
    return max(1, min(n_vtiles, 65535,
                      -(-_WAVES * sms // max(1, n_blocks))))


def _tcm_split(device, n_b, n_vox):
    """V splits of the multi-tile routes (K1's and K4's "tcm"): their
    blocks of _TCM_BLOCK block voxels, one an SM, in one wave where they
    fill it.  Each split adds a partial Gram, and a block's voxel tiles
    share its ring, so one wave of long blocks beats several of short
    ones."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_vtiles = max(1, -(-n_vox // _TV))
    return max(1, min(n_vtiles, 65535, sms // -(-n_b // _TCM_BLOCK)))


def _stats(blk, data, epochs_per_subj, tile_len):
    """Scratch of the statistics pass, ``[2, B, E / eps, V]``, when a
    subject spans several epoch tiles; else None."""
    if epochs_per_subj <= tile_len:
        return None
    return torch.empty((2, blk.shape[2], blk.shape[0] // epochs_per_subj,
                        data.shape[2]), dtype=torch.float32,
                       device=blk.device)


# (pointers, ints) before the stream of each C entry point
_ARGS = {"fcma_gram_f32": (5, 9), "fcma_gram_tc_f32": (4, 11),
         "fcma_gram_tcm_f32": (4, 10), "fcma_gram_tcs_f32": (3, 5),
         "fcma_corr_fisher_tcl_f32": (3, 8),
         "fcma_corr_r_tcl_f32": (3, 8),
         "fcma_corr_normalize_f32": (4, 9),
         "fcma_corr_normalize_tc_f32": (3, 9),
         "fcma_corr_normalize_tcl_f32": (3, 9),
         "fcma_sample_gram_f32": (5, 9),
         "fcma_sample_gram_tc_f32": (4, 11),
         "fcma_sample_gram_tcm_f32": (4, 10),
         "fcma_sample_gram_tcs_sum_f32": (2, 3)}


def _fn(source, name):
    fn = getattr(_build.load(source), name)
    n_ptrs, n_ints = _ARGS[name]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    return fn


def _ptr(x):
    return None if x is None else x.data_ptr()


def _tma_operand(x):
    """x [E, T, n] as the TMA copies of the tensor-core kernels
    (csrc/fcma_gram_tc.cu, csrc/fcma_gram_tcm.cu, csrc/fcma_corr_tc.cu,
    csrc/fcma_corr_tcl.cu, csrc/fcma_sample_gram_tc.cu,
    csrc/fcma_sample_gram_tcm.cu) read it:
    16-byte aligned, unit column stride, row and epoch strides
    multiples of 4 floats.  Returned as it is where it already is (a
    column slice of an aligned wider tensor, as
    :func:`aligned_rows_layout` lays it out), else copied once into
    that layout; the width stays n."""
    if x.stride(2) == 1 and x.stride(1) % 4 == 0 and \
            x.stride(0) % 4 == 0 and x.data_ptr() % 16 == 0 and \
            min(x.stride(0), x.stride(1)) > 0:
        return x
    out = aligned_rows_layout(x.shape, x.device)
    out.copy_(x)
    return out


def _corr_operand(x, route):
    """x [E, T, n] as K3's kernel of ``route`` reads it: in place where
    it already has that kernel's layout (:func:`corr_layout`), else
    copied once."""
    return x.contiguous() if route == "ffma" else _tma_operand(x)


def aligned_rows_layout(shape, device):
    """An empty float32 ``[E, T, n]`` whose rows are 16-byte aligned:
    the columns of a zero-initialized ``[E, T, n + (-n % 4)]``, so that
    the tensor-core kernels read it without a copy."""
    n_e, n_t, n = shape
    wide = torch.zeros((n_e, n_t, n + -n % 4), dtype=torch.float32,
                       device=device)
    return wide[:, :, :n]


def corr_layout(shape, epochs_per_subj, device):
    """An empty float32 ``[E, T, n]`` that K3's route for subjects of
    ``epochs_per_subj`` epochs (:func:`corr_route`) reads in place:
    :func:`aligned_rows_layout`, whatever ``epochs_per_subj``, since
    both tensor-core kernels (``"tc"`` and ``"tcl"``) read it.  Only
    the FMA kernel, which a call takes only when forced, copies it
    once into a contiguous tensor."""
    return aligned_rows_layout(shape, device)


def _tcs_gram(blk, data, epochs_per_subj, out, budget):
    """K1's route "tcs" into out [B, E, E], slab by slab of
    :func:`tcs_slabs`: the slab's correlation written once by K3's
    tensor-core body (``"tc"``, z-scored, for subjects of at most 4
    epochs; else ``"tcl"``'s raw mode, the Fisher-z), then its Gram
    (``csrc/fcma_gram_tcs.cu``, which z-scores a raw slab as it loads
    it).  blk and data as the TMA reads them (:func:`_tma_operand`)."""
    n_e, n_t, n_b = blk.shape
    n_v = data.shape[2]
    bc, _ = tcs_slabs(n_b, n_e, n_v, budget)
    raw = epochs_per_subj > _TC_MAX_EPS
    n_split = _tcs_split(n_v)
    slab = torch.empty((bc, n_e, n_v), dtype=torch.float32,
                       device=blk.device)
    partial = None if n_split == 1 else torch.empty(
        (n_split, bc, n_e, n_e), dtype=torch.float32, device=blk.device)
    if raw:
        corr = _fn("fcma_corr_tcl", "fcma_corr_fisher_tcl_f32")
        extra, body = (), "tcl"
    else:
        corr = _fn("fcma_corr_tc", "fcma_corr_normalize_tc_f32")
        extra, body = (epochs_per_subj,), "tc"
    gram = _fn("fcma_gram_tcs", "fcma_gram_tcs_f32")
    stream = torch.cuda.current_stream(blk.device).cuda_stream
    with torch.cuda.device(blk.device):
        for b0 in range(0, n_b, bc):
            part = blk[:, :, b0:b0 + bc]
            nb = part.shape[2]
            err = corr(part.data_ptr(), data.data_ptr(), slab.data_ptr(),
                       n_e, n_t, nb, n_v, *extra, part.stride(1),
                       part.stride(0), data.stride(1), data.stride(0),
                       stream)
            _build.check(err, f"fcma_gram (correlation, {body})")
            _launches[f"fcma_gram_tcs_{body}"] += 1
            err = gram(slab.data_ptr(), _ptr(partial), out[b0].data_ptr(),
                       n_e, nb, n_v, epochs_per_subj if raw else 0,
                       n_split, stream)
            _build.check(err, "fcma_gram (Gram)")
            _launches["fcma_gram_tcs_gram"] += 1


def _kernel_gram(blk, data, epochs_per_subj, ept=None, route=None,
                 budget=_TCS_BUDGET):
    """K1 on the card; ``ept`` and ``route`` force the epoch-tile
    capacity and the kernel (:func:`gram_route`), as ``chip_smoke.py``
    does to time two at one shape; ``budget``: the slab bytes of route
    ``"tcs"`` (:func:`tcs_slabs`)."""
    blk, data = _check_inputs(blk, data, contiguous=False)
    n_e, n_t, n_b = blk.shape
    route, ept, tile_len, n_tiles = gram_route(n_e, epochs_per_subj, ept,
                                               route)
    out = torch.empty((n_b, n_e, n_e), dtype=torch.float32,
                      device=blk.device)
    if n_b == 0:
        return out
    if route == "ffma":
        blk, data = blk.contiguous(), data.contiguous()
    else:
        blk, data = _tma_operand(blk), _tma_operand(data)
    if route == "tcs":
        _tcs_gram(blk, data, epochs_per_subj, out, budget)
        _launches["fcma_gram"] += 1
        _launches["fcma_gram_tcs"] += 1
        return out
    n_v = data.shape[2]
    stream = torch.cuda.current_stream(blk.device).cuda_stream
    strides = (blk.stride(1), blk.stride(0), data.stride(1),
               data.stride(0))
    if route == "tcm":
        # every epoch in one block: one [B, E, E] partial a V split, the
        # output itself when there is one split
        n_split = _tcm_split(blk.device, n_b, n_v)
        partial = out if n_split == 1 else torch.empty(
            (n_split, n_b, n_e, n_e), dtype=torch.float32,
            device=blk.device)
    else:
        n_pairs = n_tiles * (n_tiles + 1) // 2
        n_split = _n_split(blk.device,
                           -(-n_b // (_THREADS // ept)) * n_pairs, n_v)
        partial = torch.empty((n_split, n_pairs, n_b, ept, ept),
                              dtype=torch.float32, device=blk.device)
    ptrs = (blk.data_ptr(), data.data_ptr(), partial.data_ptr())
    with torch.cuda.device(blk.device):
        if route == "tcm":
            err = _fn("fcma_gram_tcm", "fcma_gram_tcm_f32")(
                *ptrs, out.data_ptr(), n_e, n_t, n_b, n_v,
                epochs_per_subj, n_split, *strides, stream)
        elif route == "tc":
            err = _fn("fcma_gram_tc", "fcma_gram_tc_f32")(
                *ptrs, out.data_ptr(), n_e, n_t, n_b, n_v,
                epochs_per_subj, ept, n_split, *strides, stream)
        else:
            stats = _stats(blk, data, epochs_per_subj, tile_len)
            err = _fn("fcma_corr", "fcma_gram_f32")(
                *ptrs, _ptr(stats), out.data_ptr(), n_e, n_t, n_b, n_v,
                epochs_per_subj, ept, tile_len, n_tiles, n_split, stream)
    _build.check(err, "fcma_gram")
    _launches["fcma_gram"] += 1
    if route != "ffma":
        _launches[f"fcma_gram_{route}"] += 1
    return out


def _kernel_corr_normalize(blk, data, epochs_per_subj, route=None):
    """K3 on the card; ``route`` forces the kernel (:func:`corr_route`),
    as ``chip_smoke.py`` does to time both at one shape."""
    blk, data = _check_inputs(blk, data, contiguous=False)
    n_e, n_t, n_b = blk.shape
    n_v = data.shape[2]
    route = corr_route(n_e, epochs_per_subj, route)
    out = torch.empty((n_b, n_e, n_v), dtype=torch.float32,
                      device=blk.device)
    if n_b == 0 or n_v == 0:
        return out
    stream = torch.cuda.current_stream(blk.device).cuda_stream
    blk, data = _corr_operand(blk, route), _corr_operand(data, route)
    if route != "ffma":
        with torch.cuda.device(blk.device):
            err = _fn(f"fcma_corr_{route}",
                      f"fcma_corr_normalize_{route}_f32")(
                blk.data_ptr(), data.data_ptr(), out.data_ptr(), n_e, n_t,
                n_b, n_v, epochs_per_subj, blk.stride(1), blk.stride(0),
                data.stride(1), data.stride(0), stream)
    else:
        ept, tile_len, n_tiles = epoch_tiles(n_e, epochs_per_subj)
        n_split = _n_split(blk.device,
                           -(-n_b // (_THREADS // ept)) * n_tiles, n_v)
        stats = _stats(blk, data, epochs_per_subj, tile_len)
        with torch.cuda.device(blk.device):
            err = _fn("fcma_corr", "fcma_corr_normalize_f32")(
                blk.data_ptr(), data.data_ptr(), _ptr(stats),
                out.data_ptr(), n_e, n_t, n_b, n_v, epochs_per_subj, ept,
                tile_len, n_tiles, n_split, stream)
    _build.check(err, "fcma_corr_normalize")
    _launches["fcma_corr_normalize"] += 1
    if route != "ffma":
        _launches[f"fcma_corr_normalize_{route}"] += 1
    return out


def _tcs_sample_gram(blk, data, norm_unit, out, budget):
    """K4's route "tcs" into out [N, N], slab by slab of
    :func:`tcs_slabs`: the slab's correlation written once by K3's
    long-subject body (``csrc/fcma_corr_tcl.cu``: its raw mode, the
    Fisher-z, for groups of ``norm_unit > 1``; its r mode, r itself, for
    raw features), each block voxel's Gram (``csrc/fcma_gram_tcs.cu``,
    which z-scores each group as it loads), then those Grams added into
    out in block-voxel order, slab after slab
    (``csrc/fcma_sample_gram_tcs.cu``), so that out does not depend on
    ``budget``.  blk and data as the TMA reads them
    (:func:`_tma_operand`)."""
    n, n_t, n_b = blk.shape
    n_v = data.shape[2]
    bc, _ = tcs_slabs(n_b, n, n_v, budget)
    n_split = _tcs_split(n_v)
    slab = torch.empty((bc, n, n_v), dtype=torch.float32, device=blk.device)
    grams = torch.empty((bc, n, n), dtype=torch.float32, device=blk.device)
    partial = None if n_split == 1 else torch.empty(
        (n_split, bc, n, n), dtype=torch.float32, device=blk.device)
    if norm_unit > 1:
        corr = _fn("fcma_corr_tcl", "fcma_corr_fisher_tcl_f32")
        body, eps = "tcl", norm_unit
    else:
        corr = _fn("fcma_corr_tcl", "fcma_corr_r_tcl_f32")
        body, eps = "r", 0
    gram = _fn("fcma_gram_tcs", "fcma_gram_tcs_f32")
    total = _fn("fcma_sample_gram_tcs", "fcma_sample_gram_tcs_sum_f32")
    stream = torch.cuda.current_stream(blk.device).cuda_stream
    with torch.cuda.device(blk.device):
        for b0 in range(0, n_b, bc):
            part = blk[:, :, b0:b0 + bc]
            nb = part.shape[2]
            err = corr(part.data_ptr(), data.data_ptr(), slab.data_ptr(),
                       n, n_t, nb, n_v, part.stride(1), part.stride(0),
                       data.stride(1), data.stride(0), stream)
            _build.check(err, f"fcma_sample_gram (correlation, {body})")
            _launches[f"fcma_sample_gram_tcs_{body}"] += 1
            err = gram(slab.data_ptr(), _ptr(partial), grams.data_ptr(), n,
                       nb, n_v, eps, n_split, stream)
            _build.check(err, "fcma_sample_gram (Gram)")
            _launches["fcma_sample_gram_tcs_gram"] += 1
            err = total(grams.data_ptr(), out.data_ptr(), n, nb,
                        int(b0 == 0), stream)
            _build.check(err, "fcma_sample_gram (block-voxel sum)")
            _launches["fcma_sample_gram_tcs_sum"] += 1


def _kernel_sample_gram(x1, x2, norm_unit, route=None, budget=_TCS_BUDGET):
    """K4 on the card; ``route`` forces the kernel
    (:func:`sample_gram_route`), as ``chip_smoke.py`` does to time two
    at one shape; ``budget``: the slab bytes of route ``"tcs"``
    (:func:`tcs_slabs`)."""
    x1, x2 = _check_inputs(x1, x2, ("x1", "x2"), contiguous=False)
    # the features of (x1, x2) are those of (x2, x1): the narrower
    # region is the block operand
    blk, data = (x2, x1) if x2.shape[2] < x1.shape[2] else (x1, x2)
    n, n_t, n_b = blk.shape
    n_v = data.shape[2]
    group = max(norm_unit, 1)
    route, ept, tile_len, n_tiles = sample_gram_route(n, norm_unit, route)
    if n == 0 or n_b == 0 or n_v == 0:
        return torch.zeros((n, n), dtype=torch.float32, device=blk.device)
    if route == "ffma":
        blk, data = blk.contiguous(), data.contiguous()
    else:
        blk, data = _tma_operand(blk), _tma_operand(data)
    out = torch.empty((n, n), dtype=torch.float32, device=blk.device)
    if route == "tcs":
        _tcs_sample_gram(blk, data, norm_unit, out, budget)
        _launches["fcma_sample_gram"] += 1
        _launches["fcma_sample_gram_tcs"] += 1
        return out
    if route == "tcm":
        # one [N, N] partial a (V split, block group of _TCM_BLOCK)
        n_split = _tcm_split(blk.device, n_b, n_v)
        partial = torch.empty((n_split * -(-n_b // _TCM_BLOCK), n, n),
                              dtype=torch.float32, device=blk.device)
    else:
        n_pairs = n_tiles * (n_tiles + 1) // 2
        n_bt = -(-n_b // (_THREADS // ept))
        n_split = _n_split(blk.device, n_bt * n_pairs, n_v)
        partial = torch.empty((n_split * n_bt, n_pairs, ept, ept),
                              dtype=torch.float32, device=blk.device)
    stream = torch.cuda.current_stream(blk.device).cuda_stream
    with torch.cuda.device(blk.device):
        if route == "tcm":
            err = _fn("fcma_sample_gram_tcm", "fcma_sample_gram_tcm_f32")(
                blk.data_ptr(), data.data_ptr(), partial.data_ptr(),
                out.data_ptr(), n, n_t, n_b, n_v, norm_unit, n_split,
                blk.stride(1), blk.stride(0), data.stride(1),
                data.stride(0), stream)
        elif route == "tc":
            err = _fn("fcma_sample_gram_tc", "fcma_sample_gram_tc_f32")(
                blk.data_ptr(), data.data_ptr(), partial.data_ptr(),
                out.data_ptr(), n, n_t, n_b, n_v, norm_unit, ept, n_split,
                blk.stride(1), blk.stride(0), data.stride(1),
                data.stride(0), stream)
        else:
            stats = _stats(blk, data, group, tile_len)
            err = _fn("fcma_sample_gram", "fcma_sample_gram_f32")(
                blk.data_ptr(), data.data_ptr(), partial.data_ptr(),
                _ptr(stats), out.data_ptr(), n, n_t, n_b, n_v, norm_unit,
                ept, tile_len, n_tiles, n_split, stream)
    _build.check(err, "fcma_sample_gram")
    _launches["fcma_sample_gram"] += 1
    if route != "ffma":
        _launches[f"fcma_sample_gram_{route}"] += 1
    return out


def fcma_gram(blk, data, epochs_per_subj, precision=None):
    """K1: fused correlation + normalization + per-voxel Gram.

    blk : [E, T, B]; data : [E, T, V]; returns the unshrunk
    ``[B, E, E]`` float32 Gram (callers apply the digit shrink).  A
    CUDA tensor goes to the kernels of :func:`gram_route` (3xTF32 on
    the tensor cores up to :data:`TCS_MAX_EPOCHS` epochs, else fp32
    FMA, all fp32-accurate; ``precision`` is not used there), a CPU
    tensor to :func:`fcma_gram_plain`.
    """
    if blk.is_cuda:
        return _kernel_gram(blk, data, epochs_per_subj)
    return fcma_gram_plain(blk, data, epochs_per_subj, precision)


def fcma_corr_normalize(blk, data, epochs_per_subj, precision=None):
    """K3: fused correlation + within-subject normalization.

    blk : [E, T, B]; data : [E, T, V]; returns ``[B, E, V]`` float32.
    A CUDA tensor goes to the kernel of :func:`corr_route` (3xTF32 on
    the tensor cores, fp32-accurate, ``precision`` is not used there),
    a CPU tensor to :func:`fcma_corr_normalize_plain`.  The kernel
    reads ``data`` in place when it has that route's layout
    (:func:`corr_layout`), else from one copy a call.
    """
    if blk.is_cuda:
        return _kernel_corr_normalize(blk, data, epochs_per_subj)
    return fcma_corr_normalize_plain(blk, data, epochs_per_subj,
                                     precision)


def fcma_sample_gram(x1, x2, norm_unit, precision=None):
    """K4: the classifier's fused correlation-feature sample Gram.

    x1 : [N, T, V1]; x2 : [N, T, V2], epoch-normalized.  Sample n's
    features are the correlations of every (v1, v2) pair over T; with
    ``norm_unit > 1`` they are Fisher-z'd and z-scored across each
    group of ``norm_unit`` consecutive samples (``N % norm_unit`` must
    be 0, else ``ValueError``), with ``norm_unit <= 1`` they are the
    raw correlations.  Returns the unshrunk ``[N, N]`` float32 Gram
    features @ features.T (callers apply the digit shrink).  A CUDA
    tensor goes to the kernels of :func:`sample_gram_route` (3xTF32 on
    the tensor cores up to :data:`TCS_MAX_EPOCHS` samples, else fp32
    FMA; all fp32-accurate, ``precision`` is not used there), read in
    place where it is aligned, a CPU tensor to
    :func:`fcma_sample_gram_plain`.
    """
    _check_norm_unit(x1.shape[0], norm_unit)
    if x1.is_cuda:
        return _kernel_sample_gram(x1, x2, norm_unit)
    return fcma_sample_gram_plain(x1, x2, norm_unit, precision)
