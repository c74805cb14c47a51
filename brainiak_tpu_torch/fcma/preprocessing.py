"""FCMA data preparation.

PyTorch counterpart of ``brainiak_tpu.fcma.preprocessing``.  Masking,
epoch cutting and the MVPA averages are NumPy/SciPy host work; the
per-epoch normalization of :func:`prepare_fcma_data` runs on
``device`` (on CUDA, kernel K2 of
:mod:`brainiak_tpu_torch.ops.kernels.epoch_norm`, one launch per
distinct epoch shape).  Outputs are lists of ``[T, V]`` float32 numpy
arrays, as in the JAX package.
"""

import logging
from enum import Enum

import numpy as np
from scipy.stats import zscore

from ..image import mask_images, multimask_images
from ..ops.kernels.epoch_norm import normalize_epochs

logger = logging.getLogger(__name__)

__all__ = [
    "generate_epochs_info",
    "prepare_fcma_data",
    "prepare_mvpa_data",
    "prepare_searchlight_mvpa_data",
    "RandomType",
]


class RandomType(Enum):
    """Voxel-permutation null options: NORANDOM, REPRODUCIBLE
    (per-subject-index seed), UNREPRODUCIBLE."""
    NORANDOM = 0
    REPRODUCIBLE = 1
    UNREPRODUCIBLE = 2


def _randomize_single_subject(data, seed=None):
    """Shuffle the voxel dimension of [nVoxels, nTRs] data in place
    (numpy's seeded shuffle: this is host data preparation)."""
    if seed is not None:
        np.random.seed(seed)
    np.random.shuffle(data)


def _randomize_subject_list(data_list, random):
    if random == RandomType.REPRODUCIBLE:
        for i, data in enumerate(data_list):
            _randomize_single_subject(data, seed=i)
    elif random == RandomType.UNREPRODUCIBLE:
        for data in data_list:
            _randomize_single_subject(data)


def _separate_epochs(activity_data, epoch_list, device="cuda"):
    """Cut per-subject [nVoxels, nTRs] data into per-epoch [len, nVoxels]
    blocks, z-scored over time and scaled by 1/sqrt(len) so correlation
    is a plain matmul.

    Returns (raw_data list, labels list)."""
    raw_data = []
    labels = []
    for sid in range(len(epoch_list)):
        epoch = epoch_list[sid]
        for cond in range(epoch.shape[0]):
            sub_epoch = epoch[cond, :, :]
            for eid in range(epoch.shape[1]):
                r = np.sum(sub_epoch[eid, :])
                if r > 0:
                    mat = activity_data[sid][:, sub_epoch[eid, :] == 1]
                    raw_data.append(np.ascontiguousarray(
                        mat.T, dtype=np.float32))
                    labels.append(cond)
    return normalize_epochs(raw_data, device=device), labels


def prepare_fcma_data(images, conditions, mask1, mask2=None,
                      random=RandomType.NORANDOM, device="cuda"):
    """Mask images and cut them into normalized epochs for correlation
    analysis.

    Returns (raw_data1, raw_data2_or_None, labels)."""
    logger.info('start to apply masks and separate epochs')
    raw_data2 = None
    if mask2 is not None:
        activity_data1, activity_data2 = zip(
            *multimask_images(images, (mask1, mask2), np.float32))
        activity_data1 = list(activity_data1)
        activity_data2 = list(activity_data2)
        _randomize_subject_list(activity_data2, random)
        raw_data2, _ = _separate_epochs(activity_data2, conditions,
                                        device=device)
    else:
        activity_data1 = list(mask_images(images, mask1, np.float32))
    _randomize_subject_list(activity_data1, random)
    raw_data1, labels = _separate_epochs(activity_data1, conditions,
                                         device=device)
    return raw_data1, raw_data2, labels


def generate_epochs_info(epoch_list):
    """Flatten condition specs into (label, sid, start, end) tuples."""
    epoch_info = []
    for sid, epoch in enumerate(epoch_list):
        for cond in range(epoch.shape[0]):
            sub_epoch = epoch[cond, :, :]
            for eid in range(epoch.shape[1]):
                r = np.sum(sub_epoch[eid, :])
                if r > 0:
                    start = np.nonzero(sub_epoch[eid, :])[0][0]
                    epoch_info.append((cond, sid, start, start + r))
    return epoch_info


def prepare_mvpa_data(images, conditions, mask):
    """Epoch-averaged, within-subject z-scored activity for MVPA.

    Returns (processed_data [num_voxels, num_epochs], labels)."""
    activity_data = list(mask_images(images, mask, np.float32))
    epoch_info = generate_epochs_info(conditions)
    num_epochs = len(epoch_info)
    d1, _ = activity_data[0].shape
    processed_data = np.empty([d1, num_epochs])
    labels = np.empty(num_epochs)
    subject_count = [0]
    cur_sid = -1
    for idx, epoch in enumerate(epoch_info):
        labels[idx] = epoch[0]
        if cur_sid != epoch[1]:
            subject_count.append(0)
            cur_sid = epoch[1]
        subject_count[-1] += 1
        processed_data[:, idx] = np.mean(
            activity_data[cur_sid][:, epoch[2]:epoch[3]], axis=1)
    cur_epoch = 0
    for i in subject_count:
        if i > 1:
            processed_data[:, cur_epoch:cur_epoch + i] = zscore(
                processed_data[:, cur_epoch:cur_epoch + i], axis=1, ddof=0)
        cur_epoch += i
    return np.nan_to_num(processed_data), labels


def prepare_searchlight_mvpa_data(images, conditions, data_type=np.float32,
                                  random=RandomType.NORANDOM):
    """Epoch-averaged, z-scored activity keeping the 3-D brain
    structure, processed subject by subject.

    Returns (processed_data [x, y, z, num_epochs], labels)."""
    epoch_info = generate_epochs_info(conditions)
    num_epochs = len(epoch_info)
    processed_data = None
    labels = np.empty(num_epochs)
    for idx, epoch in enumerate(epoch_info):
        labels[idx] = epoch[0]
    subject_count = np.zeros(len(conditions), dtype=np.int32)

    for sid, f in enumerate(images):
        data = f.get_fdata().astype(data_type)
        d1, d2, d3, d4 = data.shape
        if random != RandomType.NORANDOM:
            data = data.reshape((d1 * d2 * d3, d4))
            seed = sid if random == RandomType.REPRODUCIBLE else None
            _randomize_single_subject(data, seed=seed)
            data = data.reshape((d1, d2, d3, d4))
        if processed_data is None:
            processed_data = np.empty([d1, d2, d3, num_epochs],
                                      dtype=data_type)
        for idx, epoch in enumerate(epoch_info):
            if sid == epoch[1]:
                subject_count[sid] += 1
                processed_data[:, :, :, idx] = np.mean(
                    data[:, :, :, epoch[2]:epoch[3]], axis=3)

    cur_epoch = 0
    for i in subject_count:
        if i > 1:
            processed_data[:, :, :, cur_epoch:cur_epoch + i] = zscore(
                processed_data[:, :, :, cur_epoch:cur_epoch + i],
                axis=3, ddof=0)
        cur_epoch += i
    return np.nan_to_num(processed_data), labels
