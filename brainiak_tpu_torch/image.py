"""Image masking and condition specs for the PyTorch port.

A copy of ``brainiak_tpu.image`` (NumPy only, host data): images are
any object exposing ``get_fdata()`` (such as
:class:`brainiak_tpu_torch.nifti.NiftiImage`), or a plain array.
"""

import itertools
from typing import Iterable, Optional, Sequence, Type, TypeVar

import numpy as np

__all__ = [
    "ConditionSpec",
    "MaskedMultiSubjectData",
    "mask_image",
    "mask_images",
    "multimask_images",
    "SingleConditionSpec",
]

T = TypeVar("T", bound="MaskedMultiSubjectData")


class MaskedMultiSubjectData(np.ndarray):
    """Array with shape (n_TRs, n_voxels, n_subjects)."""

    @classmethod
    def from_masked_images(cls: Type[T], masked_images: Iterable[np.ndarray],
                           n_subjects: int) -> T:
        """Stack per-subject (n_voxels, n_TRs) masked images into
        (n_TRs, n_voxels, n_subjects); raises ValueError on shape mismatch
        or a count different from ``n_subjects``."""
        images = iter(masked_images)
        try:
            first = next(images)
        except StopIteration:
            raise ValueError("n_subjects != number of images: {} != 0"
                             .format(n_subjects))
        expected = first.T.shape
        result = np.empty(expected + (n_subjects,))
        count = 0
        for image in itertools.chain([first], images):
            image = image.T
            if image.shape != expected:
                raise ValueError(
                    "Image {} has different shape from first image: "
                    "{} != {}".format(count, image.shape, expected))
            if count < n_subjects:
                result[:, :, count] = image
            count += 1
        if count != n_subjects:
            raise ValueError("n_subjects != number of images: {} != {}"
                             .format(n_subjects, count))
        return result.view(cls)


class ConditionSpec(np.ndarray):
    """One-hot representation of conditions across epochs and TRs;
    shape (n_conditions, n_epochs, n_TRs)."""


class SingleConditionSpec(ConditionSpec):
    """ConditionSpec with exactly one active condition per epoch."""

    def extract_labels(self) -> np.ndarray:
        """Condition label of each epoch."""
        condition_idxs, epoch_idxs, _ = np.where(self)
        _, unique_epoch_idxs = np.unique(epoch_idxs, return_index=True)
        return condition_idxs[unique_epoch_idxs]


def _image_data(image) -> np.ndarray:
    if hasattr(image, "get_fdata"):
        return image.get_fdata()
    return np.asarray(image)


def mask_image(image, mask: np.ndarray,
               data_type: Optional[type] = None) -> np.ndarray:
    """Apply a boolean spatial mask to an image (time may be the last
    dim).  Returns an array of shape ``(n_mask_voxels[, n_TRs])``."""
    image_data = _image_data(image)
    if image_data.shape[:3] != mask.shape:
        raise ValueError("Image data and mask have different shapes.")
    if data_type is not None:
        image_data = image_data.astype(data_type)
    return image_data[mask]


def multimask_images(images, masks: Sequence[np.ndarray],
                     image_type: Optional[type] = None
                     ) -> Iterable[Sequence[np.ndarray]]:
    """For each image, yield the list of maskings by each mask."""
    for image in images:
        yield [mask_image(image, mask, image_type) for mask in masks]


def mask_images(images, mask: np.ndarray,
                image_type: Optional[type] = None) -> Iterable[np.ndarray]:
    """Yield each image masked by ``mask``."""
    for masked in multimask_images(images, (mask,), image_type):
        yield masked[0]
