"""Image masking for the PyTorch port.

A copy of the masking functions of ``brainiak_tpu.image`` (NumPy
only): images are any object exposing ``get_fdata()``, or a plain
array.
"""

from typing import Iterable, Optional, Sequence

import numpy as np

__all__ = ["mask_image", "mask_images", "multimask_images"]


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
