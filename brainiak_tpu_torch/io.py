"""I/O of the port: NIfTI images, boolean masks, condition-label files.

A copy of ``brainiak_tpu.io`` on the port's
:mod:`brainiak_tpu_torch.nifti` codec and
:mod:`brainiak_tpu_torch.image`: host NumPy, the file front end of
the FCMA workflow (``load_images_from_dir`` / ``load_boolean_mask`` /
``load_labels``, then ``fcma.prepare_fcma_data``).
"""

import logging
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Union

import numpy as np

from . import nifti
from .image import SingleConditionSpec
from .resilience import faults
from .resilience.retry import retry

__all__ = [
    "load_boolean_mask",
    "load_images",
    "load_images_from_dir",
    "load_labels",
    "save_as_nifti_file",
]

logger = logging.getLogger(__name__)


def load_images_from_dir(in_dir: Union[str, Path], suffix: str = "nii.gz",
                         ) -> Iterable[nifti.NiftiImage]:
    """Lazily load all images in a directory whose names end with ``suffix``,
    in sorted order."""
    if isinstance(in_dir, str):
        in_dir = Path(in_dir)
    for f in sorted(in_dir.glob("*" + suffix)):
        logger.debug('Starting to read file %s', f)
        yield nifti.load(str(f))


def load_images(image_paths: Iterable[Union[str, Path]]
                ) -> Iterable[nifti.NiftiImage]:
    """Lazily load images from explicit paths."""
    for image_path in image_paths:
        string_path = str(image_path)
        logger.debug('Starting to read file %s', string_path)
        yield nifti.load(string_path)


def load_boolean_mask(path: Union[str, Path],
                      predicate: Optional[
                          Callable[[np.ndarray], np.ndarray]] = None
                      ) -> np.ndarray:
    """Load a boolean mask volume; ``predicate`` maps data to booleans
    (default: truthiness)."""
    data = nifti.load(str(path)).get_fdata()
    if predicate is not None:
        return predicate(data)
    return data.astype(bool)


@retry(retries=3, backoff=0.25, retriable=(OSError,),
       name="io.load_labels")
def load_labels(path: Union[str, Path]) -> List[SingleConditionSpec]:
    """Load an ``.npy`` of condition-spec arrays as SingleConditionSpec
    views.  Retries transient filesystem errors like the image loaders
    (which inherit retry from ``nifti.load``)."""
    faults.io_point(str(path), site="io.load_labels")
    condition_specs = np.load(str(path))
    return [c.view(SingleConditionSpec) for c in condition_specs]


def save_as_nifti_file(data: np.ndarray, affine: np.ndarray,
                       path: Union[str, Path]) -> None:
    """Save a data volume with the given affine as a NIfTI file."""
    nifti.save(nifti.NiftiImage(data, affine), str(path))
