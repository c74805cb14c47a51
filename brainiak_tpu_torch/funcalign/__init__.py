"""Multi-subject functional alignment (the SRM family) for the port.

PyTorch counterpart of ``brainiak_tpu.funcalign``: the EM and
block-coordinate loops are plain functions of tensors over the stacked
``[subjects, voxels, TRs]`` data, run on ``device`` (default
``"cuda"``).  Ported: :mod:`brainiak_tpu_torch.funcalign.srm`
(``SRM``, ``DetSRM``, ``load``), :mod:`~brainiak_tpu_torch.funcalign.rsrm`
(``RSRM``, the robust SRM with sparse individual terms),
:mod:`~brainiak_tpu_torch.funcalign.sssrm` (``SSSRM``, semi-supervised,
on :mod:`brainiak_tpu_torch.ops.optimize`) and
:mod:`~brainiak_tpu_torch.funcalign.fastsrm` (``FastSRM``, atlas-reduced).
"""

from .fastsrm import FastSRM
from .rsrm import RSRM
from .srm import SRM, DetSRM
from .sssrm import SSSRM

__all__ = ["DetSRM", "FastSRM", "RSRM", "SRM", "SSSRM"]
