"""Multi-subject functional alignment (the SRM family) for the port.

PyTorch counterpart of ``brainiak_tpu.funcalign``: the EM and
block-coordinate loops are plain functions of tensors over the stacked
``[subjects, voxels, TRs]`` data, run on ``device`` (default
``"cuda"``).  Ported so far: :mod:`brainiak_tpu_torch.funcalign.srm`
(``SRM``, ``DetSRM``, ``load``).
"""
