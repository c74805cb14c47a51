"""brainiak_tpu_torch: the PyTorch and CUDA port of brainiak_tpu.

The port runs on an NVIDIA Hopper GPU (H100).  Every entry point takes
``device=`` and defaults to ``"cuda"``; without a CUDA device it raises
unless the caller passes ``device="cpu"``.  Each kernel that the JAX
package wrote in Pallas is a hand-written CUDA kernel under ``csrc/``
(built with nvcc on first use, see
:mod:`brainiak_tpu_torch.ops.kernels._build`), with a plain PyTorch
version beside it that runs for CPU tensors.

Ported so far: FCMA stage-1 voxel selection
(:mod:`brainiak_tpu_torch.fcma.preprocessing`,
:mod:`brainiak_tpu_torch.fcma.voxelselector`), FCMA stage-2
classification (:mod:`brainiak_tpu_torch.fcma.classifier`,
:mod:`brainiak_tpu_torch.fcma.util`), the device mesh, in one process
or across ``torch.distributed`` processes
(:mod:`brainiak_tpu_torch.parallel`), the SUMMA ring Gram
(:mod:`brainiak_tpu_torch.ops.distla`,
:mod:`brainiak_tpu_torch.ops.ring`), ISC and ISFC
(:mod:`brainiak_tpu_torch.isc`), the SRM family
(:mod:`brainiak_tpu_torch.funcalign`, across processes too), the
searchlight (:mod:`brainiak_tpu_torch.searchlight`), MVPA voxel
selection (:mod:`brainiak_tpu_torch.fcma.mvpa_voxelselector`) and the
ops they run on.
"""

from .device import resolve_device, resolve_precision, set_fp32_defaults

__all__ = ["resolve_device", "resolve_precision", "set_fp32_defaults"]
