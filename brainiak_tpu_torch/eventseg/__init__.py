"""Event segmentation (HMM with left-to-right event chains) on a CUDA
device: the port of ``brainiak_tpu/eventseg``.

:func:`~brainiak_tpu_torch.eventseg.event.forward_step` is the
single-step forward recursion that the batch forward pass steps
through."""

from .event import EventSegment, forward_step

__all__ = ["EventSegment", "forward_step"]
