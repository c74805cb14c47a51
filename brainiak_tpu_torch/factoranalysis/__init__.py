"""Topographic factor analysis (TFA, HTFA) on a CUDA device: the port
of ``brainiak_tpu/factoranalysis``.

The RBF factor ops (:mod:`brainiak_tpu_torch.ops.rbf`) and the ridge
solves run on the device, the bounded NLLS is the port's own L-BFGS
(:mod:`brainiak_tpu_torch.ops.optimize`), and the hierarchical template
update stays on the host over the gathered posteriors."""

from .htfa import HTFA
from .tfa import TFA

__all__ = ["HTFA", "TFA"]
