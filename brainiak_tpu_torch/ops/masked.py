"""Masked elementwise ops.

PyTorch counterpart of ``brainiak_tpu/ops/masked.py``: an elementwise
log with the non-positive entries mapped to -inf, as one op with no
warning.
"""

import torch

__all__ = ["masked_log"]


def masked_log(x):
    """log(x) with x <= 0 mapped to -inf (no warnings), any shape; a
    tensor, or an array converted to one."""
    x = torch.as_tensor(x)
    pos = x > 0
    return torch.where(pos, torch.log(torch.where(pos, x, 1.0)),
                       -torch.inf)
