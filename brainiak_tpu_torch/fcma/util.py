"""Public FCMA correlation routine (host arrays in, host array out).

PyTorch counterpart of ``brainiak_tpu.fcma.util``: the normalize +
matmul pipeline of :func:`brainiak_tpu_torch.ops.correlation
.compute_correlation` on ``device``.
"""

import numpy as np

from ..ops import correlation as _corr_ops

__all__ = ["compute_correlation"]


def compute_correlation(matrix1, matrix2, return_nans=False,
                        device="cuda"):
    """Pearson correlation of the rows of matrix1 with the rows of
    matrix2.

    Accepts [r1, c] and [r2, c] arrays; returns float32 numpy
    [r1, r2].  Rows with zero variance yield 0 (or NaN when
    ``return_nans``).  Computed on ``device`` (``'cuda'`` by default;
    without a CUDA device the call raises ``RuntimeError`` unless
    ``device='cpu'``).
    """
    matrix1 = np.asarray(matrix1)
    matrix2 = np.asarray(matrix2)
    if matrix1.ndim != 2 or matrix2.ndim != 2:
        raise ValueError("Input matrices must be 2D")
    if matrix1.shape[1] != matrix2.shape[1]:
        raise ValueError('Dimension discrepancy')
    return _corr_ops.compute_correlation(
        matrix1, matrix2, return_nans=return_nans,
        device=device).cpu().numpy()
