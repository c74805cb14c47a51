"""Kronecker-structured triangular solves and products.

PyTorch counterpart of ``brainiak_tpu/utils/kronecker_solvers.py``.
The unmasked solves act axis by axis on the reshaped operand, since
(L₁⊗…⊗L_k)⁻¹ = L₁⁻¹⊗…⊗L_k⁻¹ acts independently along each tensor
axis: one ``torch.linalg.solve_triangular`` a factor.

The masked variants solve the principal submatrix of the Kronecker
factor restricted to the valid indices (a principal submatrix of a
triangular matrix is triangular).  They form the dense Kronecker
factor, as the JAX package does: exact, and cheap at the masked sizes
these run at.  Their outputs are written out of place (``index_put``
on a new zeros tensor), so gradients flow through them.
"""

from functools import reduce

import numpy as np
import torch

__all__ = [
    "kept_indices",
    "kron_mult",
    "masked_triangular_solve",
    "solve_lower_triangular_kron",
    "solve_lower_triangular_masked_kron",
    "solve_upper_triangular_kron",
    "solve_kept",
    "solve_upper_triangular_masked_kron",
]


def _axiswise(Ls, y, op):
    """Apply ``op(L, mat)`` along each Kronecker axis of y [prod(n), p]."""
    sizes = [L.shape[0] for L in Ls]
    p = y.shape[1] if y.dim() == 2 else 1
    x = y.reshape(sizes + [p])
    for i, L in enumerate(Ls):
        x = torch.movedim(x, i, 0)
        flat = op(L, x.reshape(sizes[i], -1))
        x = flat.reshape([sizes[i]] + [s for j, s in enumerate(sizes)
                                       if j != i] + [p])
        x = torch.movedim(x, 0, i)
    out = x.reshape(-1, p)
    return out if y.dim() == 2 else out[:, 0]


def solve_lower_triangular_kron(Ls, y):
    """x with (L₀⊗…⊗L_{k-1}) x = y, each L_i lower triangular."""
    return _axiswise(Ls, y, lambda L, m: torch.linalg.solve_triangular(
        L, m, upper=False))


def solve_upper_triangular_kron(Ls, y):
    """x with (L₀⊗…⊗L_{k-1})ᵀ x = y, each L_i lower triangular."""
    return _axiswise(Ls, y, lambda L, m: torch.linalg.solve_triangular(
        L.T, m, upper=True))


def kron_mult(Ls, x):
    """(L₀⊗…⊗L_{k-1}) x."""
    return _axiswise(Ls, x, lambda L, m: L @ m)


def _masked_solve(Ls, y, mask, upper):
    """Solve the mask-restricted triangular Kronecker system by the
    single-matrix primitive; masked rows of the output are zero."""
    return masked_triangular_solve(reduce(torch.kron, Ls), y, mask,
                                   lower=True, adjoint=upper)


def masked_triangular_solve(L, y, mask, lower=True, adjoint=False):
    """Triangular solve restricted to the masked principal submatrix
    (masked rows of the output are zero): the single-matrix primitive
    under the masked Kronecker solves (reference
    kronecker_solvers.py:150-267, ``tf_masked_triangular_solve``).
    ``mask`` is a host boolean vector (NumPy or list)."""
    return solve_kept(L, y, kept_indices(mask, L.device), lower, adjoint)


def kept_indices(mask, device):
    """The indices a host boolean ``mask`` keeps, as a tensor on
    ``device`` (one host-to-device copy: callers that solve often keep
    it)."""
    return torch.as_tensor(np.flatnonzero(np.asarray(mask, bool)),
                           device=device)


def solve_kept(L, y, idx, lower=True, adjoint=False):
    """:func:`masked_triangular_solve` on the kept indices ``idx``."""
    sub = L.index_select(0, idx).index_select(1, idx)
    y2 = y if y.dim() == 2 else y[:, None]
    mat = sub.T if adjoint else sub
    out = torch.linalg.solve_triangular(mat, y2.index_select(0, idx),
                                        upper=lower == adjoint)
    full = torch.zeros_like(y2).index_put((idx,), out)
    return full if y.dim() == 2 else full[:, 0]


def solve_lower_triangular_masked_kron(Ls, y, mask):
    return _masked_solve(Ls, y, mask, upper=False)


def solve_upper_triangular_masked_kron(Ls, y, mask):
    return _masked_solve(Ls, y, mask, upper=True)
