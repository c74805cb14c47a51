"""Matrix-normal utilities.

PyTorch counterpart of ``brainiak_tpu/matnormal/utils.py``: the
Cholesky flattening with log-diagonal uniqueness, the matrix-normal
sampler (NumPy, verbatim), a scipy value-and-gradient bridge
(:func:`make_val_and_grad`, the analog of the reference's
utils.py:107-124 TF bridge) for users who optimize their own
matrix-normal losses with ``scipy.optimize.minimize``, and
:func:`ravel` / :func:`unravel`, which flatten a parameter tree in
``jax.flatten_util.ravel_pytree``'s order (dict keys sorted, list
items in order), so that the flat vector of a converted JAX fit is the
port's, entry for entry.
"""

import functools

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "flatten_cholesky_unique",
    "make_val_and_grad",
    "place",
    "ravel",
    "rmn",
    "scaled_I",
    "tril_size",
    "unflatten_cholesky_unique",
    "unravel",
    "x_tx",
    "xx_t",
]


def make_val_and_grad(loss_fn, *, jit=True, device="cuda"):
    """Bridge a scalar PyTorch loss to ``scipy.optimize.minimize``.

    Returns ``f(x, *args) -> (val, grad)`` with a Python float and a
    float64 NumPy gradient, suitable for ``minimize(..., jac=True)``.
    ``x`` is placed on ``device`` (the device of the tensors the loss
    closes over; default ``"cuda"``, which raises without a card) in
    its own dtype, and the gradient comes from ``torch.autograd.grad``
    there.  ``jit`` is kept for the JAX package's signature and does
    nothing: the loss runs eagerly.

    loss_fn : callable taking a flat parameter tensor (plus optional
        fixed args) and returning a scalar tensor.
    """
    del jit
    dev = resolve_device(device)

    def val_and_grad(x, *args):
        with torch.enable_grad():
            xt = torch.as_tensor(np.asarray(x), device=dev) \
                .requires_grad_(True)
            val = loss_fn(xt, *args)
            grad, = torch.autograd.grad(val, xt)
        return float(val.detach()), \
            grad.detach().cpu().numpy().astype(np.float64)

    return val_and_grad


def xx_t(x):
    """x xᵀ (reference matnormal/utils.py:28-37)."""
    return x @ x.T


def x_tx(x):
    """xᵀ x (reference matnormal/utils.py:40-48)."""
    return x.T @ x


def scaled_I(scale, size):
    """scale · I (reference matnormal/utils.py:51-62), in ``scale``'s
    dtype and on its device (the default float dtype for a number)."""
    scale = torch.as_tensor(scale)
    if not scale.is_floating_point():
        scale = scale.to(torch.get_default_dtype())
    return torch.eye(size, dtype=scale.dtype, device=scale.device) * scale


def tril_size(n):
    return (n * (n + 1)) // 2


def unflatten_cholesky_unique(flat, size):
    """Vector [n(n+1)/2] -> lower-triangular Cholesky factor with
    exponentiated diagonal (unique parameterization).  The entries are
    written out of place, so gradients reach ``flat``."""
    idx = torch.tril_indices(size, size, device=flat.device)
    L = flat.new_zeros((size, size)).index_put((idx[0], idx[1]), flat)
    d = torch.diagonal(L)
    return L - torch.diag(d) + torch.diag(torch.exp(d))


def flatten_cholesky_unique(L):
    """Inverse of :func:`unflatten_cholesky_unique` (log diagonal), on
    the host."""
    L = np.asarray(L)
    size = L.shape[0]
    Llog = L - np.diag(np.diag(L)) + np.diag(np.log(np.diag(L)))
    return Llog[np.tril_indices(size)]


def rmn(rowcov, colcov, random_state=None):
    """Draw from a zero-mean matrix-normal with the given row/column
    covariances (reference matnormal/utils.py:8-25)."""
    prng = np.random.RandomState(random_state)
    Z = prng.standard_normal((rowcov.shape[0], colcov.shape[0]))
    return np.linalg.cholesky(rowcov) @ Z @ np.linalg.cholesky(colcov).T


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def _rebuild(tree, pieces):
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], pieces) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(item, pieces) for item in tree)
    return next(pieces)


def ravel(tree):
    """Flatten a tree (dicts, lists, tuples) of tensors into one vector
    in ``ravel_pytree``'s order, in ``torch.cat``'s promoted dtype.
    Returns ``(flat, unravel_fn)`` with ``unravel_fn(vec)`` equal to
    ``unravel(tree, vec)``."""
    flat = torch.cat([leaf.reshape(-1) for leaf in _leaves(tree)])
    return flat, functools.partial(unravel, tree)


def unravel(template, flat):
    """The tree of ``template``'s structure and leaf shapes whose
    leaves are consecutive views of ``flat`` (so gradients reach
    ``flat``): the inverse of :func:`ravel`."""
    shapes = [leaf.shape for leaf in _leaves(template)]
    pieces = (p.reshape(s) for p, s in zip(
        torch.split(flat, [int(np.prod(s)) for s in shapes]), shapes))
    return _rebuild(template, pieces)


def place(tree, dtype=None, device=None):
    """The tree with each leaf (tensor or array) as a tensor of
    ``dtype`` on ``device`` (``None`` keeps the leaf's)."""
    return _rebuild(tree, (torch.as_tensor(
        leaf if isinstance(leaf, torch.Tensor) else np.array(leaf),
        dtype=dtype, device=device) for leaf in _leaves(tree)))
