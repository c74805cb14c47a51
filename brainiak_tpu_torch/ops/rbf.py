"""Gaussian RBF factor matrices, MTTKRP-style.

PyTorch counterpart of ``brainiak_tpu/ops/rbf.py``: plain functions of
tensors, on the device of their inputs, that autograd differentiates
(the TFA and HTFA objectives take their gradients through them).

- :func:`rbf_factors` expands ``||R_v - c_k||² = ||R_v||² - 2 R_v·c_k
  + ||c_k||²``, so the distance matrix is one matmul plus rank-1
  broadcasts and no ``[V, K, n_dim]`` tensor exists.
- :func:`rbf_weight_products` and :func:`rbf_residual_sum` rebuild
  the factor matrix chunk by chunk over voxels, fused with the
  contraction that consumes it (``FᵀF`` / ``FᵀX`` for the ridge weight
  solve, the residual reduction for the NLLS objective).  The JAX
  package's ``lax.scan`` over chunks is a Python loop over the chunks
  of :func:`_chunked` here: the tail chunk is zero-padded and masked,
  so every chunk has one shape, as there.
"""

import torch

__all__ = ["rbf_factors", "rbf_residual_sum", "rbf_weight_products",
           "reconstruction_residual"]

#: Voxel chunk of the fused factor-times-data contractions (the JAX
#: package's default).
_CHUNK = 1024


def rbf_factors(R, centers, widths):
    """F[v, k] = exp(-||R_v - centers_k||^2 / widths_k).

    R: [n_voxels, n_dim]; centers: [K, n_dim]; widths: [K] or [K, 1].
    Returns [n_voxels, K].

    Distances are translation-invariant, so both operands are
    centred on the coordinate mean first: without it, scanner
    coordinates about 200 mm off the origin make ``||R||² - 2R·c``
    cancel catastrophically in float32.  ``sq`` is clamped at zero,
    since rounding could leave it slightly negative and a factor above
    1.
    """
    widths = widths.reshape(-1)
    mu = R.mean(dim=0, keepdim=True)
    Rc = R - mu
    Cc = centers - mu
    sq = ((Rc * Rc).sum(dim=1)[:, None]
          - 2.0 * Rc @ Cc.T
          + (Cc * Cc).sum(dim=1)[None, :])
    return torch.exp(-torch.clamp(sq, min=0.0) / widths[None, :])


def _chunked(R, X, vmask, chunk):
    """The voxel axis as ``[n_chunks, chunk, ...]`` operands,
    zero-padding the tail; the mask (the voxel mask times the pad
    mask) zeroes pad factor rows so they add nothing to any
    contraction.  Without a pad the operands are views."""
    v = R.shape[0]
    chunk = min(chunk, v) if chunk else v
    pad = (-v) % chunk
    mask = torch.ones((v,), dtype=R.dtype, device=R.device) \
        if vmask is None else vmask.to(R.dtype)
    if pad:
        R = torch.nn.functional.pad(R, (0, 0, 0, pad))
        X = torch.nn.functional.pad(X, (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    n_chunks = R.shape[0] // chunk
    return (R.reshape(n_chunks, chunk, -1),
            X.reshape(n_chunks, chunk, -1),
            mask.reshape(n_chunks, chunk))


def rbf_weight_products(R, centers, widths, X, vmask=None,
                        chunk=_CHUNK):
    """``(FᵀF [K, K], FᵀX [K, T])`` with the factor matrix rebuilt
    chunk by chunk, fused with the accumulation: the inputs of the
    ridge weight solve without the whole ``[V, K]`` F.  ``vmask``
    (optional, [V]) zeroes masked voxels' factor rows."""
    Rc, Xc, mc = _chunked(R, X, vmask, chunk)
    k = centers.shape[0]
    g = torch.zeros((k, k), dtype=R.dtype, device=R.device)
    b = torch.zeros((k, X.shape[1]), dtype=R.dtype, device=R.device)
    for r, x, m in zip(Rc, Xc, mc):
        f = rbf_factors(r, centers, widths) * m[:, None]
        g = g + f.T @ f
        b = b + f.T @ x
    return g, b


def rbf_residual_sum(R, centers, widths, X, W, sigma, vmask=None,
                     tmask=None, nlss_loss="linear", chunk=_CHUNK):
    """``Σ rho((sigma · (X - F W))²)`` with F rebuilt chunk by chunk,
    fused with the residual reduction: the NLLS data term of the TFA /
    HTFA objective.  ``rho`` is the identity for
    ``nlss_loss="linear"`` and the soft-L1 transform otherwise; masked
    rows and columns add zero (pad rows are exactly 0, and rho(0) = 0
    for soft-L1 too)."""
    Rc, Xc, mc = _chunked(R, X, vmask, chunk)
    tm = None if tmask is None else tmask[None, :]
    total = torch.zeros((), dtype=R.dtype, device=R.device)
    for r, x, m in zip(Rc, Xc, mc):
        f = rbf_factors(r, centers, widths) * m[:, None]
        recon = sigma * (x * m[:, None] - f @ W)
        if tm is not None:
            recon = recon * tm
        sq = recon * recon
        if nlss_loss == "soft_l1":
            total = total + torch.sum(2.0 * (torch.sqrt(1.0 + sq) - 1.0))
        else:
            total = total + torch.sum(sq)
    return total


def reconstruction_residual(X, F, W, sigma):
    """sigma * (X - F @ W), the reference's ``recon`` kernel
    (tfa_extension.cpp:169-239)."""
    return sigma * (X - F @ W)
