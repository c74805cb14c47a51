"""Statistical ops on tensors for the resampling nulls.

PyTorch counterparts of ``brainiak_tpu/ops/stats.py``.  The JAX ops
draw their phase shifts from a ``jax.random`` key; here the shifts are
an explicit input (angles), or are drawn from a ``torch.Generator`` the
caller passes, never from a hidden global generator.  No kernel of the
JAX package stands behind these: the transforms are ``torch.fft`` calls
on the tensors' device.
"""

import math

import torch

__all__ = ["n_positive_bins", "p_from_null", "percentiles",
           "phase_randomize", "rotate_phases"]


def n_positive_bins(n_trs):
    """Positive-frequency bins ``1 .. n_pos`` that phase randomization
    rotates (the Nyquist bin of an even length is left alone)."""
    return (n_trs - 1) // 2 if n_trs % 2 else n_trs // 2 - 1


def rotate_phases(spectrum, angles, n_trs):
    """Inverse real FFT of ``spectrum`` with bins ``1 .. n_pos``
    rotated by ``angles``.

    spectrum : [F, V, S] complex, ``torch.fft.rfft`` of the series
        along time (``F = n_trs // 2 + 1``).
    angles : [..., n_pos, V or 1, S] real; leading dimensions are
        lanes, each a phase randomization of its own.

    Returns ``[..., n_trs, V, S]``.  The rotated spectrum is Hermitian,
    so this is ``real(ifft(fft(x) * rot))`` with the negative bins
    multiplied by the conjugate rotation, as the JAX op computes it,
    at half the transform length.
    """
    n_pos = angles.shape[-3]
    rot = torch.polar(torch.ones_like(angles), angles).to(spectrum.dtype)
    # one copy of the spectrum a lane, rotated in place
    full = spectrum.expand(angles.shape[:-3] + spectrum.shape).clone()
    full[..., 1:n_pos + 1, :, :] *= rot
    return torch.fft.irfft(full, n=n_trs, dim=-3)


def phase_randomize(data, angles=None, generator=None, voxelwise=False):
    """Phase-randomize time series (dimension 0 = time), keeping their
    power spectra.

    data : [n_TRs, n_voxels, n_subjects] tensor (or [n_TRs,
        n_subjects], treated as one voxel).
    angles : [n_pos, n_voxels or 1, n_subjects] phase shifts in
        radians (one voxel's shifts shared by all voxels unless there
        are ``n_voxels`` of them).  When None they are drawn uniformly
        in ``[0, 2 pi)`` from ``generator`` (required then), shared
        across voxels unless ``voxelwise``.
    """
    squeeze = data.dim() == 2
    if squeeze:
        data = data[:, None, :]
    n_trs, n_voxels, n_subjects = data.shape
    n_pos = n_positive_bins(n_trs)
    if angles is None:
        if generator is None:
            raise ValueError("phase_randomize needs angles or a "
                             "generator to draw them from")
        shift_vox = n_voxels if voxelwise else 1
        angles = torch.rand((n_pos, shift_vox, n_subjects),
                            generator=generator, dtype=data.dtype,
                            device=generator.device) * (2 * math.pi)
    angles = torch.as_tensor(angles, dtype=data.dtype, device=data.device)
    out = rotate_phases(torch.fft.rfft(data, dim=0), angles, n_trs)
    return out[:, 0, :] if squeeze else out


def p_from_null(observed, distribution, side="two-sided", exact=False):
    """p-value of ``observed`` against a floating null whose dimension
    0 indexes the resamples (broadcast over the rest): the raw
    exceedance count over ``n`` when ``exact``, else ``(count + 1) /
    (n + 1)``."""
    n = distribution.shape[0]
    if side == "two-sided":
        numerator = (distribution.abs() >= observed.abs()).sum(dim=0)
    elif side == "left":
        numerator = (distribution <= observed).sum(dim=0)
    elif side == "right":
        numerator = (distribution >= observed).sum(dim=0)
    else:
        raise ValueError("side must be 'two-sided', 'left' or 'right'")
    # in the null's floating dtype (an integer count over an integer
    # would be PyTorch's default float32), divided by a tensor: a CUDA
    # tensor over a Python number is multiplied by its reciprocal,
    # which can move the last bit of NumPy's quotient
    numerator = numerator.to(distribution.dtype)
    if not exact:
        numerator, n = numerator + 1, n + 1
    return numerator / torch.full_like(numerator, n)


def percentiles(x, qs, block=1 << 27):
    """``np.percentile(x, q, axis=0)`` (its default 'linear' method) of
    a floating ``[n, ...]`` tensor for each ``q`` in ``qs``, by sorts
    along dimension 0 on ``x``'s device (a block of columns of at most
    ``block`` elements at a time: a sort needs several times its
    input): the same index arithmetic and the same two-sided
    interpolation (``b - (b - a) (1 - t)`` from ``t = 0.5`` on), so the
    same values; a column holding a NaN gives NaN.  Returns host
    arrays."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    step = max(1, block // max(n, 1))
    terms = []
    for q in qs:
        virtual = (n - 1) * (q / 100.0)
        prev = math.floor(virtual)
        t = virtual - prev
        if virtual >= n - 1:
            prev, t = n - 1, virtual + 1 - n
        terms.append((prev, min(prev + 1, n - 1), t))
    out = [[] for _ in qs]
    for lo in range(0, flat.shape[1], step):
        ordered = torch.sort(flat[:, lo:lo + step], dim=0).values
        has_nan = torch.isnan(ordered[-1])
        for k, (prev, nxt, t) in enumerate(terms):
            a, b = ordered[prev], ordered[nxt]
            diff = b - a
            res = b - diff * (1 - t) if t >= 0.5 else a + diff * t
            out[k].append(torch.where(has_nan, torch.nan, res))
    return [torch.cat(parts).reshape(x.shape[1:]).cpu().numpy()
            for parts in out]
