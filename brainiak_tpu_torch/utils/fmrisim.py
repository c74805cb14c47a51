"""fMRI data simulator, on the card.

The port's counterpart of ``brainiak_tpu/utils/fmrisim.py``: task signal
volumes, stimulus time courses, HRF-convolved signal functions and
realistic scanner noise (system, drift, ARMA, physiological and
task-locked components scaled to a target SNR and SFNR), the estimation
of those noise parameters from data, and 1-D receptive fields.

The design rule is: **draws on the host, arithmetic on the card.**

- Every random number comes from NumPy's global stream, by the same
  calls in the same order as the JAX package's (``np.random.randn``,
  ``normal``, ``rand``, ``permutation``, ``choice`` and
  ``scipy.stats.rice`` / ``expon`` ``.rvs``), so the same
  ``np.random.seed`` gives the same numbers in both packages.  Draws of
  equal shapes that follow one another in the stream are made in one
  call (the ``trs`` spatial fields of the ARMA noise as one
  ``randn(trs, X, Y, Z)``: legacy ``randn`` carries its cached
  Gaussian across calls, so one call equals the loop), and each batch is
  uploaded once, through pinned memory without a host sync.
- All arithmetic runs on ``device`` in float64, with complex128 FFTs:
  the power-law spatial fields (a batch of ``rfftn`` / ``irfftn``, the
  calibration's three trial fields a batch), their masked z-score, the
  ARMA recursion over TRs on the whole volume, the system noise, the
  SFNR's quadratic detrend (one least-squares solve against the shared
  scaled [T, 3] Vandermonde, as ``np.polyfit`` solves it), the SNR's
  5-fold binary dilation (the 6-neighbour cross, zero border: scipy's
  defaults), the FWHM estimate over a batch of volumes, the batched
  ARMA(1,1) Kalman likelihood, the two fit loops of
  :func:`generate_noise`, :func:`convolve_hrf` (one ``conv1d`` over all
  columns), :func:`apply_signal` (a scatter) and
  :func:`compute_signal_change` (over all voxels at once).  Each fit
  loop iteration reads one scalar (the SNR or SFNR of its stopping
  rule) back to the host, and nothing more.

What stays on the host, and why:

- :func:`generate_signal`'s feature volumes (cubes, loops, spheres,
  cavities cut from small meshgrids), built once and uploaded;
- :func:`generate_stimfunction` (returns a NumPy array) and the
  ``export_*`` writers: parsing and writing files;
- ``_drift_power_drop_rate``'s bisection, a scalar root;
- :func:`mask_brain`'s ``ndimage.zoom(order=2)`` and histogram
  threshold, run once a template: scipy's spline prefilter has no
  exact torch twin, and the mask then lives on the card;
- the HRF kernel (``_double_gamma_hrf``), a formula sampled once.

Entry points take ``device=`` (default ``"cuda"``; without a card they
raise unless given ``"cpu"``), accept NumPy arrays or tensors, and
return float64 tensors on ``device``.  Without ``mask_self``,
:func:`mask_brain` loads the port's own copy of the packaged brain
template (``sim_parameters/brain_template.npz``).
"""

import logging
import math
import os

import numpy as np
import torch
from scipy import ndimage, signal, stats

from ..device import resolve_device

logger = logging.getLogger(__name__)

__all__ = [
    "apply_signal",
    "calc_noise",
    "compute_signal_change",
    "convolve_hrf",
    "export_3_column",
    "export_epoch_file",
    "generate_1d_gaussian_rfs",
    "generate_1d_rf_responses",
    "generate_noise",
    "generate_signal",
    "generate_stimfunction",
    "mask_brain",
]

F64 = torch.float64


# ---------------------------------------------------------------------------
# host <-> device

def _upload(array, dev):
    """A host array as a float64 tensor on ``dev``.  A CUDA copy goes
    through pinned memory, asynchronously: PyTorch's host allocator
    keeps the pinned block until the copy is done, so the host does
    not wait for the card."""
    host = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float64))
    if dev.type != "cuda":
        return host
    pinned = torch.empty(host.shape, dtype=F64, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(dev, non_blocking=True)


def _as64(x, dev):
    """A NumPy array, list or tensor as a float64 tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=F64)
    return _upload(np.asarray(x, dtype=np.float64), dev)


def _host(x):
    """A tensor (on any device) or array-like as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# reductions with NumPy's and scipy's conventions

def _zscore(x, dim):
    """``scipy.stats.zscore(x, axis=dim)``: ddof 0, and NaN where the
    standard deviation is at most eps times the mean (a constant
    slice)."""
    mean = x.mean(dim=dim, keepdim=True)
    centred = x - mean
    std = (centred * centred).mean(dim=dim, keepdim=True).sqrt()
    z = centred / std
    const = std <= (torch.finfo(F64).eps * mean).abs()
    return z.masked_fill(const, float("nan"))


def _nanstd(x, dim=None):
    """``np.nanstd`` (ddof 0) over ``dim`` (all elements when None)."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    nan = torch.isnan(x)
    count = (~nan).sum(dim=dim, keepdim=True)
    mean = torch.where(nan, 0, x).sum(dim=dim, keepdim=True) / count
    dev = torch.where(nan, 0, x - mean)
    return ((dev * dev).sum(dim=dim, keepdim=True) / count).sqrt() \
        .squeeze(dim)


class _Mask:
    """A mask on the card with the flat indices of its brain voxels
    (``mask > 0``), its non-brain voxels for the SNR and the SFNR's
    detrend basis, each found once, so that the fit loops read them
    without a host sync."""

    def __init__(self, mask):
        self.mask = mask
        self.inside = torch.nonzero(mask.reshape(-1) > 0).squeeze(1)
        self._outside = {}
        self._trend = {}

    def trend_basis(self, n_t):
        """``np.polyfit``'s quadratic fit against 1..n_t: the
        pseudo-inverse of the [n_t, 3] Vandermonde with columns scaled
        to unit norm (SVD, polyfit's cut-off ``n_t * eps``), the column
        scales, 1..n_t and its squares."""
        if n_t not in self._trend:
            seq = torch.linspace(1, n_t, n_t, dtype=F64,
                                 device=self.mask.device)
            seq2 = seq * seq
            lhs = torch.stack([seq2, seq, torch.ones_like(seq)], dim=1)
            scale = (lhs * lhs).sum(dim=0).sqrt()
            pinv = torch.linalg.pinv(lhs / scale,
                                     rtol=n_t * torch.finfo(F64).eps)
            self._trend[n_t] = (pinv, scale, seq, seq2)
        return self._trend[n_t]

    def outside(self, dilation):
        """Flat indices of the voxels outside the mask dilated
        ``dilation`` times (the SNR's non-brain voxels)."""
        if dilation not in self._outside:
            grown = _binary_dilation(self.mask, dilation) \
                if dilation > 0 else self.mask != 0
            self._outside[dilation] = torch.nonzero(
                ~grown.reshape(-1)).squeeze(1)
        return self._outside[dilation]


def _binary_dilation(mask, iterations):
    """``ndimage.binary_dilation(mask, iterations=...)`` with scipy's
    default structure (the cross of the nearest neighbours along each
    axis) and ``border_value=0``."""
    grown = mask != 0
    for _ in range(iterations):
        step = grown.clone()
        for axis in range(grown.dim()):
            n = grown.shape[axis]
            step.narrow(axis, 1, n - 1).logical_or_(
                grown.narrow(axis, 0, n - 1))
            step.narrow(axis, 0, n - 1).logical_or_(
                grown.narrow(axis, 1, n - 1))
        grown = step
    return grown


# ---------------------------------------------------------------------------
# signal generation (feature volumes on the host)

def _insert_idxs(feature_centre, feature_size, dimensions):
    """Clip a feature's bounding box to the volume."""
    def axis_idx(centre, dim):
        lo = int(centre - feature_size / 2) + 1
        hi = int(centre - feature_size / 2 + feature_size) + 1
        return [max(lo, 0), min(hi, int(dim))]

    x_idx = axis_idx(feature_centre[0], dimensions[0])
    y_idx = axis_idx(feature_centre[1], dimensions[1])
    z_idx = axis_idx(feature_centre[2], dimensions[2])
    return x_idx, y_idx, z_idx


def _generate_feature(feature_type, feature_size, signal_magnitude,
                      thickness=1):
    """One cube/loop/cavity/sphere feature (host)."""
    if feature_size <= 2:
        feature_type = 'cube'

    if feature_type == 'cube':
        sig = np.ones((feature_size,) * 3)
    elif feature_type == 'loop':
        sig = np.zeros((feature_size,) * 3)
        seq = np.linspace(0, feature_size - 1, feature_size)
        xx, yy = np.meshgrid(seq, seq)
        disk = (xx - (feature_size - 1) / 2) ** 2 + \
            (yy - (feature_size - 1) / 2) ** 2
        outer_lim = disk[int((feature_size - 1) / 2), 0]
        inner_lim = disk[int((feature_size - 1) / 2), thickness]
        loop = (disk <= outer_lim) != (disk <= inner_lim)
        if not loop.any():
            loop = disk <= outer_lim
        sig[:, :, int(np.round(feature_size / 2))] = loop
    elif feature_type in ('sphere', 'cavity'):
        seq = np.linspace(0, feature_size - 1, feature_size)
        xx, yy, zz = np.meshgrid(seq, seq, seq)
        dist = ((xx - (feature_size - 1) / 2) ** 2 +
                (yy - (feature_size - 1) / 2) ** 2 +
                (zz - (feature_size - 1) / 2) ** 2)
        c = int((feature_size - 1) / 2)
        outer_lim = dist[c, c, 0]
        inner_lim = dist[c, c, thickness]
        if feature_type == 'sphere':
            sig = dist <= outer_lim
        else:
            sig = (dist <= outer_lim) != (dist <= inner_lim)
        sig = sig.astype(float)
    else:
        raise ValueError("Unknown feature type: {}".format(feature_type))
    return np.asarray(sig, dtype=float) * signal_magnitude


def generate_signal(dimensions, feature_coordinates, feature_size,
                    feature_type, signal_magnitude=[1], signal_constant=1,
                    device="cuda"):
    """A single signal volume with cube/loop/cavity/sphere features,
    built on the host (one ``np.random.random`` draw a feature when
    ``signal_constant == 0``) and returned on ``device``."""
    dev = resolve_device(device)
    volume_signal = np.zeros(_host(dimensions).astype(int))
    feature_coordinates = _host(feature_coordinates)
    if feature_coordinates.ndim == 1:
        feature_coordinates = feature_coordinates[np.newaxis]
    n = feature_coordinates.shape[0]
    feature_size = list(feature_size) * n if len(feature_size) == 1 \
        else list(feature_size)
    feature_type = list(feature_type) * n if len(feature_type) == 1 \
        else list(feature_type)
    signal_magnitude = list(signal_magnitude) * n \
        if len(signal_magnitude) == 1 else list(signal_magnitude)

    for i in range(n):
        centre = np.asarray(feature_coordinates[i])
        sig = _generate_feature(feature_type[i], feature_size[i],
                                signal_magnitude[i])
        if signal_constant == 0:
            sig = sig * np.random.random([feature_size[i]] * 3)
        x_idx, y_idx, z_idx = _insert_idxs(centre, feature_size[i],
                                           volume_signal.shape)
        volume_signal[x_idx[0]:x_idx[1], y_idx[0]:y_idx[1],
                      z_idx[0]:z_idx[1]] = \
            sig[:x_idx[1] - x_idx[0], :y_idx[1] - y_idx[0],
                :z_idx[1] - z_idx[0]]
    return _upload(volume_signal, dev)


def generate_stimfunction(onsets, event_durations, total_time, weights=[1],
                          timing_file=None, temporal_resolution=100.0):
    """Boxcar stimulus time course [samples, 1] at the given temporal
    resolution, as a host NumPy array."""
    if timing_file is not None:
        onsets, event_durations, weights = [], [], []
        with open(timing_file) as f:
            for line in f:
                onset, duration, weight = line.strip().split()
                upsampled = float(onset) * temporal_resolution
                if not np.allclose(upsampled, np.round(upsampled)):
                    logger.warning(
                        'Onset %s has more decimal points than the '
                        'specified temporal resolution can resolve.', onset)
                onsets.append(float(onset))
                event_durations.append(float(duration))
                weights.append(float(weight))

    if len(event_durations) == 1:
        event_durations = list(event_durations) * len(onsets)
    if len(weights) == 1:
        weights = list(weights) * len(onsets)
    if len(onsets) and np.max(onsets) > total_time:
        raise ValueError('Onsets outside of range of total time.')

    stimfunction = np.zeros((int(round(total_time * temporal_resolution)),
                             1))
    for i in range(len(onsets)):
        onset_idx = int(np.floor(onsets[i] * temporal_resolution))
        offset_idx = int(np.floor((onsets[i] + event_durations[i])
                                  * temporal_resolution))
        stimfunction[onset_idx:offset_idx, 0] = weights[i]
    return stimfunction


def export_3_column(stimfunction, filename, temporal_resolution=100.0):
    """Append an FSL-style 3-column (onset, duration, weight) file."""
    stimfunction = _host(stimfunction)
    i = 0
    with open(filename, "a") as f:
        while i < stimfunction.shape[0]:
            if stimfunction[i, 0] != 0:
                onset = i / temporal_resolution
                weight = stimfunction[i, 0]
                duration = 0
                while i < stimfunction.shape[0] and \
                        stimfunction[i, 0] != 0:
                    duration += 1
                    i += 1
                f.write("{}\t{}\t{}\n".format(
                    onset, duration / temporal_resolution, weight))
            i += 1


def export_epoch_file(stimfunction, filename, tr_duration,
                      temporal_resolution=100.0):
    """Write a BrainIAK-style epoch file (a condition x epoch x TR
    one-hot array a subject) as .npy: a plain bool array when every
    subject has the same shape, else a pickled object array."""
    epoch_file = [0] * len(stimfunction)
    for ppt_counter, ppt_stim in enumerate(stimfunction):
        ppt_stim = _host(ppt_stim)
        n_conditions = ppt_stim.shape[1]
        trs = int(ppt_stim.shape[0] / (tr_duration * temporal_resolution))
        stride = int(tr_duration * temporal_resolution)
        epochs = []  # (condition, start_tr, end_tr)
        for cond in range(n_conditions):
            course = ppt_stim[::stride, cond][:trs]
            in_epoch = False
            start = 0
            for tr in range(trs):
                if course[tr] != 0 and not in_epoch:
                    in_epoch = True
                    start = tr
                elif course[tr] == 0 and in_epoch:
                    in_epoch = False
                    epochs.append((cond, start, tr))
            if in_epoch:
                epochs.append((cond, start, trs))
        arr = np.zeros((n_conditions, len(epochs), trs), dtype=np.int8)
        for e_idx, (cond, start, end) in enumerate(epochs):
            arr[cond, e_idx, start:end] = 1
        epoch_file[ppt_counter] = arr.astype(bool)
    shapes = {a.shape for a in epoch_file}
    if len(shapes) == 1:
        np.save(filename, np.stack(epoch_file))
    else:
        obj = np.empty(len(epoch_file), dtype=object)
        for i, arr in enumerate(epoch_file):
            obj[i] = arr
        np.save(filename, obj)


def _double_gamma_hrf(response_delay=6, undershoot_delay=12,
                      response_dispersion=0.9, undershoot_dispersion=0.9,
                      response_scale=1, undershoot_scale=0.035,
                      temporal_resolution=100.0):
    """Double-gamma HRF sampled at the given resolution over 30 s (a
    host list)."""
    hrf_length = 30
    t = np.arange(int(hrf_length * temporal_resolution)) \
        / temporal_resolution
    response_peak = response_delay * response_dispersion
    undershoot_peak = undershoot_delay * undershoot_dispersion
    with np.errstate(divide='ignore', invalid='ignore'):
        resp = response_scale * (t / response_peak) ** response_delay * \
            np.exp(-(t - response_peak) / response_dispersion)
        under = undershoot_scale * (t / undershoot_peak) ** \
            undershoot_delay * \
            np.exp(-(t - undershoot_peak / undershoot_dispersion))
    hrf = np.nan_to_num(resp) - np.nan_to_num(under)
    hrf[-1] = 0
    return list(hrf)


def convolve_hrf(stimfunction, tr_duration, hrf_type='double_gamma',
                 scale_function=True, temporal_resolution=100.0,
                 device="cuda"):
    """Convolve stimulus time courses with the HRF and sample them at
    mid-TR, all columns in one float64 ``conv1d`` on ``device``;
    returns [TRs, columns]."""
    dev = resolve_device(device)
    stimfunction = _as64(stimfunction, dev)
    if stimfunction.dim() == 1:
        stimfunction = stimfunction[:, None]
    if stimfunction.shape[0] < stimfunction.shape[1]:
        logger.warning('Stimfunction may be the wrong shape')

    stride = int(temporal_resolution * tr_duration)
    duration = int(stimfunction.shape[0] / stride)

    if isinstance(hrf_type, str):
        if hrf_type != 'double_gamma':
            raise ValueError(
                f"Unrecognized hrf_type {hrf_type!r}: expected "
                "'double_gamma' or an array-like HRF kernel")
        hrf = np.asarray(_double_gamma_hrf(
            temporal_resolution=temporal_resolution))
    else:
        hrf = _host(hrf_type).astype(np.float64)

    # np.convolve(column, hrf)[:duration * stride], sampled from
    # stride // 2 on: conv1d correlates, so the kernel is flipped, the
    # input padded by its length less one on the left, and only the
    # sampled outputs are formed (stride=)
    n_taps = hrf.shape[0]
    start = int(stride / 2)
    x = stimfunction.T[:, None, :]
    x = torch.nn.functional.pad(x, (n_taps - 1, 0))[:, :, start:]
    kernel = _upload(hrf[::-1], dev)[None, None, :]
    vox = torch.nn.functional.conv1d(x, kernel, stride=stride)[:, 0, :]
    vox = vox[:, :duration].T
    if scale_function:
        peak = vox.max(dim=0).values
        vox = torch.where(vox.abs().max(dim=0).values > 0, vox / peak, vox)
    return vox.contiguous()


def apply_signal(signal_function, volume_signal, device="cuda"):
    """Combine a [TR, voxel] signal function with a signal volume into
    an [X, Y, Z, TR] time series: one scatter of the columns into the
    nonzero voxels (C order, as ``np.where`` lists them)."""
    dev = resolve_device(device)
    signal_function = _as64(signal_function, dev)
    volume_signal = _as64(volume_signal, dev)
    if signal_function.dim() == 1:
        signal_function = signal_function[:, None]
    n_trs = signal_function.shape[0]
    flat = volume_signal.reshape(-1)
    sig_idx = torch.nonzero(flat != 0).squeeze(1)
    n_sig_vox = sig_idx.shape[0]
    if signal_function.shape[1] == 1:
        signal_function = signal_function.expand(n_trs, n_sig_vox)
    elif signal_function.shape[1] != n_sig_vox:
        raise IndexError("The number of columns in signal_function does "
                         "not match the number of signal voxels")
    out = torch.zeros((flat.shape[0], n_trs), dtype=F64, device=dev)
    out[sig_idx] = signal_function.T * flat[sig_idx, None]
    return out.reshape(tuple(volume_signal.shape) + (n_trs,))


# ---------------------------------------------------------------------------
# brain mask / template (host)

def _synthetic_brain_template(dims):
    """Procedural stand-in for a grey-matter atlas (host NumPy): union
    of two hemisphere ellipsoids with a bright cortical shell, darker
    interior, and central ventricles, smoothed to scanner-like spatial
    continuity.  Values in [0, 1]."""
    grids = np.meshgrid(*[np.linspace(-1, 1, d) for d in dims],
                        indexing='ij')
    if len(dims) != 3:
        # non-3-D volumes: dims-agnostic radial falloff
        r = np.sqrt(sum((g / 0.8) ** 2 for g in grids))
        t = np.clip(1.2 - r, 0, None)
        return t / t.max() if t.max() > 0 else t
    gx, gy, gz = grids

    def ellipsoid_dist(cx, cy, cz, rx, ry, rz):
        return np.sqrt(((gx - cx) / rx) ** 2 + ((gy - cy) / ry) ** 2
                       + ((gz - cz) / rz) ** 2)

    left = ellipsoid_dist(-0.22, 0.0, 0.0, 0.52, 0.72, 0.62)
    right = ellipsoid_dist(0.22, 0.0, 0.0, 0.52, 0.72, 0.62)
    d_brain = np.minimum(left, right)
    template = np.zeros(dims)
    template[d_brain < 1.0] = 0.75
    template[(d_brain >= 0.85) & (d_brain < 1.0)] = 1.0
    vent = np.minimum(
        ellipsoid_dist(-0.12, 0.05, 0.05, 0.12, 0.22, 0.15),
        ellipsoid_dist(0.12, 0.05, 0.05, 0.12, 0.22, 0.15))
    template[vent < 1.0] = 0.3
    sigma = max(1.0, min(dims) / 24.0)
    template = ndimage.gaussian_filter(template, sigma)
    if template.max() > 0:
        template = template / template.max()
    return template


_PACKAGED_TEMPLATE_CACHE = {}


def _load_packaged_template():
    """The packaged brain template (91 x 109 x 91 uint8 -> [0, 1], host),
    ``_synthetic_brain_template`` on an MNI152-like grid stored as
    package data."""
    if "template" not in _PACKAGED_TEMPLATE_CACHE:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "sim_parameters", "brain_template.npz")
        with np.load(path) as payload:
            _PACKAGED_TEMPLATE_CACHE["template"] = \
                payload["template"].astype(np.float64) / 255.0
    return _PACKAGED_TEMPLATE_CACHE["template"]


def mask_brain(volume, template_name=None, mask_threshold=None,
               mask_self=True, device="cuda"):
    """A binary mask and a continuous template for a volume, computed
    on the host (a zoom and a histogram threshold, once a template) and
    returned as float64 tensors on ``device``.

    With ``mask_self`` the template comes from the volume itself; with
    ``template_name`` from that ``.npy`` file; otherwise from the
    packaged brain template, zoomed to the volume's shape
    (``ndimage.zoom(order=2)``).  A 1-D ``volume`` is read as the
    dimensions of an all-ones volume.  Without ``mask_threshold`` the
    threshold is the minimum between the template histogram's first
    two peaks."""
    dev = resolve_device(device)
    volume = _host(volume).astype(float)
    if volume.ndim == 1:
        volume = np.ones(volume.astype(int))

    if mask_self:
        mask_raw = volume
    elif template_name is not None:
        mask_raw = np.load(template_name)
    else:
        if volume.ndim < 3:
            raise ValueError(
                "mask_brain with mask_self=False and no template_name "
                f"requires a >=3-D volume, got shape {volume.shape}")
        mask_raw = _load_packaged_template()

    if mask_raw.ndim == 4:
        mask_raw = mask_raw[..., 0] if mask_raw.shape[3] == 1 \
            else np.mean(mask_raw, 3)
    template = mask_raw / mask_raw.max()

    if volume.ndim == 3:
        volume = volume[..., np.newaxis]
    if template.shape != volume.shape[:3]:
        zoom_factor = tuple(volume.shape[i] / template.shape[i]
                            for i in range(3))
        template = ndimage.zoom(template, zoom_factor, order=2)
        template[template < 0] = 0

    if mask_threshold is None:
        order = 5
        hist, bins = np.histogram(template.reshape(-1), 100)
        binval = np.concatenate([np.zeros(order), hist])
        bins = np.concatenate([np.zeros(order), bins])
        peaks = signal.argrelmax(binval, order=order)[0][0:2]
        if len(peaks) == 2:
            minima = binval[peaks[0]:peaks[1]].min()
            minima_idx = (np.where(binval[peaks[0]:peaks[1]] == minima)
                          + peaks[0])[-1]
            mask_threshold = bins[minima_idx][0]
        else:
            mask_threshold = 0.5
    mask = (template > mask_threshold).astype(float)
    return _upload(mask, dev), _upload(template, dev)


# ---------------------------------------------------------------------------
# noise components

def _noise_dict_update(noise_dict):
    """Fill missing noise parameters with defaults."""
    default_dict = {'task_sigma': 0, 'drift_sigma': 0, 'auto_reg_sigma': 1,
                    'auto_reg_rho': [0.5], 'ma_rho': [0.0],
                    'physiological_sigma': 0, 'sfnr': 90, 'snr': 50,
                    'max_activity': 1000, 'voxel_size': [1.0, 1.0, 1.0],
                    'fwhm': 4, 'matched': 1}
    for key, value in default_dict.items():
        noise_dict.setdefault(key, value)
    return noise_dict


def _spectral_field(dimensions, exponent, white):
    """Filter white-noise volumes ``[..., X, Y, Z]`` to a
    ``|k|^(-exponent / 2)`` amplitude spectrum, ``k`` in cycles per
    voxel (``fftfreq``), the DC bin zeroed: a batch of real FFTs.  The
    amplitude is even in ``k``, so this is the real part of
    ``ifftn(fftn(white) * amplitude)``."""
    dims = tuple(int(d) for d in dimensions)
    dev = white.device
    freqs = [np.fft.fftfreq(d) for d in dims[:-1]] + \
        [np.fft.rfftfreq(dims[-1])]
    axes = [_upload(f, dev) for f in freqs]
    k2 = axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2
    k = (k2 + axes[2][None, None, :] ** 2).sqrt()
    amplitude = torch.where(k > 0, k.pow(-exponent / 2.0), 0)
    spectrum = torch.fft.rfftn(white, dim=(-3, -2, -1))
    spectrum *= amplitude
    return torch.fft.irfftn(spectrum, s=dims, dim=(-3, -2, -1))


def _standardize(fields):
    """Each field of a batch ``[n, X, Y, Z]`` less its mean, over its
    standard deviation plus 1e-12 (NumPy's ``f.std()``, ddof 0)."""
    dims = (1, 2, 3)
    mean = fields.mean(dim=dims, keepdim=True)
    centred = fields - mean
    std = (centred * centred).mean(dim=dims, keepdim=True).sqrt()
    return centred / (std + 1e-12)


_SPECTRAL_CALIBRATION = {}


def _spectral_exponent_for_fwhm(dimensions, fwhm, device="cuda"):
    """Spectral exponent realizing the requested FWHM on this grid.

    Measured FWHM is monotone in the exponent, so bisect on trial
    fields (three a trial exponent, one batch) measured with the FWHM
    estimator.  Results are cached per (grid, fwhm, device type); a
    private ``default_rng(1234)`` keeps the global NumPy stream
    untouched, and each trial reads one scalar to the host."""
    dev = resolve_device(device)
    dims = tuple(int(d) for d in dimensions)
    key = (dims, round(float(fwhm), 3), dev.type)
    if key in _SPECTRAL_CALIBRATION:
        return _SPECTRAL_CALIBRATION[key]
    rng = np.random.default_rng(1234)
    ones = torch.ones(dims, dtype=F64, device=dev)
    ones_idx = _Mask(ones)

    def measure(exponent, reps=3):
        # one standard_normal((reps, X, Y, Z)) is the reps calls of
        # standard_normal((X, Y, Z)) in a row
        f = _spectral_field(dims, exponent,
                            _upload(rng.standard_normal((reps,) + dims),
                                    dev))
        return float(_fwhm_batch(_standardize(f), ones_idx,
                                 [1.0, 1.0, 1.0]).mean())

    lo, hi = 0.0, 10.0
    if measure(lo) >= fwhm:
        result = lo
    elif measure(hi) <= fwhm:
        result = hi
    else:
        for _ in range(7):
            mid = 0.5 * (lo + hi)
            if measure(mid) < fwhm:
                lo = mid
            else:
                hi = mid
        result = 0.5 * (lo + hi)
    _SPECTRAL_CALIBRATION[key] = result
    return result


def _spatial_fields(n, dimensions, mask, fwhm, dev):
    """``n`` calibrated spatial fields ``[n, X, Y, Z]`` from one
    ``randn(n, X, Y, Z)`` (the same numbers as ``n`` calls of
    ``randn(X, Y, Z)``), z-scored within ``mask`` (a :class:`_Mask`)
    or, without one, over the volume."""
    dims = tuple(int(d) for d in dimensions[:3])
    exponent = _spectral_exponent_for_fwhm(dims, fwhm, dev)
    field = _spectral_field(dims, exponent,
                            _upload(np.random.randn(n, *dims), dev))
    if mask is None:
        return _standardize(field)
    field *= mask.mask
    flat = field.reshape(n, -1)
    flat.index_copy_(1, mask.inside,
                     _zscore(flat.index_select(1, mask.inside), dim=1))
    return field


def _generate_noise_spatial(dimensions, template=None, mask=None, fwhm=4.0,
                            device="cuda"):
    """Gaussian random field with a power-law spatial spectrum whose
    exponent is calibrated so the realized smoothness matches ``fwhm``
    on this grid.  Masked voxels are z-scored within the mask."""
    dev = resolve_device(device)
    if mask is not None and not isinstance(mask, _Mask):
        mask = _Mask(_as64(mask, dev))
    return _spatial_fields(1, dimensions, mask, fwhm, dev)[0]


def _generate_noise_temporal_task(stimfunction_tr, motion_noise='gaussian',
                                  device="cuda"):
    """Task-locked noise, a [T] tensor."""
    dev = resolve_device(device)
    stim = np.asarray(_host(stimfunction_tr)) != 0
    if motion_noise == 'gaussian':
        draw = np.random.normal(0, 1, size=stim.shape)
    elif motion_noise == 'rician':
        draw = stats.rice.rvs(0, 1, size=stim.shape)
    else:
        raise ValueError("motion_noise must be gaussian or rician")
    stim = _upload(stim, dev)
    noise_task = stim + stim * _upload(draw, dev)
    return torch.nan_to_num(_zscore(noise_task, dim=0)).reshape(-1)


def _drift_power_drop_rate(duration, period, tr_duration,
                           retained=0.99):
    """Per-basis geometric weight decay r solving the power-drop
    criterion (1 - r^(2L/F)) / (1 - r^(2L/tr)) = retained, by bisection
    on (0, 1) on the host: the ratio decreases monotonically from 1
    (r->0) to tr/F (r->1), so the root is unique."""
    if period < tr_duration:
        raise ValueError(
            'Drift period (%0.0f s) must be at least the TR duration '
            '(%0.0f s)' % (period, tr_duration))

    def ratio(r):
        return (1 - r ** (2 * duration / period)) / \
            (1 - r ** (2 * duration / tr_duration))

    lo, hi = 1e-12, 1 - 1e-12
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if ratio(mid) > retained:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _generate_noise_temporal_drift(trs, tr_duration, basis="cos_power_drop",
                                   period=150, device="cuda"):
    """Slow scanner drift, a [trs] tensor.

    ``cos_power_drop`` (default) is a DCT ladder with geometrically
    decaying weights chosen so 99% of the power sits below the
    requested period (bases under 1e-8 weight dropped);
    ``discrete_cos`` is the equal-power harmonic ladder; ``sine`` a
    single randomized-phase sinusoid."""
    dev = resolve_device(device)
    timepoints = _upload(np.linspace(0, trs - 1, trs) * tr_duration, dev)
    duration = trs * tr_duration
    if basis == "discrete_cos":
        rad = (timepoints / period) * 2 * np.pi
        basis_funcs = int(np.floor(duration / period))
        if basis_funcs == 0:
            logger.warning('Too few timepoints (%d) to accurately model '
                           'drift', trs)
            basis_funcs = 1
        b = torch.arange(1, basis_funcs + 1, dtype=F64, device=dev)
        phases = _upload(np.random.rand(basis_funcs), dev) * np.pi * 2
        noise_drift = torch.cos(rad[:, None] / b[None, :]
                                + phases[None, :]).mean(dim=1)
    elif basis == "cos_power_drop":
        r = _drift_power_drop_rate(duration, period, tr_duration)
        n_keep = trs if r >= 1.0 - 1e-12 else \
            min(trs, int(np.ceil(1 - 8 * np.log(10) / np.log(r))))
        b = torch.arange(1, n_keep + 1, dtype=F64, device=dev)
        phases = _upload(np.random.rand(n_keep), dev) * np.pi * 2
        ladder = torch.cos(timepoints[:, None] / duration * np.pi *
                           b[None, :] + phases[None, :])
        noise_drift = (ladder * torch.pow(r, b - 1)[None, :]).mean(dim=1)
    elif basis == "sine":
        phase = np.random.rand() * np.pi * 2
        noise_drift = torch.sin(timepoints / period * 2 * np.pi + phase)
    else:
        raise ValueError("Unknown drift basis: {}".format(basis))
    return torch.nan_to_num(_zscore(noise_drift, dim=0))


def _generate_noise_temporal_phys(timepoints, resp_freq=0.2,
                                  heart_freq=1.17, device="cuda"):
    """Respiration + cardiac oscillations, a [T] tensor."""
    dev = resolve_device(device)
    timepoints = _as64(timepoints, dev)
    resp_phase = np.random.rand() * 2 * np.pi
    heart_phase = np.random.rand() * 2 * np.pi
    noise_phys = torch.cos(timepoints * resp_freq * 2 * np.pi + resp_phase) \
        + torch.sin(timepoints * heart_freq * 2 * np.pi + heart_phase)
    return torch.nan_to_num(_zscore(noise_phys, dim=0))


def _generate_noise_temporal_autoregression(timepoints, noise_dict,
                                            dimensions, mask, device="cuda"):
    """Spatially-varying ARMA noise [X, Y, Z, T]: a smooth spatial field
    a TR (one batch), combined over TRs by the AR and MA recursions on
    the whole volume, then z-scored over time."""
    dev = resolve_device(device)
    if mask is not None and not isinstance(mask, _Mask):
        mask = _Mask(_as64(mask, dev))
    auto_reg_rho = list(noise_dict['auto_reg_rho'])
    ma_rho = list(noise_dict['ma_rho'])
    trs = len(timepoints)
    fields = _spatial_fields(trs, dimensions, mask, noise_dict['fwhm'], dev)
    noise = torch.empty_like(fields)
    for tr in range(trs):
        value = fields[tr].clone()
        for p, rho in enumerate(auto_reg_rho):
            if tr - (p + 1) >= 0:
                value += rho * noise[tr - (p + 1)]
        for q, theta in enumerate(ma_rho):
            if tr - (q + 1) >= 0:
                value += theta * fields[tr - (q + 1)]
        noise[tr] = value
    del fields
    noise = torch.nan_to_num(_zscore(noise, dim=0))
    return noise.permute(1, 2, 3, 0).contiguous()


def _generate_noise_temporal(stimfunction_tr, tr_duration, dimensions,
                             template, mask, noise_dict, device="cuda"):
    """Mix the brain-specific temporal noise components into an
    [X, Y, Z, T] volume z-scored over time."""
    dev = resolve_device(device)
    if not isinstance(mask, _Mask):
        mask = _Mask(_as64(mask, dev))
    trs = len(stimfunction_tr)
    timepoints = np.linspace(0, (trs - 1) * tr_duration, trs)
    noise_volume = torch.zeros(tuple(int(d) for d in dimensions[:3])
                               + (trs,), dtype=F64, device=dev)

    if noise_dict['physiological_sigma'] != 0:
        noise = _generate_noise_temporal_phys(timepoints, device=dev)
        volume = _spatial_fields(1, dimensions, mask, noise_dict['fwhm'],
                                 dev)[0]
        noise_volume += volume[..., None] * noise * \
            noise_dict['physiological_sigma']

    if noise_dict['auto_reg_sigma'] != 0:
        noise = _generate_noise_temporal_autoregression(
            timepoints, noise_dict, dimensions, mask, device=dev)
        noise_volume += noise * noise_dict['auto_reg_sigma']
        del noise

    if noise_dict['task_sigma'] != 0 and np.sum(_host(stimfunction_tr)) > 0:
        noise = _generate_noise_temporal_task(stimfunction_tr, device=dev)
        volume = _spatial_fields(1, dimensions, mask, noise_dict['fwhm'],
                                 dev)[0]
        noise_volume += volume[..., None] * noise * noise_dict['task_sigma']

    return torch.nan_to_num(_zscore(noise_volume, dim=3))


def _generate_noise_system(dimensions_tr, spatial_sd, temporal_sd,
                           spatial_noise_type='gaussian',
                           temporal_noise_type='gaussian', device="cuda"):
    """Scanner noise [X, Y, Z, T]: a stable spatial pattern plus
    temporal jitter demeaned per voxel over time (the spatial pattern
    keeps its raw location)."""
    dev = resolve_device(device)
    dimensions_tr = tuple(int(d) for d in dimensions_tr)

    def noise_volume(dimensions, noise_type):
        if noise_type == 'rician':
            draw = stats.rice.rvs(b=0, loc=0, scale=1.527, size=dimensions)
        elif noise_type == 'exponential':
            draw = stats.expon.rvs(0, scale=1, size=dimensions)
        else:
            draw = np.random.normal(0, 1, size=dimensions)
        return _upload(draw, dev)

    spatial = noise_volume(dimensions_tr[:3], spatial_noise_type)
    temporal = noise_volume(dimensions_tr, temporal_noise_type)
    temporal -= temporal.mean(dim=3, keepdim=True)
    temporal *= float(temporal_sd)
    temporal += spatial[..., None] * float(spatial_sd)
    return temporal


# ---------------------------------------------------------------------------
# noise estimation

def _sfnr(volume, mask):
    """The SFNR of ``volume`` [..., T] over ``mask``'s voxels (a
    :class:`_Mask`), a 0-d tensor: each voxel's mean over the standard
    deviation of its residual from a quadratic trend (``np.polyfit``'s
    least-squares fit, :meth:`_Mask.trend_basis`), averaged over the
    finite ratios."""
    n_t = volume.shape[-1]
    brain = volume.reshape(-1, n_t).index_select(0, mask.inside)
    mean_voxels = torch.nanmean(brain, dim=1)
    pinv, scale, seq, seq2 = mask.trend_basis(n_t)
    coef = (pinv @ brain.T) / scale[:, None]
    trend = coef[0][:, None] * seq2 + coef[1][:, None] * seq + \
        coef[2][:, None]
    sfnr = mean_voxels / _nanstd(brain - trend, dim=1)
    finite = torch.isfinite(sfnr)
    return torch.where(finite, sfnr, 0).sum() / finite.sum()


def _calc_sfnr(volume, mask, device="cuda"):
    """Mean over brain voxels of the voxel mean over its quadratically
    detrended standard deviation."""
    dev = resolve_device(device)
    return _sfnr(_as64(volume, dev), _Mask(_as64(mask, dev))).item()


def _snr(volume, mask, dilation=5, reference_tr=None):
    """The SNR of ``volume`` [X, Y, Z, T] over ``mask`` (a
    :class:`_Mask`), a 0-d tensor: the mean over brain voxels of their
    time mean, over the standard deviation of the time means of the
    voxels outside the mask dilated ``dilation`` times."""
    if reference_tr is not None:
        volume = volume[..., reference_tr]
    if volume.dim() == 3:
        flat = volume.reshape(-1)
    else:
        flat = volume.reshape(-1, volume.shape[-1]).mean(dim=1)
    brain = flat.index_select(0, mask.inside)
    nonbrain = flat.index_select(0, mask.outside(dilation))
    return torch.nanmean(brain) / _nanstd(nonbrain)


def _calc_snr(volume, mask, dilation=5, reference_tr=None, device="cuda"):
    """Mean brain voxel over the standard deviation of the non-brain
    voxels (outside the dilated mask)."""
    dev = resolve_device(device)
    if reference_tr is not None and not np.isscalar(reference_tr):
        reference_tr = torch.as_tensor(np.asarray(reference_tr), device=dev)
    return _snr(_as64(volume, dev), _Mask(_as64(mask, dev)), dilation,
                reference_tr).item()


def _arma11_loglik_grid(x, rhos, thetas, device="cuda"):
    """Concentrated exact Gaussian log-likelihood of ARMA(1,1) models,
    for every voxel and every (rho, theta) candidate at once.

    The Kalman filter on the 2-state Harvey form ``alpha_t = [x_t,
    theta*e_t]``, ``T = [[rho, 1], [0, 0]]``, ``R = [1, theta]``, with
    the innovation scale concentrated out: the cross and e-covariances
    freeze at ``p12 = theta``, ``p22 = theta**2`` after one step, and
    the stationary init is ``p11 = (1 + 2*rho*theta + theta**2) / (1 -
    rho**2)``, so only the one-step prediction and its variance evolve:
    elementwise updates of the [B, C] batch, one loop over time.

    x : [B, T] centered voxel time courses
    rhos, thetas : [B, C] candidate AR / MA coefficients per voxel
    Returns ll : [B, C] concentrated log-likelihoods.
    """
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    x = _as64(x, dev)
    rho = _as64(rhos, dev)
    theta = _as64(thetas, dev)
    t = x.shape[1]
    p12 = theta
    p22 = theta * theta
    p11 = (1.0 + 2.0 * rho * theta + p22) / (1.0 - rho * rho)
    a1 = torch.zeros_like(rho)
    sum_log_f = torch.zeros_like(rho)
    sum_sq = torch.zeros_like(rho)
    for step in range(t):
        v = x[:, step, None] - a1
        f = p11.clamp_min(1e-12)
        sum_log_f += torch.log(f)
        sum_sq += v * v / f
        g = rho * p11 + p12
        a1 = rho * a1 + g / f * v
        p11 = rho * rho * p11 + 2.0 * rho * p12 + p22 + 1.0 - g * g / f
    return -0.5 * (t * torch.log(sum_sq.clamp_min(1e-300) / t)
                   + sum_log_f + t * (1.0 + math.log(2.0 * np.pi)))


def _arma11_mle(x, n_pts=13, n_zooms=3, half=0.94, clip=0.97,
                device="cuda"):
    """Exact ARMA(1,1) Gaussian MLEs for every row of the centered batch
    ``x`` [B, T]: a zooming grid search over (rho, theta) on the Kalman
    likelihood, a coarse sweep of the invertible region, then
    refinements around each row's best cell (the first best, as
    ``np.argmax`` takes it).  Returns (rho [B], theta [B], ll_best
    [B])."""
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    x = _as64(x, dev)
    n_sampled = x.shape[0]
    centers_r = torch.zeros(n_sampled, dtype=F64, device=dev)
    centers_t = torch.zeros(n_sampled, dtype=F64, device=dev)
    ll_best = torch.full((n_sampled,), -np.inf, dtype=F64, device=dev)
    rows = torch.arange(n_sampled, device=dev)
    for _zoom in range(n_zooms):
        offs = np.linspace(-half, half, n_pts)
        rr, tt = np.meshgrid(offs, offs, indexing='ij')
        cand_r = (centers_r[:, None] + _upload(rr.ravel(), dev)[None]) \
            .clamp(-clip, clip)
        cand_t = (centers_t[:, None] + _upload(tt.ravel(), dev)[None]) \
            .clamp(-clip, clip)
        ll = _arma11_loglik_grid(x, cand_r, cand_t)
        best = torch.argmax(ll, dim=1)
        centers_r = cand_r[rows, best]
        centers_t = cand_t[rows, best]
        ll_best = ll[rows, best]
        half /= (n_pts - 1) / 2.0
    return centers_r, centers_t, ll_best


# chi2(2).ppf(0.95)/2 nats: the 95% likelihood-ratio bar for the two
# extra ARMA(1,1) parameters over the white-noise model.
_ARMA_LRT_GATE = 3.0


def _calc_ARMA_noise(volume, mask, auto_reg_order=1, ma_order=1,
                     sample_num=100, device="cuda"):
    """Per-voxel ARMA(1,1) maximum-likelihood estimates averaged over
    sampled brain voxels (one ``np.random.permutation`` draw).

    ARMA(1,1) is unidentified on white data (the ``rho = -theta`` ridge
    is the white-noise model), so a voxel whose MLE improves on (0, 0)
    by less than ``_ARMA_LRT_GATE`` nats reports (0, 0)."""
    dev = resolve_device(device)
    volume = _as64(volume, dev)
    if volume.dim() > 1:
        brain_timecourse = volume[_as64(mask, dev) > 0]
    else:
        brain_timecourse = volume.reshape(1, volume.shape[0])
    n_vox = brain_timecourse.shape[0]
    idxs = np.random.permutation(n_vox)[:min(sample_num, n_vox)]
    x = brain_timecourse[torch.from_numpy(idxs).to(dev)]
    x = x - x.mean(dim=1, keepdim=True)
    sd = x.std(dim=1, correction=0)
    keep = sd > 0
    x = x[keep] / sd[keep][:, None]
    if x.shape[0] == 0 or x.shape[1] < 3:
        return [0.0] * auto_reg_order, [0.0] * ma_order

    centers_r, centers_t, ll_best = _arma11_mle(x)
    zeros = torch.zeros((x.shape[0], 1), dtype=F64, device=dev)
    ll_white = _arma11_loglik_grid(x, zeros, zeros)[:, 0]
    undetectable = ll_best - ll_white < _ARMA_LRT_GATE
    centers_r = centers_r.masked_fill(undetectable, 0.0)
    centers_t = centers_t.masked_fill(undetectable, 0.0)
    ar = float(torch.nanmean(centers_r))
    ma = float(torch.nanmean(centers_t))
    return [ar] * auto_reg_order, [ma] * ma_order


def _fwhm_batch(volumes, mask, voxel_size):
    """The gradient-variance (AFNI-style) FWHM of each volume of a batch
    ``[n, X, Y, Z]`` within ``mask`` (a :class:`_Mask`), an [n] tensor:
    for each axis ``r = 1 - var(diffs) / (2 var(values))`` over the
    pairs of brain voxels, ``sqrt(-2 log 2 / log r)`` times the voxel
    size, averaged over the axes where both variances are positive and
    ``r`` is; the mean voxel size where no axis is."""
    n = volumes.shape[0]
    v = volumes * mask.mask
    var_all = v.reshape(n, -1).index_select(1, mask.inside) \
        .var(dim=1, correction=0)
    total = torch.zeros(n, dtype=F64, device=v.device)
    count = torch.zeros(n, dtype=F64, device=v.device)
    for axis, vs in enumerate(voxel_size):
        length = mask.mask.shape[axis]
        pairs = torch.minimum(mask.mask.narrow(axis, 1, length - 1),
                              mask.mask.narrow(axis, 0, length - 1)) > 0
        idx = torch.nonzero(pairs.reshape(-1)).squeeze(1)
        diffs = torch.diff(v, dim=axis + 1).reshape(n, -1) \
            .index_select(1, idx)
        var_diff = diffs.var(dim=1, correction=0)
        r = 1 - var_diff / (2 * var_all)
        used = ~(var_diff <= 0) & ~(var_all <= 0) & ~(r <= 0)
        fwhm = torch.sqrt(-2 * math.log(2) / torch.log(r)) * vs
        total += torch.where(used, fwhm, 0)
        count += used
    return torch.where(count > 0, total / count,
                       float(np.mean(voxel_size)))


def _calc_fwhm(volume, mask, voxel_size=[1.0, 1.0, 1.0], device="cuda"):
    """Estimate the smoothness of one volume from its gradient variance
    (AFNI-style FWHM estimator)."""
    dev = resolve_device(device)
    return float(_fwhm_batch(_as64(volume, dev)[None],
                             _Mask(_as64(mask, dev)), voxel_size)[0])


def calc_noise(volume, mask, template, noise_dict=None, device="cuda"):
    """Estimate the noise parameters of a dataset [X, Y, Z, T] on
    ``device``: the ARMA coefficients, SFNR, FWHM (over up to 100 TRs
    drawn with ``np.random.choice``, one batch) and SNR; returns the
    noise dict (host floats)."""
    dev = resolve_device(device)
    template = _as64(template, dev)
    if template.max().item() > 1.1:
        raise ValueError('Template out of range')
    if mask is None:
        raise ValueError('Mask not supplied')
    if noise_dict is None:
        noise_dict = {'voxel_size': [1.0, 1.0, 1.0]}
    elif 'voxel_size' not in noise_dict:
        noise_dict['voxel_size'] = [1.0, 1.0, 1.0]
    volume = _as64(volume, dev)
    brain = _Mask(_as64(mask, dev))
    means = volume.mean(dim=3)
    noise_dict['max_activity'] = \
        means.masked_fill(torch.isnan(means), -np.inf).max().item()
    noise_dict['auto_reg_rho'], noise_dict['ma_rho'] = \
        _calc_ARMA_noise(volume, brain.mask, device=dev)
    noise_dict['auto_reg_sigma'] = 1
    noise_dict['physiological_sigma'] = 0
    noise_dict['task_sigma'] = 0
    noise_dict['drift_sigma'] = 0
    noise_dict['sfnr'] = _sfnr(volume, brain).item()
    if volume.shape[3] > 100:
        trs = np.random.choice(volume.shape[3], size=100, replace=False)
    else:
        trs = np.arange(volume.shape[3])
    vols = volume[..., torch.from_numpy(trs).to(dev)].permute(3, 0, 1, 2)
    noise_dict['fwhm'] = float(
        _fwhm_batch(vols, brain, noise_dict['voxel_size']).mean())
    noise_dict['snr'] = _snr(volume, brain).item()
    return noise_dict


# ---------------------------------------------------------------------------
# noise generation

def _combine(base, drift, noise_system, noise_temporal, temporal_sd):
    """``base + drift + system + temporal * temporal_sd``, floored at
    0: the template's signal [X, Y, Z] and the drift [T] broadcast over
    the [X, Y, Z, T] noise."""
    noise = base[..., None] + drift
    noise += noise_system
    noise += noise_temporal * float(temporal_sd)
    return noise.clamp_min_(0)


def _fit_spatial(noise, noise_temporal, drift, mask, base, mean_signal,
                 spatial_sd, temporal_sd, noise_dict, fit_thresh, fit_delta,
                 iterations, dev):
    """Rescale the system's spatial noise until the SNR is within
    ``fit_thresh`` of the target, at most ``iterations`` times; each
    iteration reads the SNR (one scalar) and draws the system noise
    again."""
    dim_tr = tuple(noise.shape)
    target_snr = noise_dict['snr']
    spat_sd_orig = float(spatial_sd)
    for iteration in range(iterations):
        new_snr = _snr(noise, mask).item()
        if abs(new_snr - target_snr) / target_snr < fit_thresh:
            logger.info('Terminated SNR fit after %d iterations.',
                        iteration)
            break
        spat_sd_new = mean_signal / new_snr
        spatial_sd -= (spat_sd_new - spat_sd_orig) * fit_delta
        if spatial_sd < 0 or np.isnan(spatial_sd):
            spatial_sd = 10e-3
        noise_system = _generate_noise_system(
            dimensions_tr=dim_tr, spatial_sd=spatial_sd,
            temporal_sd=temporal_sd, device=dev)
        del noise
        noise = _combine(base, drift, noise_system, noise_temporal,
                         temporal_sd)
        del noise_system
    return noise, spatial_sd


def _fit_temporal(noise, mask, stimfunction_tr, tr_duration, base,
                  mean_signal, spatial_sd, temporal_proportion, temporal_sd,
                  drift, noise_dict, fit_thresh, fit_delta, iterations, dev):
    """Rescale the brain's temporal noise until the SFNR is within
    ``fit_thresh`` of the target, at most ``iterations`` times; each
    iteration reads the SFNR (one scalar) and draws the temporal and
    system noise again."""
    dim_tr = tuple(noise.shape)
    target_sfnr = noise_dict['sfnr']
    temp_sd_orig = float(temporal_sd)
    for iteration in range(iterations):
        new_sfnr = _sfnr(noise, mask).item()
        if abs(new_sfnr - target_sfnr) / target_sfnr < fit_thresh:
            logger.info('Terminated SFNR fit after %d iterations.',
                        iteration)
            break
        temp_sd_new = mean_signal / new_sfnr
        temporal_sd -= (temp_sd_new - temp_sd_orig) * fit_delta
        if temporal_sd < 0 or np.isnan(temporal_sd):
            temporal_sd = 10e-3
        temporal_sd_system = np.sqrt(temporal_sd ** 2
                                     * temporal_proportion)
        del noise
        noise_temporal = _generate_noise_temporal(
            stimfunction_tr, tr_duration, dim_tr, None, mask, noise_dict,
            device=dev)
        noise_system = _generate_noise_system(
            dimensions_tr=dim_tr, spatial_sd=spatial_sd,
            temporal_sd=temporal_sd_system, device=dev)
        noise = _combine(base, drift, noise_system, noise_temporal,
                         temporal_sd)
        del noise_system, noise_temporal
    return noise


def generate_noise(dimensions, stimfunction_tr, tr_duration, template,
                   mask=None, noise_dict=None, temporal_proportion=0.5,
                   iterations=None, fit_thresh=0.05, fit_delta=0.5,
                   device="cuda"):
    """Generate realistic fMRI noise [X, Y, Z, T] matched to the target
    ``noise_dict``, on ``device``.

    The brain's temporal noise (ARMA, physiological, task-locked) and
    the system noise are drawn on the host and combined on the card
    with the template's signal and the drift; with ``matched`` (the
    default) the system's spatial noise is then refitted to the SNR and
    the temporal noise to the SFNR, each loop at most 20 iterations
    (``iterations``), each iteration one scalar read."""
    dev = resolve_device(device)
    if noise_dict is None:
        noise_dict = {}
    noise_dict = _noise_dict_update(dict(noise_dict))

    if iterations is None:
        iterations = [20, 20] if noise_dict['matched'] == 1 else [0, 0]

    if abs(noise_dict['auto_reg_rho'][0]) - \
            abs(noise_dict['ma_rho'][0]) < 0.1:
        logger.warning('ARMA coefs are close, may have trouble fitting')

    dimensions = _host(dimensions)
    dimensions_tr = (int(dimensions[0]), int(dimensions[1]),
                     int(dimensions[2]), len(stimfunction_tr))
    mask = _Mask(torch.ones(dimensions_tr[:3], dtype=F64, device=dev)
                 if mask is None else _as64(mask, dev))
    # the SNR's non-brain voxels and the SFNR's basis, before the loops
    mask.outside(5)
    mask.trend_basis(dimensions_tr[3])

    base = _as64(template, dev).reshape(dimensions_tr[:3]) * \
        noise_dict['max_activity']
    mean_signal = base.reshape(-1).index_select(0, mask.inside).mean().item()

    noise_temporal = _generate_noise_temporal(
        stimfunction_tr, tr_duration, dimensions_tr, None, mask,
        noise_dict, device=dev)

    if noise_dict['drift_sigma'] != 0:
        drift = _generate_noise_temporal_drift(
            len(stimfunction_tr), tr_duration, device=dev) * \
            noise_dict['drift_sigma']
    else:
        drift = torch.zeros(dimensions_tr[3], dtype=F64, device=dev)

    temporal_sd = mean_signal / noise_dict['sfnr']
    temporal_sd_system = np.sqrt(temporal_sd ** 2 * temporal_proportion)
    spat_sd = mean_signal / noise_dict['snr']
    spatial_sd = np.sqrt(spat_sd ** 2 * (1 - temporal_proportion))

    noise_system = _generate_noise_system(
        dimensions_tr=dimensions_tr, spatial_sd=spatial_sd,
        temporal_sd=temporal_sd_system, device=dev)
    noise = _combine(base, drift, noise_system, noise_temporal, temporal_sd)
    del noise_system

    noise, spatial_sd = _fit_spatial(
        noise, noise_temporal, drift, mask, base, mean_signal, spatial_sd,
        temporal_sd_system, noise_dict, fit_thresh, fit_delta,
        iterations[0], dev)
    del noise_temporal
    return _fit_temporal(
        noise, mask, stimfunction_tr, tr_duration, base, mean_signal,
        spatial_sd, temporal_proportion, temporal_sd, drift, noise_dict,
        fit_thresh, fit_delta, iterations[1], dev)


_SIGNAL_CHANGE_METHODS = ('SFNR', 'CNR_Amp/Noise-SD',
                          'CNR_Amp2/Noise-Var_dB', 'CNR_Signal-SD/Noise-SD',
                          'CNR_Signal-Var/Noise-Var_dB', 'PSC')


def compute_signal_change(signal_function, noise_function, noise_dict,
                          magnitude, method='PSC', device="cuda"):
    """Rescale a [TR, voxel] signal function to a desired effect-size
    metric against the noise of each voxel, all voxels at once on
    ``device``."""
    if type(magnitude) is not list:
        raise ValueError('"magnitude" should be a list of floats')
    if method not in _SIGNAL_CHANGE_METHODS:
        raise ValueError("Unknown method: {}".format(method))
    dev = resolve_device(device)
    signal_function = _as64(signal_function, dev)
    noise_function = _as64(noise_function, dev)
    if len(magnitude) == 1:
        magnitude = magnitude * signal_function.shape[1]
    if signal_function.shape != noise_function.shape:
        raise ValueError('noise_function is not the same size as '
                         'signal_function')

    overall_max = signal_function.abs().max()
    sig = signal_function / overall_max
    mag = torch.tensor(magnitude, dtype=F64, device=dev)
    max_amp = sig.abs().max(dim=0).values
    noise_std = noise_function.std(dim=0, correction=0)
    if method == 'SFNR':
        new_sig = sig * ((noise_function.mean(dim=0) / noise_dict['sfnr'])
                         * mag)
    elif method == 'CNR_Amp/Noise-SD':
        new_sig = sig * (mag * noise_std)
    elif method == 'CNR_Amp2/Noise-Var_dB':
        new_sig = sig * ((10 ** (mag / 20)) * noise_std / max_amp)
    elif method == 'CNR_Signal-SD/Noise-SD':
        new_sig = sig * ((mag / max_amp) * noise_std
                         / sig.std(dim=0, correction=0))
    elif method == 'CNR_Signal-Var/Noise-Var_dB':
        new_sig = sig * ((10 ** (mag / 20)) * noise_std
                         / (max_amp * sig.std(dim=0, correction=0)))
    else:
        new_sig = sig * ((noise_function.mean(dim=0) / 100) * mag)
    # no events: nothing to scale
    return torch.where(overall_max == 0, 0, new_sig)


# ---------------------------------------------------------------------------
# 1-D receptive fields

def generate_1d_gaussian_rfs(n_voxels, feature_resolution, feature_range,
                             rf_size=15, random_tuning=True, rf_noise=0.,
                             device="cuda"):
    """Gaussian voxel receptive fields along one feature dimension:
    ``(rfs [n_voxels, feature_resolution], tuning [n_voxels])`` on
    ``device`` (each field the window rolled to its voxel's tuning, one
    gather)."""
    dev = resolve_device(device)
    range_start, range_stop = feature_range
    if random_tuning:
        voxel_tuning = np.floor(np.random.rand(n_voxels) * range_stop
                                + range_start).astype(int)
    else:
        voxel_tuning = np.linspace(range_start, range_stop,
                                   n_voxels + 1)[:-1]
        voxel_tuning = np.floor(voxel_tuning).astype(int)
    gaussian = _upload(signal.windows.gaussian(feature_resolution, rf_size),
                       dev)
    tuning = torch.from_numpy(voxel_tuning).to(dev)
    shift = tuning - (feature_resolution // 2 - 1)
    cols = torch.arange(feature_resolution, device=dev)
    voxel_rfs = gaussian[(cols[None, :] - shift[:, None])
                         % feature_resolution]
    voxel_rfs += _upload(np.random.rand(n_voxels, feature_resolution),
                         dev) * rf_noise
    voxel_rfs = voxel_rfs / voxel_rfs.max(dim=1).values[:, None]
    return voxel_rfs, tuning


def generate_1d_rf_responses(rfs, trial_list, feature_resolution,
                             feature_range, trial_noise=0.25,
                             device="cuda"):
    """Trial-wise responses [voxels, trials] of the given receptive
    fields: each trial the field at the stimulus closest to its
    feature, plus uniform noise scaled to the largest response."""
    dev = resolve_device(device)
    range_start, range_stop = feature_range
    stim_axis = np.linspace(range_start, range_stop, feature_resolution)
    trial_list = np.asarray(_host(trial_list), dtype=float)
    if range_start > 0:
        trial_list = trial_list + range_start
    elif range_start < 0:
        trial_list = trial_list - range_start
    indices = [int(np.argmin(abs(stim_axis - x))) for x in trial_list]
    trial_data = _as64(rfs, dev)[:, torch.tensor(indices, device=dev)]
    trial_data = trial_data + \
        _upload(np.random.rand(trial_data.shape[0], trial_list.size), dev) \
        * (trial_noise * trial_data.max())
    return trial_data
