"""Inverted encoding models (IEM) on a CUDA device.

PyTorch counterpart of ``brainiak_tpu/reconstruct/iem.py``: reconstruct
a 1-D (circular/half-circular) or 2-D (spatial) stimulus feature from
voxel patterns via idealized basis-function channels.  B = W·C; W
estimated by least squares on training data, channel responses
recovered by pseudo-inverting W on test data.  The pseudo-inverses,
their products and the condition checks of the data and the weights
(``np.linalg.cond`` on the host in the JAX package) run on the device
(float32 through ``fit``; the data's condition in its own dtype), with
the JAX package's cutoff: singular values at or below ``10 · max(m,
n) · eps · s_max`` are dropped (``torch.linalg.pinv``'s default
``rtol`` is ten times smaller).  The channel and stimulus-mask code
is the JAX package's host NumPy, copied; sklearn's
``euclidean_distances`` and ``cosine_distances`` are written out with
sklearn's conventions (:func:`_euclidean_distances`,
:func:`_cosine_distances`).
"""

import logging
import warnings

import numpy as np
import scipy.stats
import torch

from ..device import resolve_device
from ..funcalign.srm import NotFittedError
from ..utils.utils import circ_dist

logger = logging.getLogger(__name__)

__all__ = ["InvertedEncoding1D", "InvertedEncoding2D"]

MAX_CONDITION_CHECK = 9000


def _pinv(a):
    """``a``'s pseudo-inverse with ``jnp.linalg.pinv``'s cutoff."""
    return torch.linalg.pinv(
        a, rtol=10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps)


def _cond(a):
    """``np.linalg.cond(a)``, s_max / s_min, on ``a``'s device in its
    dtype (the JAX package takes it on the host: at 360 x 2,000 its
    SVD there takes seconds)."""
    s = torch.linalg.svdvals(a)
    return float(s[0] / s[-1])


def _fit_weights(x, C, dtype):
    """W = Xᵀ pinv(Cᵀ) on ``x``'s device in ``dtype``."""
    c = torch.as_tensor(np.asarray(C), dtype=dtype, device=x.device)
    return x.to(dtype).T @ _pinv(c.T)


def _channel_responses(W, X, device):
    """pinv(W) Xᵀ on ``device`` in W's dtype (NumPy out)."""
    if W is None:
        raise NotFittedError("The model fit has not been run yet.")
    w = torch.tensor(W, device=device)
    x = torch.as_tensor(np.asarray(X), dtype=w.dtype, device=device)
    return (_pinv(w) @ x.T).cpu().numpy()


def _row_norms_squared(a):
    return np.einsum("ij,ij->i", a, a)


def _euclidean_distances(X, Y):
    """sklearn's ``euclidean_distances(X, Y)`` for float64 inputs:
    ``-2 X Yᵀ + |x|² + |y|²``, clamped at 0, then the square root."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    d = -2 * (X @ Y.T)
    d += _row_norms_squared(X)[:, None]
    d += _row_norms_squared(Y)[None, :]
    np.maximum(d, 0, out=d)
    return np.sqrt(d, out=d)


def _normalize_rows(a):
    norms = np.sqrt(_row_norms_squared(a))
    norms[norms == 0.0] = 1.0
    return a / norms[:, None]


def _cosine_distances(X, Y):
    """sklearn's ``cosine_distances(X, Y)``: 1 - the cosine similarity
    of the rows (a zero row's norm taken as 1), clipped to [0, 2]."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    s = _normalize_rows(X) @ _normalize_rows(Y).T
    s *= -1
    s += 1
    return np.clip(s, 0.0, 2.0)


class InvertedEncoding1D:
    """1-D inverted encoding model over a circular or half-circular feature
    domain with half-wave-rectified exponentiated sinusoid channels
    (reference iem.py:67-462).  ``device`` is ``"cuda"`` (default;
    raises without a card) or ``"cpu"``; ``fit`` runs in float32 there,
    and the prediction in ``W_``'s dtype."""

    def __init__(self, n_channels=6, channel_exp=5,
                 stimulus_mode='halfcircular', range_start=0.,
                 range_stop=180., channel_density=180,
                 stimulus_resolution=None, device="cuda"):
        self.n_channels = n_channels
        self.channel_exp = channel_exp
        self.stimulus_mode = stimulus_mode
        self.range_start = range_start
        self.range_stop = range_stop
        self.channel_density = channel_density
        self.channel_domain = np.linspace(range_start, range_stop - 1,
                                          channel_density)
        self.stim_res = (channel_density if stimulus_resolution is None
                         else stimulus_resolution)
        self.device = device
        self._check_params()

    def _check_params(self):
        if self.range_start >= self.range_stop:
            raise ValueError("range_start {} must be less than "
                             "{} range_stop.".format(self.range_start,
                                                     self.range_stop))
        span = self.range_stop - self.range_start
        if self.stimulus_mode == 'halfcircular' and span != 180.:
            raise ValueError("For half-circular feature spaces, the range "
                             "must be 180 degrees, not {}".format(span))
        if self.stimulus_mode == 'circular' and span != 360.:
            raise ValueError("For circular feature spaces, the range must "
                             "be 360 degrees, not {}".format(span))
        if self.n_channels < 2:
            raise ValueError("Insufficient number of channels.")
        if self.stimulus_mode not in ('circular', 'halfcircular'):
            raise ValueError("Stimulus mode must be one of these: "
                             "'circular', 'halfcircular'")

    def _define_channels(self):
        """Exponentiated-cosine channels over the domain
        (reference iem.py:340-365)."""
        channel_centers = np.linspace(np.deg2rad(self.range_start),
                                      np.deg2rad(self.range_stop),
                                      self.n_channels + 1)[:-1]
        if self.stimulus_mode == 'circular':
            domain = self.channel_domain * 0.5
            centers = channel_centers * 0.5
        else:
            domain = self.channel_domain
            centers = channel_centers
        channels = np.abs(np.asarray(
            [np.cos(np.deg2rad(domain) - cx) ** self.channel_exp
             for cx in centers]))
        return channels, channel_centers

    def _define_trial_activations(self, stimuli):
        """Predicted channel responses per trial (reference
        iem.py:367-404)."""
        stim_axis = np.linspace(self.range_start, self.range_stop - 1,
                                self.stim_res)
        stimuli = np.asarray(stimuli, dtype=float)
        if self.range_start > 0:
            stimuli = stimuli + self.range_start
        elif self.range_start < 0:
            stimuli = stimuli - self.range_start
        one_hot = np.eye(self.stim_res)
        indices = [np.argmin(abs(stim_axis - x)) for x in stimuli]
        stimulus_mask = one_hot[indices, :]
        if self.channel_density != self.stim_res:
            if self.channel_density % self.stim_res == 0:
                stimulus_mask = np.repeat(
                    stimulus_mask, self.channel_density // self.stim_res,
                    axis=1)
            else:
                raise NotImplementedError(
                    "Stimulus resolution must evenly divide the channel "
                    "density")
        C = stimulus_mask @ self.channels_.T
        if np.linalg.matrix_rank(C) < self.n_channels:
            warnings.warn("Stimulus matrix is {}, not full rank. May cause "
                          "issues with stimulus prediction/reconstruction."
                          .format(np.linalg.matrix_rank(C)),
                          RuntimeWarning)
        return C

    def fit(self, X, y):
        """Estimate W from training betas X [trials, voxels] and features y
        (reference iem.py:212-253), in float32 on the device."""
        return self._fit(X, y, torch.float32)

    def _fit(self, X, y, dtype):
        dev = resolve_device(self.device)
        X = np.asarray(X)
        x = torch.as_tensor(X, device=dev)
        if _cond(x) > MAX_CONDITION_CHECK:
            raise ValueError("Data matrix is nearly singular.")
        if X.shape[0] < self.n_channels:
            raise ValueError("Fewer observations (trials) than channels. "
                             "Cannot compute pseudoinverse.")
        if X.ndim != 2:
            raise ValueError("Data matrix has too many or too few "
                             "dimensions.")
        if X.shape[0] != np.shape(y)[0]:
            raise ValueError("Mismatched data samples and label samples")

        self.channels_, self.channel_centers_ = self._define_channels()
        C = self._define_trial_activations(y)
        w = _fit_weights(x, C, dtype)
        self.W_ = w.cpu().numpy()
        if _cond(w) > MAX_CONDITION_CHECK:
            raise ValueError("Weight matrix is nearly singular.")
        return self

    def _predict_channel_responses(self, X):
        return _channel_responses(getattr(self, "W_", None), X,
                                  resolve_device(self.device))

    def _predict_feature_responses(self, X):
        responses = self._predict_channel_responses(X)
        return self.channels_.T @ responses

    def _predict_features(self, X):
        pred_response = self._predict_feature_responses(X)
        return self.channel_domain[np.argmax(pred_response, 0)]

    def predict(self, X):
        """Predicted feature per observation (reference iem.py:255-276)."""
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError("Data matrix has too many or too few "
                             "dimensions.")
        return self._predict_features(X)

    def score(self, X, y):
        """Circular R² of predictions (reference iem.py:278-309)."""
        pred_features = self.predict(X)
        y = np.asarray(y, dtype=float)
        if self.stimulus_mode == 'halfcircular':
            pred_features = pred_features * 2
            y = y * 2
        ssres = (circ_dist(np.deg2rad(y),
                           np.deg2rad(pred_features)) ** 2).sum()
        sstot = (circ_dist(np.deg2rad(y),
                           np.ones(y.size) * scipy.stats.circmean(
                               np.deg2rad(y))) ** 2).sum()
        return 1 - ssres / sstot

    def get_params(self, deep=True):
        return {"n_channels": self.n_channels,
                "channel_exp": self.channel_exp,
                "stimulus_mode": self.stimulus_mode,
                "range_start": self.range_start,
                "range_stop": self.range_stop,
                "channel_domain": self.channel_domain,
                "stim_res": self.stim_res,
                "device": self.device}

    def set_params(self, **parameters):
        for parameter, value in parameters.items():
            setattr(self, parameter, value)
        self.channel_domain = np.linspace(
            self.range_start, self.range_stop - 1, self.channel_density)
        self._check_params()
        return self


class InvertedEncoding2D:
    """2-D spatial inverted encoding model with exponentiated-cosine
    channels on square or triangular grids (reference iem.py:464-1050).
    ``device`` as :class:`InvertedEncoding1D`'s."""

    def __init__(self, stim_xlim, stim_ylim, stimulus_resolution,
                 stim_radius=None, chan_xlim=None, chan_ylim=None,
                 channels=None, channel_exp=7, device="cuda"):
        if not (hasattr(stim_xlim, "__len__") and len(stim_xlim) == 2 and
                hasattr(stim_ylim, "__len__") and len(stim_ylim) == 2):
            raise ValueError("Stimulus limits should be a sequence, "
                             "2 values")
        if np.isscalar(stimulus_resolution):
            stimulus_resolution = [stimulus_resolution,
                                   stimulus_resolution]
        self.stim_fov = [list(stim_xlim), list(stim_ylim)]
        self.stim_pixels = [
            np.linspace(stim_xlim[0], stim_xlim[1],
                        int(stimulus_resolution[0])),
            np.linspace(stim_ylim[0], stim_ylim[1],
                        int(stimulus_resolution[1]))]
        self.xp, self.yp = np.meshgrid(self.stim_pixels[0],
                                       self.stim_pixels[1])
        self.stim_radius_px = stim_radius
        self.channels = channels
        self.n_channels = None if channels is None else channels.shape[0]
        self.channel_limits = [
            list(stim_xlim) if chan_xlim is None else list(chan_xlim),
            list(stim_ylim) if chan_ylim is None else list(chan_ylim)]
        self.channel_exp = channel_exp
        self.device = device
        self._check_params()

    def _check_params(self):
        if self.stim_fov[0][0] >= self.stim_fov[0][1] or \
                self.stim_fov[1][0] >= self.stim_fov[1][1]:
            raise ValueError("Stimulus x or y limits should be ascending "
                             "values")
        if self.channels is not None and \
                self.channels.shape[1] != self.xp.size:
            raise ValueError(
                "Defined {} channels over {} pixels, but there are {} "
                "pixels in the stimulus space".format(
                    self.channels.shape[0], self.channels.shape[1],
                    self.xp.size))

    # -- basis construction ----------------------------------------------
    def _make_2d_cosine(self, x, y, x_center, y_center, s):
        """Exponentiated 2-D cosine bumps of radius s
        (reference iem.py:989-1020)."""
        x = np.asarray(x).reshape(-1)
        y = np.asarray(y).reshape(-1)
        x_center = np.asarray(x_center).reshape(-1)
        y_center = np.asarray(y_center).reshape(-1)
        r = np.sqrt((x[None, :] - x_center[:, None]) ** 2 +
                    (y[None, :] - y_center[:, None]) ** 2)
        zp = (0.5 * (1 + np.cos(np.minimum(r / s, 1.0) * np.pi))) \
            ** self.channel_exp
        return zp * (r <= s)

    def _2d_cosine_sz_to_fwhm(self, size_constant):
        return 2 * size_constant * np.arccos(
            (0.5 ** (1 / self.channel_exp) - 0.5) / 0.5) / np.pi

    def _2d_cosine_fwhm_to_sz(self, fwhm):
        return (0.5 * np.pi * fwhm) / np.arccos(
            (0.5 ** (1 / self.channel_exp) - 0.5) / 0.5)

    def define_basis_functions_sqgrid(self, nchannels, channel_size=None):
        """Square grid of channels (reference iem.py:1045-1090)."""
        if not isinstance(nchannels, list):
            nchannels = [nchannels, nchannels]
        cxs = np.linspace(self.channel_limits[0][0],
                          self.channel_limits[0][1], nchannels[0])
        cys = np.linspace(self.channel_limits[1][0],
                          self.channel_limits[1][1], nchannels[1])
        cx, cy = np.meshgrid(cxs, cys)
        cx = cx.reshape(-1)
        cy = cy.reshape(-1)
        if channel_size is None:
            channel_size = 1.2 * (cxs[1] - cxs[0])
        cos_width = self._2d_cosine_fwhm_to_sz(channel_size)
        self.channels = self._make_2d_cosine(self.xp, self.yp, cx, cy,
                                             cos_width)
        self.n_channels = self.channels.shape[0]
        return self.channels, np.column_stack([cx, cy])

    def define_basis_functions_trigrid(self, grid_radius,
                                       channel_size=None):
        """Triangular (hexagonal) grid of channels
        (reference iem.py:1092-1140)."""
        x_dist = np.diff(self.channel_limits[0]).item() / (grid_radius * 2)
        y_dist = x_dist * np.sqrt(3) * 0.5
        pts = []
        xbase = np.arange(self.channel_limits[0][0],
                          self.channel_limits[0][1], x_dist)
        for yi, y in enumerate(np.arange(self.channel_limits[1][0],
                                         self.channel_limits[1][1],
                                         y_dist)):
            xx = xbase.copy() if yi % 2 == 0 else xbase + x_dist / 2
            pts.append(np.column_stack([xx, np.full(xx.size, y)]))
        trigrid = np.vstack(pts)
        if channel_size is None:
            channel_size = 1.1 * x_dist
        cos_width = self._2d_cosine_fwhm_to_sz(channel_size)
        self.channels = self._make_2d_cosine(
            self.xp, self.yp, trigrid[:, 0], trigrid[:, 1], cos_width)
        self.n_channels = self.channels.shape[0]
        return self.channels, trigrid

    # -- design ----------------------------------------------------------
    def _define_trial_activations(self, stim_centers, stim_radius=None):
        """Channel responses of circular stimuli (reference
        iem.py:1127-1172)."""
        stim_centers = np.asarray(stim_centers)
        nstim = stim_centers.shape[0]
        if stim_radius is not None:
            self.stim_radius_px = stim_radius
        if self.stim_radius_px is None:
            raise ValueError("No defined stimulus radius. Please set.")
        radii = np.ones(nstim) * np.asarray(self.stim_radius_px)
        masks = np.zeros((nstim, self.xp.size))
        flat_x = self.xp.reshape(-1)
        flat_y = self.yp.reshape(-1)
        for i in range(nstim):
            r = np.sqrt((flat_x - stim_centers[i, 0]) ** 2 +
                        (flat_y - stim_centers[i, 1]) ** 2)
            masks[i] = (r <= radii[i]) * 1.0
        return masks @ self.channels.T

    # -- estimation ------------------------------------------------------
    def fit(self, X, y, C=None):
        """Estimate W from betas X [trials, voxels] and stimulus centers y
        [trials, 2] (or an explicit design C) (reference iem.py:667-710),
        in float32 on the device."""
        return self._fit(X, y, torch.float32, C)

    def _fit(self, X, y, dtype, C=None):
        dev = resolve_device(self.device)
        self._check_params()  # channels may have changed (ref iem.py:810)
        X = np.asarray(X)
        x = torch.as_tensor(X, device=dev)
        if _cond(x) > MAX_CONDITION_CHECK:
            raise ValueError("Data matrix is nearly singular.")
        if self.channels is None:
            raise ValueError("Must define channels (set of basis "
                             "functions).")
        if X.shape[0] < self.n_channels:
            raise ValueError("Fewer observations (trials) than channels. "
                             "Cannot compute pseudoinverse.")
        if C is None:
            C = self._define_trial_activations(y)
        if X.shape[0] != C.shape[0]:
            raise ValueError("Mismatched data samples and label samples")
        w = _fit_weights(x, C, dtype)
        self.W_ = w.cpu().numpy()
        if _cond(w) > MAX_CONDITION_CHECK:
            raise ValueError("Weight matrix is nearly singular.")
        return self

    def _predict_channel_responses(self, X):
        return _channel_responses(getattr(self, "W_", None), X,
                                  resolve_device(self.device))

    def predict_feature_responses(self, X):
        """Reconstruction in the pixel domain [n_pixels, observations]
        (reference iem.py:1189-1206)."""
        return self.channels.T @ self._predict_channel_responses(X)

    def _predict_features(self, X):
        pred_response = self.predict_feature_responses(X)
        idx = np.argmax(pred_response, axis=0)
        return np.column_stack([self.xp.reshape(-1)[idx],
                                self.yp.reshape(-1)[idx]])

    def predict(self, X):
        """Predicted (x, y) per observation (reference iem.py:712-732)."""
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError("Data matrix has too many or too few "
                             "dimensions.")
        return self._predict_features(X)

    def score(self, X, y):
        """Per-observation R² against expected maxima (reference
        iem.py:735-758)."""
        pred_features = self.predict(X)
        y = np.asarray(y, dtype=float)
        ssres = np.sum((pred_features - y) ** 2, axis=1)
        sstot = np.sum((y - np.mean(y)) ** 2, axis=1)
        return 1 - ssres / sstot

    def score_against_reconstructed(self, X, y, metric="euclidean"):
        """Distance between reconstructions and expected pixel-domain
        patterns (reference iem.py:760-790)."""
        yhat = self.predict_feature_responses(X)
        if metric == "euclidean":
            score_value = _euclidean_distances(y.T, yhat.T)
        elif metric == "cosine":
            score_value = _cosine_distances(y.T, yhat.T)
        else:
            raise ValueError("metric must be 'euclidean' or 'cosine'")
        return score_value[0, :]

    def get_params(self, deep=True):
        return {"n_channels": self.n_channels,
                "channel_exp": self.channel_exp,
                "stim_fov": self.stim_fov,
                "stim_pixels": self.stim_pixels,
                "stim_radius_px": self.stim_radius_px, "xp": self.xp,
                "yp": self.yp, "channels": self.channels,
                "channel_limits": self.channel_limits,
                "device": self.device}

    def set_params(self, **parameters):
        for parameter, value in parameters.items():
            setattr(self, parameter, value)
        self._check_params()
        return self
