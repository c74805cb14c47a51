"""The shared utility layer: every public name of the JAX package's
``brainiak_tpu/utils/utils.py``, as the port's own copies.

Host helpers stay NumPy: ``_check_timeseries_input``,
``array_correlation``, ``concatenate_not_none``, ``usable_cpu_count``,
``from_tri_2_sym`` / ``from_sym_2_tri``, ``circ_dist``, ``cov2corr``,
the :class:`MonotonicPacer` of the real-time paths and the AFNI design
reader :class:`ReadDesign`.  ``sumexp_stable``, ``center_mass_exp``,
``phase_randomize`` and ``gen_design``'s HRF convolution compute on
``device`` (default ``"cuda"``; without a card they raise unless given
``"cpu"``) and return float64 tensors there.  ``p_from_null`` is
re-exported from :mod:`brainiak_tpu_torch.stats.pvalues`.  The port
imports nothing of the JAX package.
"""

import logging
import os
import re
import warnings

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "array_correlation",
    "center_mass_exp",
    "circ_dist",
    "concatenate_not_none",
    "cov2corr",
    "from_sym_2_tri",
    "from_tri_2_sym",
    "gen_design",
    "MonotonicPacer",
    "p_from_null",
    "phase_randomize",
    "ReadDesign",
    "sumexp_stable",
    "usable_cpu_count",
]

logger = logging.getLogger(__name__)


def _check_timeseries_input(data):
    """Standardize time-series input to (data3d, n_TRs, n_voxels,
    n_subjects).

    Accepts a list of per-subject (n_TRs, n_voxels) arrays, a 2-D array
    (n_TRs, n_subjects), or a 3-D array (n_TRs, n_voxels, n_subjects).
    """
    if isinstance(data, list):
        shape0 = data[0].shape
        arrays = []
        for d in data:
            d = np.asarray(d)
            if d.shape != shape0:
                raise ValueError("All ndarrays in input list "
                                 "must be the same shape!")
            arrays.append(d[:, np.newaxis] if d.ndim == 1 else d)
        data = np.dstack(arrays)
    else:
        data = np.asarray(data)
        if data.ndim == 2:
            data = data[:, np.newaxis, :]
        elif data.ndim != 3:
            raise ValueError("Input ndarray should have 2 "
                             "or 3 dimensions (got {0})!".format(data.ndim))

    n_TRs, n_voxels, n_subjects = data.shape
    logger.debug(
        "Assuming %d subjects with %d time points and %d voxel(s) or ROI(s)",
        n_subjects, n_TRs, n_voxels)
    return data, n_TRs, n_voxels, n_subjects


def array_correlation(x, y, axis=0):
    """Column- (axis=0) or row-wise (axis=1) Pearson correlation of two
    arrays."""
    x = np.asarray(x)
    y = np.asarray(y)
    if x.shape != y.shape:
        raise ValueError("Input arrays must be the same shape")
    if axis == 1:
        x, y = x.T, y.T
    xd = x - x.mean(axis=0)
    yd = y - y.mean(axis=0)
    num = np.sum(xd * yd, axis=0)
    den = np.sqrt(np.sum(xd ** 2, axis=0) * np.sum(yd ** 2, axis=0))
    return num / den


def concatenate_not_none(data, axis=0):
    """Concatenate the non-None entries of a list of arrays."""
    return np.concatenate([d for d in data if d is not None], axis=axis)


def usable_cpu_count():
    """Number of CPUs usable by the current process (cpuset-aware)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def from_tri_2_sym(tri, dim):
    """Expand an upper-triangular 1-D vector into a dim×dim symmetric matrix.

    Only the upper triangle of the result is populated (matching the
    reference, utils/utils.py:69-92, which leaves the strict lower triangle
    zero).
    """
    symm = np.zeros((dim, dim), dtype=np.asarray(tri).dtype)
    symm[np.triu_indices(dim)] = tri
    return symm


def from_sym_2_tri(symm):
    """Extract the upper triangle (incl. diagonal) of a symmetric matrix
    as 1-D.

    Reference contract: utils/utils.py:95-115.
    """
    symm = np.asarray(symm)
    return symm[np.triu_indices_from(symm)]


def circ_dist(x, y):
    """Pairwise circular distance (radians) between two equal-size vectors.

    Reference contract: utils/utils.py:48-66.
    """
    x = np.asarray(x)
    y = np.asarray(y)
    if x.size != y.size:
        raise ValueError("Input sizes must match to compute pairwise "
                         "comparisons.")
    return np.angle(np.exp(1j * (x - y)))


def cov2corr(cov):
    """Convert a covariance matrix to a correlation matrix.

    Reference contract: utils/utils.py:185-206.
    """
    cov = np.asarray(cov)
    if cov.ndim != 2:
        raise ValueError("covariance matrix should be 2D array")
    inv_sd = 1.0 / np.sqrt(np.diag(cov))
    return cov * inv_sd[None, :] * inv_sd[:, None]


class MonotonicPacer:
    """Absolute-monotonic period scheduler: tick ``t`` is due at
    ``start + t * period_s``.

    The shared pacing primitive of the real-time paths (the
    simulator's :class:`~brainiak_tpu_torch.utils
    .fmrisim_real_time_generator.RealtimeStream` iterator): consumer
    time between :meth:`wait` calls counts against the period, so
    pacing never drifts, and the monotonic clock is immune to
    wall-clock steps (NTP, DST).  ``period_s <= 0`` disables pacing.
    :meth:`reset` forgets the schedule (a resumed replay restarts its
    clock; the gap was downtime, not lateness).
    """

    def __init__(self, period_s):
        import time as _time  # late: keep this module numpy-light
        self._time = _time
        self.period_s = float(period_s)
        self._next_due = None

    def reset(self):
        self._next_due = None
        return self

    def wait(self):
        """Sleep until the next tick is due, then advance the
        schedule.  Returns the seconds slept."""
        if self.period_s <= 0.0:
            return 0.0
        now = self._time.monotonic()
        if self._next_due is None:
            self._next_due = now
        delay = self._next_due - now
        if delay > 0:
            self._time.sleep(delay)
        self._next_due += self.period_s
        return max(delay, 0.0)


def _float64_on(data, device):
    return torch.as_tensor(data, dtype=torch.float64).to(
        resolve_device(device))


def sumexp_stable(data, device="cuda"):
    """Stable sum of exponentials over dimension 0, on ``device``.

    Returns ``(result_sum, max_value, result_exp)`` with
    ``result_exp = exp(data - max)``, ``result_sum = sum(result_exp,
    dim=0)``, float64 tensors.
    """
    data = _float64_on(data, device)
    max_value = data.max(dim=0).values
    result_exp = torch.exp(data - max_value)
    return result_exp.sum(dim=0), max_value, result_exp


def center_mass_exp(interval, scale=1.0, device="cuda"):
    """Center of mass of an exponential distribution on an interval,
    as a float64 0-d tensor on ``device``.  Raises ``ValueError`` on a
    bad interval or scale."""
    if not isinstance(interval, tuple):
        raise ValueError("interval must be a tuple")
    if len(interval) != 2:
        raise ValueError("interval must be length two")
    left, right = interval
    if not left >= 0:
        raise ValueError("interval_left must be non-negative")
    if not right > left:
        raise ValueError("interval_right must be bigger than interval_left")
    if not scale > 0:
        raise ValueError("scale must be positive")
    bounds = _float64_on([left, right], device)
    if not np.isfinite(right):
        return bounds[0] + scale
    el, er = torch.exp(-bounds / scale)
    return ((bounds[0] + scale) * el - (bounds[1] + scale) * er) / (el - er)


def phase_randomize(data, voxelwise=False, random_state=None,
                    device="cuda"):
    """Randomize the phase of time series, preserving the power
    spectrum (dimension 0 is time).

    .. deprecated::
        A shim over :func:`brainiak_tpu_torch.ops.stats
        .phase_randomize`, which takes explicit angles or a
        ``torch.Generator``.  ``random_state`` (a seed, a
        ``np.random.RandomState`` or None for NumPy's global stream)
        seeds a CPU ``torch.Generator``, so a seed gives the same
        surrogate on every device; the draws differ from the JAX
        package's (its ``jax.random`` key), the distribution does not.

    Same phase shift across voxels by default; per-voxel shifts when
    ``voxelwise=True``.  Accepts 2-D (TR x subject) or 3-D (TR x voxel
    x subject) input; returns a float64 tensor on ``device``.
    """
    warnings.warn(
        "brainiak_tpu_torch.utils.utils.phase_randomize is deprecated; "
        "use brainiak_tpu_torch.ops.stats.phase_randomize (explicit "
        "angles or torch.Generator) or the 'phase_randomize' surrogate "
        "family in brainiak_tpu_torch.stats", DeprecationWarning,
        stacklevel=2)
    from ..ops.stats import phase_randomize as _phase_randomize

    data_ndim = np.ndim(data)
    data, _, _, _ = _check_timeseries_input(data)
    if isinstance(random_state, np.random.RandomState):
        seed = int(random_state.randint(0, 2 ** 32 - 1))
    elif random_state is None:
        seed = int(np.random.randint(0, 2 ** 32 - 1))
    else:
        seed = int(random_state)
    generator = torch.Generator().manual_seed(seed)
    shifted = _phase_randomize(_float64_on(data, device),
                               generator=generator, voxelwise=voxelwise)
    return shifted[:, 0, :] if data_ndim == 2 else shifted


# p_from_null's home is the port's stats.pvalues (the NumPy conventions
# shared with the streaming NullAccumulator), re-exported here as the
# JAX package does
from ..stats.pvalues import p_from_null  # noqa: E402,F401


class ReadDesign:
    """Reader for AFNI 3dDeconvolve design matrices (``.1D``/``.1d``/
    ``.txt``), on the host.

    Parses the ``ni_type``, ``ColumnGroups`` and ``StimLabels`` header
    comments to classify columns into task (>0), orthogonal/motion (0)
    and polynomial-drift (-1) regressors.
    """

    _RE_NCOL = re.compile(r'^#\s+ni_type\s+=\s+"(\d+)[*]', re.MULTILINE)
    _RE_GROUPS = re.compile(r'^#\s+ColumnGroups\s+=\s+"(.+)"', re.MULTILINE)
    _RE_LABELS = re.compile(r'^#\s+StimLabels\s+=\s+"(.+)"', re.MULTILINE)

    def __init__(self, fname=None, include_orth=True, include_pols=True):
        self.design = np.zeros([0, 0])
        self.n_col = 0
        self.column_types = np.ones(0)
        self.n_basis = 0
        self.n_stim = 0
        self.n_orth = 0
        self.StimLabels = []

        if fname is not None:
            _, ext = os.path.splitext(fname)
            if ext in ('.1D', '.1d', '.txt'):
                self.read_afni(fname)

        self.include_orth = include_orth
        self.include_pols = include_pols

        self.cols_task = np.where(self.column_types == 1)[0]
        self.design_task = self.design[:, self.cols_task]
        self.n_TR = self.design_task.shape[0]

        nuisance_cols = []
        if self.include_orth:
            nuisance_cols.append(np.where(self.column_types == 0)[0])
        if self.include_pols:
            nuisance_cols.append(np.where(self.column_types == -1)[0])
        self.cols_nuisance = np.intp(np.sort(np.concatenate(nuisance_cols))) \
            if nuisance_cols else np.array([], dtype=np.intp)
        if self.cols_nuisance.size > 0:
            self.reg_nuisance = self.design[:, self.cols_nuisance]
        else:
            self.reg_nuisance = None

    def read_afni(self, fname):
        self.design = np.loadtxt(fname, ndmin=2)
        with open(fname) as f:
            text = f.read()

        m = self._RE_NCOL.search(text)
        if m:
            self.n_col = int(m.group(1))
            if self.n_col != self.design.shape[1]:
                warnings.warn('The number of columns in the design matrix'
                              'does not match the header information')
                self.n_col = self.design.shape[1]
        else:
            self.n_col = self.design.shape[1]

        self.column_types = np.ones(self.n_col)
        m = self._RE_GROUPS.search(text)
        if m:
            idx = 0
            for group in m.group(1).split(','):
                parts = group.split('@')
                if len(parts) == 2:
                    # "<count>@<type>": count columns of the given type
                    count, ctype = int(parts[0]), int(parts[1])
                    self.column_types[idx:idx + count] = ctype
                    idx += count
                elif len(parts) == 1 and not re.search(r'\..', parts[0]):
                    self.column_types[idx] = int(parts[0])
                    idx += 1
                else:
                    # "<label>..<count>": a run of stimulus columns
                    count = int(group.split('..')[1])
                    self.column_types[idx:idx + count] = 1
                    idx += count
            self.n_basis = int(np.sum(self.column_types == -1))
            self.n_stim = int(np.sum(self.column_types > 0))
            self.n_orth = int(np.sum(self.column_types == 0))

        m = self._RE_LABELS.search(text)
        self.StimLabels = re.split(r'[ ;]+', m.group(1)) if m else []


def _design_events(fname, style, n_runs, run_starts, scan_duration):
    """Per-run lists of (onset, duration, weight) of one timing file.

    FSL: one event per line, columns onset[, duration[, weight]],
    onsets on the concatenated-run timeline; events outside every run
    are dropped.  AFNI: one line per run, tokens
    ``onset[*weight][:duration]``; ``*`` marks an empty run; events
    with onset < 0 or beyond the run duration are dropped.  Defaults:
    duration 1.0, weight 1.0.
    """
    events = [[] for _ in range(n_runs)]
    if style == 'FSL':
        with open(fname) as f:
            for line in f:
                cols = line.split()
                if not cols:
                    continue
                onset = float(cols[0])
                duration = float(cols[1]) if len(cols) >= 2 else 1.0
                weight = float(cols[2]) if len(cols) >= 3 else 1.0
                run = int(np.searchsorted(run_starts, onset,
                                          side='right')) - 1
                if 0 <= run < n_runs:
                    events[run].append((onset - run_starts[run],
                                        duration, weight))
        return events
    with open(fname) as f:
        lines = [ln.strip() for ln in f if ln.strip() != '']
    if len(lines) != n_runs:
        raise ValueError('Number of lines does not match number of runs!')
    for run, line in enumerate(lines):
        toks = line.split()
        if toks and toks[0] == '*':
            continue
        for tok in toks:
            duration, weight = 1.0, 1.0
            if ':' in tok:
                tok, dur_s = tok.rsplit(':', 1)
                duration = float(dur_s)
            if '*' in tok:
                tok, weight_s = tok.split('*')
                weight = float(weight_s)
            onset = float(tok)
            if 0 <= onset < scan_duration[run]:
                events[run].append((onset, duration, weight))
    return events


def gen_design(stimtime_files, scan_duration, TR, style='FSL',
               temp_res=0.01, hrf_para=None, device="cuda"):
    """Generate design matrix columns from stimulus timing files.

    Boxcar (or parametrically modulated) event trains, built on the
    host from the parsed files, are convolved with a double-gamma HRF
    (``scipy.stats.gamma``, built on the host) at ``temp_res`` on
    ``device``, as one float64 ``conv1d`` over every condition and run
    at once, then sampled at mid-TR.  Supports FSL 3-column and AFNI
    stimtime formats, and multiple runs (concatenated along time).

    Parameters
    ----------
    stimtime_files : str or list of str
        One file (or a list of per-condition files).  FSL style: three
        columns (onset, duration, weight); AFNI style: one row per run of
        onsets, ``*`` for empty runs, optionally ``onset*weight`` or
        ``onset:duration`` annotations.
    scan_duration : float or list/array of float
        Duration (s) of each fMRI run; scalar for a single run.
    TR : float
        Repetition time (s).
    style : 'FSL' or 'AFNI'
    temp_res : float
        Temporal resolution (s) at which convolution is performed.
    hrf_para : dict or None
        Double-gamma parameters: keys ``response_delay``,
        ``undershoot_delay``, ``response_dispersion``,
        ``undershoot_dispersion``, ``undershoot_scale``.

    Returns
    -------
    design : float64 tensor on ``device``, [n_TRs_total, n_conditions]
    """
    if hrf_para is None:
        hrf_para = {'response_delay': 6, 'undershoot_delay': 12,
                    'response_dispersion': 0.9, 'undershoot_dispersion': 0.9,
                    'undershoot_scale': 0.035}
    if style not in ('FSL', 'AFNI'):
        raise ValueError("style must be 'FSL' or 'AFNI'")
    if isinstance(stimtime_files, str):
        stimtime_files = [stimtime_files]
    scan_duration = np.atleast_1d(np.asarray(scan_duration, dtype=float))
    if TR <= 0:
        raise ValueError("TR must be positive")
    if np.any(scan_duration <= TR):
        raise ValueError("scan_duration must exceed TR for every run")
    dev = resolve_device(device)
    n_runs = scan_duration.size
    run_TRs = np.round(scan_duration / TR).astype(int)

    from scipy.stats import gamma as gamma_dist
    hrf_len = int(np.round(32.0 / temp_res))
    t = np.arange(hrf_len) * temp_res
    response = gamma_dist.pdf(
        t, hrf_para['response_delay'] / hrf_para['response_dispersion'],
        scale=hrf_para['response_dispersion'])
    undershoot = gamma_dist.pdf(
        t, hrf_para['undershoot_delay'] / hrf_para['undershoot_dispersion'],
        scale=hrf_para['undershoot_dispersion'])
    hrf = response - hrf_para['undershoot_scale'] * undershoot
    hrf = hrf / np.max(hrf)

    run_starts = np.concatenate([[0.0], np.cumsum(scan_duration)])
    n_cond = len(stimtime_files)
    n_hi = [int(np.round(d / temp_res)) for d in scan_duration]
    # one boxcar row per (condition, run), zero-padded to the longest
    # run: the convolution is causal, so the padding reaches no sample
    boxcars = np.zeros((n_cond * n_runs, max(n_hi)))
    for c, fname in enumerate(stimtime_files):
        events = _design_events(fname, style, n_runs, run_starts,
                                scan_duration)
        for run in range(n_runs):
            row = boxcars[c * n_runs + run]
            for onset, duration, weight in events[run]:
                lo = int(np.round(onset / temp_res))
                hi = int(np.round((onset + duration) / temp_res))
                row[lo:min(hi, n_hi[run])] += weight
    # np.convolve(boxcar, hrf)[:n_hi]: conv1d correlates, so the kernel
    # is flipped and the input padded by its length less one on the left
    x = torch.from_numpy(boxcars).to(dev)[:, None, :]
    kernel = torch.from_numpy(hrf[::-1].copy()).to(dev)[None, None, :]
    conv = torch.nn.functional.conv1d(
        torch.nn.functional.pad(x, (hrf_len - 1, 0)), kernel)[:, 0, :]
    # scaled by temp_res so the amplitude approximates the integral of
    # weight x HRF; sampled at mid-TR
    conv = conv * temp_res
    stride = int(round(TR / temp_res))
    cols = []
    for c in range(n_cond):
        runs = []
        for run in range(n_runs):
            idx = np.minimum(stride // 2 + np.arange(run_TRs[run]) * stride,
                             n_hi[run] - 1)
            runs.append(conv[c * n_runs + run,
                             torch.from_numpy(idx).to(dev)])
        cols.append(torch.cat(runs))
    return torch.stack(cols, dim=1)
