"""The port's fMRI simulator against the JAX package's on the CPU.

``brainiak_tpu_torch.utils.fmrisim`` on ``device="cpu"`` against
``brainiak_tpu.utils.fmrisim``.  Both draw from NumPy's global stream
by the same calls in the same order, so from one ``np.random.seed``
they give the same numbers: every case of ``tests/utils/test_fmrisim.py``
runs on both packages, and the port's float64 tensors are held to the
JAX package's arrays within 1e-10 relative to their largest magnitude
(``RTOL``; round-off of FFTs and reductions summed in another order).
Branches on floats must not flip: the calibrated spectral exponents
are equal within 1e-12 (``EXP_ATOL``), the fit loops read their
stopping rule as many times, and both packages leave the global stream
at the same state.  The host copies (feature volumes, stimulus
functions, the template) are equal.
"""

import os

import numpy as np
import pytest
import torch
from scipy import ndimage

import brainiak_tpu.utils.fmrisim as jsim
import brainiak_tpu_torch.utils.fmrisim as tsim

RTOL = 1e-10
EXP_ATOL = 1e-12
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=RTOL):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    got = got.cpu().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _both(seed, jax_fn, port_fn):
    """Run each from ``np.random.seed(seed)``; the global stream must end
    in the same state.  Returns (port, jax)."""
    np.random.seed(seed)
    want = jax_fn()
    after = np.random.rand()
    np.random.seed(seed)
    got = port_fn()
    assert np.random.rand() == after
    return got, want


class _Counter:
    """Wrap ``module.name`` to count its calls."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        inner = getattr(module, name)

        def counted(*args, **kwargs):
            self.calls += 1
            return inner(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)


def test_the_public_names_are_the_jax_packages():
    assert tsim.__all__ == jsim.__all__
    for name in tsim.__all__:
        assert callable(getattr(tsim, name)), name


def test_batched_draws_equal_the_loop():
    """One ``randn(n, X, Y, Z)`` is ``n`` calls of ``randn(X, Y, Z)`` in
    a row, an odd count included (legacy ``randn`` carries its cached
    Gaussian from call to call), and so for ``normal``; one
    ``standard_normal((3, X, Y, Z))`` of a ``default_rng`` is its three
    calls (the calibration's trial fields)."""
    dims = (3, 5, 7)
    np.random.seed(0)
    loop = np.stack([np.random.randn(*dims) for _ in range(5)])
    tail = np.random.randn(3)
    np.random.seed(0)
    np.testing.assert_array_equal(np.random.randn(5, *dims), loop)
    np.testing.assert_array_equal(np.random.randn(3), tail)
    np.random.seed(1)
    loop = np.stack([np.random.normal(0, 1, size=dims) for _ in range(3)])
    np.random.seed(1)
    np.testing.assert_array_equal(np.random.normal(0, 1, (3,) + dims), loop)
    rng = np.random.default_rng(1234)
    loop = np.stack([rng.standard_normal(dims) for _ in range(3)])
    np.testing.assert_array_equal(
        np.random.default_rng(1234).standard_normal((3,) + dims), loop)
    # the ARMA noise's trs fields: one batch, the same numbers
    mask = np.ones(dims)
    noise_dict = jsim._noise_dict_update({'fwhm': 2.0})
    got, want = _both(
        2,
        lambda: jsim._generate_noise_temporal_autoregression(
            list(range(9)), noise_dict, dims, mask),
        lambda: tsim._generate_noise_temporal_autoregression(
            list(range(9)), noise_dict, dims, mask, device=CPU))
    _close(got, want)


@pytest.mark.parametrize("dims, fwhm", [((10, 10, 10), 4.0),
                                        ((16, 16, 16), 2.0),
                                        ((16, 16, 16), 6.0),
                                        ((32, 32, 12), 4.0),
                                        ((24, 24, 16), 4.0),
                                        ((6, 6, 6), 0.5),
                                        ((6, 6, 6), 40.0)])
def test_calibrated_exponents_equal(dims, fwhm):
    """The bisection takes the same branch at every step (the two ends
    included: a request under the smoothest's FWHM and above the
    roughest's)."""
    got = tsim._spectral_exponent_for_fwhm(dims, fwhm, device=CPU)
    assert abs(got - jsim._spectral_exponent_for_fwhm(dims, fwhm)) \
        <= EXP_ATOL


def test_generate_signal():
    dimensions = np.array([10, 10, 10])
    volume = tsim.generate_signal(dimensions=dimensions,
                                  feature_coordinates=np.array([[5, 5, 5]]),
                                  feature_type=['cube'], feature_size=[3],
                                  signal_magnitude=[30], device=CPU)
    assert volume.dtype == torch.float64
    assert tuple(volume.shape) == tuple(dimensions)
    assert volume.max() == 30
    assert int((volume > 0).sum()) == 27
    assert volume[5, 5, 5] == 30 and volume[5, 5, 1] == 0

    coords = np.array([[5, 5, 5], [3, 3, 3], [7, 7, 7]])
    kw = dict(dimensions=dimensions, feature_coordinates=coords,
              feature_type=['loop', 'cavity', 'sphere'], feature_size=[3],
              signal_magnitude=[30])
    volume = tsim.generate_signal(device=CPU, **kw)
    np.testing.assert_array_equal(volume.numpy(), jsim.generate_signal(**kw))
    assert volume[5, 5, 5] == 0 and volume[3, 3, 3] == 0
    assert volume[7, 7, 7] != 0

    x, y, z = tsim._insert_idxs(np.array([0, 2, 10]), 3, dimensions)
    assert (x[1] - x[0], y[1] - y[0], z[1] - z[0]) == (2, 3, 1)

    kw = dict(dimensions=dimensions, feature_coordinates=np.array([[5, 5, 5]]),
              feature_type=['cube'], feature_size=[3], signal_magnitude=[30],
              signal_constant=0)
    got, want = _both(0, lambda: jsim.generate_signal(**kw),
                      lambda: tsim.generate_signal(device=CPU, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[4:7, 4:7, 4:7].std() > 0


def test_generate_stimfunction_and_convolve(tmp_path):
    onsets = [10, 30, 50, 70, 90]
    stimfunction = tsim.generate_stimfunction(onsets=onsets,
                                              event_durations=[6],
                                              total_time=100)
    np.testing.assert_array_equal(
        stimfunction, jsim.generate_stimfunction(onsets=onsets,
                                                 event_durations=[6],
                                                 total_time=100))
    assert stimfunction.shape[0] == 100 * 100
    assert np.sum(stimfunction) == 6 * len(onsets) * 100

    signal_function = tsim.convolve_hrf(stimfunction=stimfunction,
                                        tr_duration=2, device=CPU)
    _close(signal_function, jsim.convolve_hrf(stimfunction, 2))
    assert signal_function.shape[0] == 50

    stimfunction1 = tsim.generate_stimfunction(onsets=[0],
                                               event_durations=[1],
                                               total_time=100)
    sf = tsim.convolve_hrf(stimfunction=stimfunction1, tr_duration=1,
                           device=CPU)
    _close(sf, jsim.convolve_hrf(stimfunction1, 1))
    max_response = np.where(sf.numpy() != 0)[0].max()
    assert 25 < max_response <= 30
    assert (sf < 0).sum() > 0

    path = str(tmp_path / "timing.txt")
    tsim.export_3_column(stimfunction, path)
    jpath = str(tmp_path / "timing_jax.txt")
    jsim.export_3_column(stimfunction, jpath)
    assert open(path).read() == open(jpath).read()
    stimfunc_new = tsim.generate_stimfunction(onsets=None,
                                              event_durations=None,
                                              total_time=100,
                                              timing_file=path)
    assert np.all(stimfunc_new == stimfunction)

    with pytest.raises(ValueError):
        tsim.generate_stimfunction(onsets=onsets, event_durations=[5],
                                   total_time=89)

    cond_a = tsim.generate_stimfunction(onsets=onsets, event_durations=[5],
                                        total_time=110)
    cond_b = tsim.generate_stimfunction(onsets=[x + 5 for x in onsets],
                                        event_durations=[5],
                                        total_time=110)
    group = [np.hstack((cond_a, cond_b))] * 2
    epoch_path = str(tmp_path / "epochs.npy")
    tsim.export_epoch_file([torch.as_tensor(g) for g in group], epoch_path,
                           2)
    jsim.export_epoch_file(group, str(tmp_path / "epochs_jax.npy"), 2)
    epochs = np.load(epoch_path, allow_pickle=True)
    np.testing.assert_array_equal(
        epochs, np.load(str(tmp_path / "epochs_jax.npy")))
    assert len(epochs) == 2 and epochs[0].shape[0] == 2
    assert epochs[0].shape[1] >= 5

    from brainiak_tpu_torch.io import load_labels
    specs = load_labels(epoch_path)
    assert len(specs) == 2 and specs[0].shape == epochs[0].shape

    ragged = [np.hstack((cond_a, cond_b)),
              np.hstack((cond_a[:5500], cond_b[:5500]))]
    ragged_path = str(tmp_path / "epochs_ragged.npy")
    tsim.export_epoch_file(ragged, ragged_path, 2)
    loaded = np.load(ragged_path, allow_pickle=True)
    assert len(loaded) == 2 and loaded[0].shape != loaded[1].shape


def test_apply_signal_and_compute_signal_change():
    dimensions = np.array([10, 10, 10])
    volume = tsim.generate_signal(dimensions=dimensions,
                                  feature_coordinates=np.array([[5, 5, 5]]),
                                  feature_type=['cube'], feature_size=[2],
                                  signal_magnitude=[30], device=CPU)
    stimfunction = tsim.generate_stimfunction(onsets=[10, 30, 50, 70, 90],
                                              event_durations=[6],
                                              total_time=100)
    signal_function = tsim.convolve_hrf(stimfunction=stimfunction,
                                        tr_duration=2, device=CPU)
    jsignal_function = jsim.convolve_hrf(stimfunction, 2)
    stimfunction_tr = stimfunction[::200]
    mask, template = tsim.mask_brain(dimensions, mask_self=False, device=CPU)
    jmask, jtemplate = jsim.mask_brain(dimensions, mask_self=False)
    noise_dict = tsim._noise_dict_update({})
    noise, jnoise = _both(
        0,
        lambda: jsim.generate_noise(dimensions, stimfunction_tr, 2,
                                    jtemplate, jmask, dict(noise_dict),
                                    iterations=[0, 0]),
        lambda: tsim.generate_noise(dimensions, stimfunction_tr, 2,
                                    template, mask, dict(noise_dict),
                                    iterations=[0, 0], device=CPU))
    _close(noise, jnoise)
    nf = noise[5, 5, 5, :].reshape(50, 1)
    jnf = jnoise[5, 5, 5, :].reshape(50, 1)

    with pytest.raises(ValueError):
        tsim.compute_signal_change(signal_function, nf.T, noise_dict,
                                   [0.5], 'PSC', device=CPU)
    with pytest.raises(ValueError):
        tsim.compute_signal_change(signal_function, nf, noise_dict, 0.5,
                                   'PSC', device=CPU)
    for method in ['PSC', 'SFNR', 'CNR_Amp/Noise-SD',
                   'CNR_Signal-SD/Noise-SD']:
        sig_a = tsim.compute_signal_change(signal_function, nf, noise_dict,
                                           [0.5], method, device=CPU)
        sig_b = tsim.compute_signal_change(signal_function, nf, noise_dict,
                                           [1.0], method, device=CPU)
        assert np.isclose(sig_b.max() / sig_a.max(), 2), method

    # every method, one voxel and many (a magnitude a voxel), against
    # the JAX package's loop over voxels
    rng = np.random.RandomState(3)
    many_sig = np.abs(rng.randn(50, 6)) * jsignal_function
    many_noise = 900 + 30 * rng.randn(50, 6)
    mags = [0.2, 0.7, 1.0, 2.0, 3.5, 0.1]
    for method in ['SFNR', 'CNR_Amp/Noise-SD', 'CNR_Amp2/Noise-Var_dB',
                   'CNR_Signal-SD/Noise-SD', 'CNR_Signal-Var/Noise-Var_dB',
                   'PSC']:
        _close(tsim.compute_signal_change(signal_function, nf, noise_dict,
                                          [0.7], method, device=CPU),
               jsim.compute_signal_change(jsignal_function, jnf, noise_dict,
                                          [0.7], method))
        _close(tsim.compute_signal_change(many_sig, many_noise, noise_dict,
                                          list(mags), method, device=CPU),
               jsim.compute_signal_change(many_sig, many_noise, noise_dict,
                                          list(mags), method))
    zero = np.zeros((50, 2))
    assert torch.equal(tsim.compute_signal_change(
        zero, many_noise[:, :2], noise_dict, [1.0], 'PSC', device=CPU),
        torch.zeros((50, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match="method"):
        tsim.compute_signal_change(signal_function, nf, noise_dict,
                                   [0.7], 'Z-score', device=CPU)

    signal = tsim.apply_signal(signal_function=signal_function,
                               volume_signal=volume, device=CPU)
    _close(signal, jsim.apply_signal(jsignal_function, volume.numpy()))
    assert signal.shape == (10, 10, 10, 50)
    signal = tsim.apply_signal(signal_function=stimfunction,
                               volume_signal=volume, device=CPU)
    assert torch.any(signal == 30)
    pattern = rng.randn(50, 8)
    _close(tsim.apply_signal(pattern, volume, device=CPU),
           jsim.apply_signal(pattern, volume.numpy()))

    with pytest.raises(IndexError):
        sig_vox = int((volume > 0).sum())
        vox_pattern = np.tile(stimfunction, (1, sig_vox - 1))
        tsim.apply_signal(signal_function=vox_pattern, volume_signal=volume,
                          device=CPU)


def test_generate_noise_properties():
    dimensions = np.array([10, 10, 10])
    stimfunction = tsim.generate_stimfunction(onsets=[10, 30, 50, 70, 90],
                                              event_durations=[6],
                                              total_time=200)
    stimfunction_tr = stimfunction[::200]
    mask, template = tsim.mask_brain(dimensions, mask_self=False, device=CPU)
    noise_dict = tsim._noise_dict_update({'sfnr': 90, 'snr': 50})
    noise, want = _both(
        1,
        lambda: jsim.generate_noise(dimensions, stimfunction_tr, 2,
                                    template.numpy(), mask.numpy(),
                                    dict(noise_dict), iterations=[3, 0]),
        lambda: tsim.generate_noise(dimensions, stimfunction_tr, 2,
                                    template, mask, dict(noise_dict),
                                    iterations=[3, 0], device=CPU))
    _close(noise, want)
    assert noise.shape == (10, 10, 10, 100)
    assert torch.all(noise >= 0)
    assert noise[mask > 0].mean() > 10 * noise[mask == 0].mean()
    est_snr = tsim._calc_snr(noise, mask, device=CPU)
    assert est_snr == pytest.approx(jsim._calc_snr(want, mask.numpy()),
                                    rel=RTOL)
    assert 0.3 * noise_dict['snr'] < est_snr < 3 * noise_dict['snr']


NOISE_CASES = {
    "matched": ({}, (12, 12, 12), 60),
    "components": ({'drift_sigma': 1, 'physiological_sigma': 0.5,
                    'task_sigma': 0.5, 'auto_reg_rho': [0.4, 0.2],
                    'ma_rho': [0.3]}, (16, 16, 10), 80),
    "low_targets": ({'sfnr': 30, 'snr': 20, 'fwhm': 2.5}, (10, 10, 10), 50),
    "unmatched": ({'matched': 0, 'drift_sigma': 0.5}, (12, 10, 8), 40),
}


@pytest.mark.parametrize("case", sorted(NOISE_CASES))
def test_generate_noise_matches_and_fits_alike(case, monkeypatch):
    """``generate_noise`` from one seed: the same noise within 1e-10,
    each fit loop reading its stopping rule as many times (the SNR
    loop's reading is ``_snr`` in the port, ``_calc_snr`` in the JAX
    package; the SFNR loop's likewise)."""
    noise_dict, dims, trs = NOISE_CASES[case]
    dims = np.array(dims)
    jmask, jtemplate = jsim.mask_brain(dims, mask_self=False)
    stim = np.zeros((trs, 1))
    stim[10:20] = 1
    counts = {k: _Counter(monkeypatch, m, n) for k, (m, n) in
              {"jax_snr": (jsim, "_calc_snr"),
               "jax_sfnr": (jsim, "_calc_sfnr"),
               "port_snr": (tsim, "_snr"),
               "port_sfnr": (tsim, "_sfnr")}.items()}
    got, want = _both(
        4,
        lambda: jsim.generate_noise(dims, stim, 2, jtemplate, jmask,
                                    dict(noise_dict)),
        lambda: tsim.generate_noise(dims, stim, 2, jtemplate, jmask,
                                    dict(noise_dict), device=CPU))
    _close(got, want)
    assert counts["port_snr"].calls == counts["jax_snr"].calls
    assert counts["port_sfnr"].calls == counts["jax_sfnr"].calls
    if noise_dict.get('matched', 1):
        assert counts["port_snr"].calls > 0 and \
            counts["port_sfnr"].calls > 0
    else:
        assert counts["port_snr"].calls == counts["port_sfnr"].calls == 0


def test_packaged_brain_template(tmp_path):
    """The port's copy of the packaged template is the JAX package's
    file, reproducible from the procedural generator, and drives
    ``mask_brain`` as it does there."""
    path = os.path.join(os.path.dirname(tsim.__file__),
                        "sim_parameters", "brain_template.npz")
    jpath = os.path.join(os.path.dirname(jsim.__file__),
                         "sim_parameters", "brain_template.npz")
    assert path != jpath
    with np.load(path) as payload, np.load(jpath) as jpayload:
        stored = payload["template"]
        np.testing.assert_array_equal(stored, jpayload["template"])
    assert stored.shape == (91, 109, 91) and stored.dtype == np.uint8
    regen = np.round(tsim._synthetic_brain_template((91, 109, 91))
                     * 255.0).astype(np.uint8)
    assert np.abs(stored.astype(int) - regen.astype(int)).max() <= 1

    mask, template = tsim.mask_brain(np.array([12, 14, 12]),
                                     mask_self=False, device=CPU)
    jmask, jtemplate = jsim.mask_brain(np.array([12, 14, 12]),
                                       mask_self=False)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_array_equal(template.numpy(), jtemplate)
    assert mask.shape == (12, 14, 12) and template.shape == (12, 14, 12)
    assert 0.0 <= template.min() and 0.9 < template.max() <= 1.0
    assert 0.05 < float(mask.mean()) < 0.7

    custom = np.zeros((10, 10, 10))
    custom[3:7, 3:7, 3:7] = 1.0
    custom_path = tmp_path / "custom_template.npy"
    np.save(custom_path, custom)
    cmask, ctemplate = tsim.mask_brain(np.ones((10, 10, 10)),
                                       template_name=str(custom_path),
                                       mask_threshold=0.5,
                                       mask_self=False, device=CPU)
    np.testing.assert_array_equal(ctemplate.numpy(), custom)
    assert cmask.sum() == 4 ** 3


def test_calc_noise_roundtrip():
    dimensions = np.array([12, 12, 12])
    stimfunction = tsim.generate_stimfunction(onsets=[], event_durations=[1],
                                              total_time=150)
    stimfunction_tr = stimfunction[::100]
    mask, template = tsim.mask_brain(dimensions, mask_self=False, device=CPU)
    gen_dict = tsim._noise_dict_update({'sfnr': 60, 'snr': 40,
                                        'matched': 0})
    noise, want = _both(
        2,
        lambda: jsim.generate_noise(dimensions, stimfunction_tr, 1.5,
                                    template.numpy(), mask.numpy(),
                                    dict(gen_dict), iterations=[5, 5]),
        lambda: tsim.generate_noise(dimensions, stimfunction_tr, 1.5,
                                    template, mask, dict(gen_dict),
                                    iterations=[5, 5], device=CPU))
    _close(noise, want)
    est, jest = _both(3, lambda: jsim.calc_noise(want, mask.numpy(),
                                                 template.numpy()),
                      lambda: tsim.calc_noise(noise, mask, template,
                                              device=CPU))
    assert sorted(est) == sorted(jest)
    for key, value in jest.items():
        np.testing.assert_allclose(est[key], value, rtol=RTOL, atol=1e-13,
                                   err_msg=key)
    assert 0.4 * gen_dict['sfnr'] < est['sfnr'] < 2.5 * gen_dict['sfnr']
    assert 0.4 * gen_dict['snr'] < est['snr'] < 2.5 * gen_dict['snr']
    assert -1 < est['auto_reg_rho'][0] < 1
    assert est['fwhm'] > 0
    with pytest.raises(ValueError, match="Template"):
        tsim.calc_noise(noise, mask, template * 2, device=CPU)
    with pytest.raises(ValueError, match="Mask"):
        tsim.calc_noise(noise, None, template, device=CPU)


def test_calc_noise_over_100_trs():
    """Past 100 TRs the FWHM is measured on 100 TRs that
    ``np.random.choice`` picks: the same ones, one batch."""
    rng = np.random.RandomState(8)
    volume = 500 + ndimage.gaussian_filter(rng.randn(16, 16, 12, 130),
                                           (1, 1, 1, 0))
    mask = np.zeros((16, 16, 12))
    mask[5:11, 5:11, 4:8] = 1
    est, jest = _both(5, lambda: jsim.calc_noise(volume, mask,
                                                 mask * 0.8,
                                                 {'voxel_size': [2, 2, 3]}),
                      lambda: tsim.calc_noise(volume, mask, mask * 0.8,
                                              {'voxel_size': [2, 2, 3]},
                                              device=CPU))
    assert np.all(np.isfinite(list(jest['voxel_size']) +
                              [jest[k] for k in ('sfnr', 'snr', 'fwhm')]))
    for key, value in jest.items():
        np.testing.assert_allclose(est[key], value, rtol=RTOL, atol=1e-13,
                                   err_msg=key)


def test_spatial_noise_fwhm_calibration():
    for n in (16, 32):
        dims = (n, n, n)
        mask = np.ones(dims)
        est = {}
        for f in (2.0, 4.0, 6.0):
            fields, want = _both(
                5,
                lambda: [jsim._generate_noise_spatial(dims, fwhm=f)
                         for _ in range(8)],
                lambda: [tsim._generate_noise_spatial(dims, fwhm=f,
                                                      device=CPU)
                         for _ in range(8)])
            for got, jfield in zip(fields, want):
                _close(got, jfield)
            fw = [tsim._calc_fwhm(fld, mask, device=CPU) for fld in fields]
            np.testing.assert_allclose(
                fw, [jsim._calc_fwhm(w, mask) for w in want], rtol=RTOL)
            est[f] = np.mean(fw)
        assert est[2.0] < est[4.0] < est[6.0]
        for f, e in est.items():
            assert abs(e - f) / f < 0.35, (n, f, e)
    dims = (32, 32, 12)
    diffs = {ax: [] for ax in range(3)}
    fwhms = []
    np.random.seed(5)
    for _ in range(8):
        f = tsim._generate_noise_spatial(dims, fwhm=4.0, device=CPU).numpy()
        for ax in range(3):
            diffs[ax].append(np.std(np.diff(f, axis=ax)))
        fwhms.append(tsim._calc_fwhm(f, np.ones(dims), device=CPU))
    per_axis = [np.mean(diffs[ax]) for ax in range(3)]
    assert max(per_axis) / min(per_axis) < 1.3, per_axis
    assert abs(np.mean(fwhms) - 4.0) / 4.0 < 0.35


def test_masked_spatial_noise_and_estimators():
    """A masked field is z-scored within the mask; the FWHM with voxel
    sizes and a ragged mask, the SNR at other dilations and reference
    TRs, the SFNR; the 6-neighbour dilation is scipy's."""
    rng = np.random.RandomState(9)
    mask = np.zeros((22, 20, 18))
    mask[7:15, 6:14, 6:12] = \
        ndimage.gaussian_filter(rng.rand(8, 8, 6), 1.0) > 0.5
    for iterations in (1, 2, 5):
        grown = tsim._binary_dilation(torch.as_tensor(mask), iterations)
        np.testing.assert_array_equal(
            grown.numpy(), ndimage.binary_dilation(mask,
                                                   iterations=iterations))
    field, want = _both(
        6, lambda: jsim._generate_noise_spatial((22, 20, 18), mask=mask,
                                                fwhm=3.0),
        lambda: tsim._generate_noise_spatial((22, 20, 18), mask=mask,
                                             fwhm=3.0, device=CPU))
    _close(field, want)
    inside = field[torch.as_tensor(mask) > 0]
    assert abs(float(inside.mean())) < 1e-12
    assert float(inside.std(correction=0)) == pytest.approx(1.0)
    vol = 300 * mask[..., None] + rng.randn(22, 20, 18, 30) + \
        np.linspace(0, 3, 30) ** 2
    assert tsim._calc_fwhm(vol[..., 0], mask, [1.5, 2.0, 2.5], device=CPU) \
        == pytest.approx(jsim._calc_fwhm(vol[..., 0], mask,
                                         [1.5, 2.0, 2.5]), rel=RTOL)
    assert np.isfinite(jsim._calc_snr(vol, mask))
    for dilation, reference_tr in ((5, None), (2, None), (0, None),
                                   (1, [0, 3, 7]), (3, 4)):
        assert tsim._calc_snr(vol, mask, dilation, reference_tr,
                              device=CPU) == pytest.approx(
            jsim._calc_snr(vol, mask, dilation, reference_tr), rel=RTOL)
    assert tsim._calc_sfnr(vol, mask, device=CPU) == pytest.approx(
        jsim._calc_sfnr(vol, mask), rel=RTOL)


def test_drift_power_drop_spectrum():
    trs, tr, period = 300, 2.0, 150
    drift, want = _both(
        6, lambda: jsim._generate_noise_temporal_drift(
            trs, tr, basis="cos_power_drop", period=period),
        lambda: tsim._generate_noise_temporal_drift(
            trs, tr, basis="cos_power_drop", period=period, device=CPU))
    _close(drift, want)
    p = np.abs(np.fft.rfft(drift.numpy())) ** 2
    freqs = np.fft.rfftfreq(trs, d=tr)
    assert p[freqs <= 1.0 / period].sum() / p.sum() > 0.7
    assert p[freqs > 10.0 / period].sum() / p.sum() < 0.05
    with pytest.raises(ValueError):
        tsim._generate_noise_temporal_drift(100, 2.0, period=1.0, device=CPU)


def test_mask_brain():
    mask, template = tsim.mask_brain(np.array([10, 10, 10]),
                                     mask_self=False, device=CPU)
    jmask, jtemplate = jsim.mask_brain(np.array([10, 10, 10]),
                                       mask_self=False)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_array_equal(template.numpy(), jtemplate)
    assert mask.shape == (10, 10, 10)
    assert template.max() <= 1.0
    assert 0 < mask.sum() < mask.numel()
    assert mask[5, 5, 5] == 1 and mask[0, 0, 0] == 0
    vol = np.zeros((8, 8, 8, 3))
    vol[2:6, 2:6, 2:6, :] = 100
    mask2, template2 = tsim.mask_brain(torch.as_tensor(vol), mask_self=True,
                                       device=CPU)
    jmask2, jtemplate2 = jsim.mask_brain(vol, mask_self=True)
    np.testing.assert_array_equal(mask2.numpy(), jmask2)
    np.testing.assert_array_equal(template2.numpy(), jtemplate2)
    assert mask2[3, 3, 3] == 1 and mask2[0, 0, 0] == 0
    with pytest.raises(ValueError, match=">=3-D"):
        tsim.mask_brain(np.ones((5, 5)), mask_self=False, device=CPU)


def test_synthetic_template_structure():
    dims = (24, 24, 24)
    t = tsim._synthetic_brain_template(dims)
    np.testing.assert_array_equal(t, jsim._synthetic_brain_template(dims))
    assert t.shape == dims
    assert t.min() >= 0 and np.isclose(t.max(), 1.0)
    background = np.mean([t[0, 0, 0], t[-1, 0, 0], t[0, -1, -1],
                          t[-1, -1, -1]])
    center = t[10:14, 10:14, 10:14].mean()
    brain = t[t > 0.5].mean()
    assert background < 0.1
    assert background < center < brain
    t2 = tsim._synthetic_brain_template((12, 12))
    np.testing.assert_array_equal(t2, jsim._synthetic_brain_template((12, 12)))
    assert t2.shape == (12, 12) and np.isclose(t2.max(), 1.0)
    assert np.abs(t - t[::-1]).mean() < 0.05
    mask, template = tsim.mask_brain(np.ones(np.array(dims)),
                                     mask_self=False, device=CPU)
    assert 0.1 < float(mask.mean()) < 0.7


def test_drift_and_phys_components():
    cases = {
        "drift": (lambda m, **d: m._generate_noise_temporal_drift(
            200, 2.0, **d)),
        "sine": (lambda m, **d: m._generate_noise_temporal_drift(
            100, 2.0, basis="sine", **d)),
        "discrete_cos": (lambda m, **d: m._generate_noise_temporal_drift(
            200, 2.0, basis="discrete_cos", **d)),
        "short_discrete_cos": (lambda m, **d: m._generate_noise_temporal_drift(
            40, 2.0, basis="discrete_cos", **d)),
        "phys": (lambda m, **d: m._generate_noise_temporal_phys(
            list(np.arange(0, 100, 2.0)), **d)),
        "task": (lambda m, **d: m._generate_noise_temporal_task(
            np.array([0, 1, 0, 1, 1, 0] * 10), **d)),
        "task_rician": (lambda m, **d: m._generate_noise_temporal_task(
            np.array([0, 1, 0, 1, 1, 0] * 10), motion_noise='rician', **d)),
        "task_column": (lambda m, **d: m._generate_noise_temporal_task(
            np.array([[0], [2], [0], [1], [1], [0]] * 10), **d)),
    }
    for name, fn in cases.items():
        got, want = _both(3, lambda: fn(jsim), lambda: fn(tsim, device=CPU))
        _close(got, want)
        assert torch.all(torch.isfinite(got)), name
    np.random.seed(3)
    drift = tsim._generate_noise_temporal_drift(200, 2.0, device=CPU)
    assert drift.shape == (200,)
    assert np.isclose(float(drift.std(correction=0)), 1.0, atol=0.01)
    with pytest.raises(ValueError, match="gaussian or rician"):
        tsim._generate_noise_temporal_task(np.ones(10),
                                           motion_noise='poisson', device=CPU)
    with pytest.raises(ValueError, match="drift basis"):
        tsim._generate_noise_temporal_drift(100, 2.0, basis="spline",
                                            device=CPU)


def test_signal_feature_shapes_and_stim_file(tmp_path):
    dims = np.array([11, 11, 11])
    center = np.array([[5, 5, 5]])
    vols = {}
    for ft in ('loop', 'sphere', 'cavity'):
        vols[ft] = tsim.generate_signal(dimensions=dims,
                                        feature_coordinates=center,
                                        feature_type=[ft], feature_size=[5],
                                        signal_magnitude=[1], device=CPU)
        np.testing.assert_array_equal(
            vols[ft].numpy(),
            jsim.generate_signal(dimensions=dims, feature_coordinates=center,
                                 feature_type=[ft], feature_size=[5],
                                 signal_magnitude=[1]))
        assert vols[ft].shape == tuple(dims) and vols[ft].max() == 1.0
    assert vols['cavity'].sum() < vols['sphere'].sum()
    assert int((vols['loop'].sum(dim=(0, 1)) > 0).sum()) == 1
    with pytest.raises(ValueError, match="feature type"):
        tsim.generate_signal(dimensions=dims, feature_coordinates=center,
                             feature_type=['pyramid'], feature_size=[3],
                             signal_magnitude=[1], device=CPU)

    tfile = tmp_path / "events.txt"
    tfile.write_text("10.0 6.0 1.0\n30.0 6.0 1.0\n")
    from_file = tsim.generate_stimfunction(onsets=None, event_durations=None,
                                           total_time=60,
                                           timing_file=str(tfile))
    explicit = tsim.generate_stimfunction(onsets=[10.0, 30.0],
                                          event_durations=[6.0],
                                          total_time=60)
    np.testing.assert_array_equal(from_file, explicit)

    box = tsim.generate_stimfunction(onsets=[2], event_durations=[2],
                                     total_time=20)
    delta = np.zeros(100)
    delta[0] = 1.0
    conv = tsim.convolve_hrf(stimfunction=box, tr_duration=2,
                             hrf_type=delta, scale_function=False,
                             device=CPU)
    assert conv.shape[0] == 10
    np.testing.assert_allclose(conv[:, 0].numpy(), box[100::200, 0][:10])
    kernel = np.hanning(350) - 0.2
    two = np.hstack([box, 2 * np.roll(box, 700)])
    for scale in (True, False):
        _close(tsim.convolve_hrf(two, 2, hrf_type=kernel,
                                 scale_function=scale, device=CPU),
               jsim.convolve_hrf(two, 2, hrf_type=kernel,
                                 scale_function=scale))
        _close(tsim.convolve_hrf(two[:, 0], 1.5, scale_function=scale,
                                 temporal_resolution=50.0, device=CPU),
               jsim.convolve_hrf(two[:, 0], 1.5, scale_function=scale,
                                 temporal_resolution=50.0))

    vol = vols['sphere']
    sig4d = tsim.apply_signal(signal_function=np.ones(5), volume_signal=vol,
                              device=CPU)
    assert sig4d.shape == tuple(dims) + (5,)


def test_system_noise_distribution_variants():
    dims = (6, 6, 6, 30)
    for s_type, t_type in [("rician", "rician"),
                           ("exponential", "exponential"),
                           ("gaussian", "rician"),
                           ("gaussian", "gaussian")]:
        noise, want = _both(
            11, lambda: jsim._generate_noise_system(
                dims, spatial_sd=1.3, temporal_sd=0.7,
                spatial_noise_type=s_type, temporal_noise_type=t_type),
            lambda: tsim._generate_noise_system(
                dims, spatial_sd=1.3, temporal_sd=0.7,
                spatial_noise_type=s_type, temporal_noise_type=t_type,
                device=CPU))
        _close(noise, want)
        assert noise.shape == dims
        assert torch.all(torch.isfinite(noise))
        spatial_part = noise.mean(dim=3)
        temporal_part = noise - spatial_part[..., None]
        np.testing.assert_allclose(temporal_part.mean(dim=3).numpy(), 0.0,
                                   atol=1e-12)
        if s_type == "gaussian":
            assert abs(float(spatial_part.mean())) < 0.5
        else:
            assert float(spatial_part.mean()) > 0.5


def _arma_series(seed, n_vox, n_tr, burn, rho, theta):
    rng = np.random.RandomState(seed)
    e = rng.randn(n_vox, n_tr + burn)
    x = np.zeros((n_vox, n_tr + burn))
    for t in range(1, n_tr + burn):
        x[:, t] = rho * x[:, t - 1] + e[:, t] + theta * e[:, t - 1]
    return x[:, burn:]


def test_arma_mle_recovery():
    x = _arma_series(7, 40, 300, 50, 0.5, 0.3)
    (ar, ma), (jar, jma) = _both(
        8, lambda: jsim._calc_ARMA_noise(x, np.ones(40), sample_num=40),
        lambda: tsim._calc_ARMA_noise(x, np.ones(40), sample_num=40,
                                      device=CPU))
    np.testing.assert_allclose(ar + ma, jar + jma, rtol=RTOL, atol=1e-13)
    assert abs(ar[0] - 0.5) < 0.1
    assert abs(ma[0] - 0.3) < 0.12
    (ar, ma), (jar, jma) = _both(
        8, lambda: jsim._calc_ARMA_noise(x[0], None, 2, 3),
        lambda: tsim._calc_ARMA_noise(x[0], None, 2, 3, device=CPU))
    np.testing.assert_allclose(ar + ma, jar + jma, rtol=RTOL, atol=1e-13)
    assert len(ar) == 2 and len(ma) == 3


def test_arma_mle_golden_values():
    x = _arma_series(31, 3, 250, 50, 0.45, 0.25)
    x = (x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)
    rho, theta, ll = tsim._arma11_mle(x, device=CPU)
    jrho, jtheta, jll = jsim._arma11_mle(x)
    _close(rho, jrho)
    _close(theta, jtheta)
    _close(ll, jll)
    np.testing.assert_allclose(
        rho.numpy(), [0.45694444, 0.34814815, 0.4612963], atol=1e-6)
    np.testing.assert_allclose(
        theta.numpy(), [0.20453704, 0.27851852, 0.19148148], atol=1e-6)
    np.testing.assert_allclose(
        ll.numpy(), [-300.24724723, -309.17816001, -301.072746], atol=1e-4)


def test_arma_mle_white_noise_is_zero():
    w = np.random.RandomState(12).randn(40, 400)
    (ar, ma), (jar, jma) = _both(
        13, lambda: jsim._calc_ARMA_noise(w, np.ones(40), sample_num=40),
        lambda: tsim._calc_ARMA_noise(w, np.ones(40), sample_num=40,
                                      device=CPU))
    np.testing.assert_allclose(ar + ma, jar + jma, rtol=RTOL, atol=1e-13)
    assert abs(ar[0]) < 0.1 and abs(ma[0]) < 0.1


def test_arma_mle_weak_signal_not_shrunk():
    x = _arma_series(21, 50, 100, 50, 0.3, 0.0)
    (ar, ma), (jar, jma) = _both(
        22, lambda: jsim._calc_ARMA_noise(x, np.ones(50), sample_num=50),
        lambda: tsim._calc_ARMA_noise(x, np.ones(50), sample_num=50,
                                      device=CPU))
    np.testing.assert_allclose(ar + ma, jar + jma, rtol=RTOL, atol=1e-13)
    assert 0.15 < ar[0] + ma[0] < 0.45


def test_arma_loglik_prefers_truth():
    x = _arma_series(9, 1, 400, 50, 0.6, -0.2)
    x = (x - x.mean()) / x.std()
    cand_r = np.array([[0.6, 0.0, -0.6]])
    cand_t = np.array([[-0.2, 0.0, 0.5]])
    ll = tsim._arma11_loglik_grid(x, cand_r, cand_t, device=CPU)
    _close(ll, jsim._arma11_loglik_grid(x, cand_r, cand_t))
    assert int(torch.argmax(ll[0])) == 0


def test_gen_1d_gaussian_rfs():
    (rfs, tuning), (jrfs, jtuning) = _both(
        4, lambda: jsim.generate_1d_gaussian_rfs(20, 360, (0, 359), rf_size=15,
                                                 random_tuning=True,
                                                 rf_noise=0.1),
        lambda: tsim.generate_1d_gaussian_rfs(20, 360, (0, 359), rf_size=15,
                                              random_tuning=True,
                                              rf_noise=0.1, device=CPU))
    _close(rfs, jrfs)
    np.testing.assert_array_equal(tuning.numpy(), jtuning)
    assert rfs.shape == (20, 360)
    assert np.allclose(rfs.max(dim=1).values.numpy(), 1.0)
    assert np.all((tuning.numpy() >= 0) & (tuning.numpy() < 360))
    rfs2, tuning2 = tsim.generate_1d_gaussian_rfs(10, 360, (0, 360),
                                                  random_tuning=False,
                                                  device=CPU)
    assert len(np.unique(np.diff(tuning2.numpy()))) == 1
    trials = np.array([45, 180, 300])
    for feature_range in ((0, 360), (10, 370), (-20, 340)):
        data, want = _both(
            5, lambda: jsim.generate_1d_rf_responses(
                rfs2.numpy(), trials, 360, feature_range, trial_noise=0.01),
            lambda: tsim.generate_1d_rf_responses(
                rfs2, trials, 360, feature_range, trial_noise=0.01,
                device=CPU))
        _close(data, want)
        assert data.shape == (10, 3)


def test_convolve_hrf_rejects_unknown_string_hrf_type():
    box = tsim.generate_stimfunction(onsets=[2], event_durations=[2],
                                     total_time=20)
    with pytest.raises(ValueError, match="double-gamma"):
        tsim.convolve_hrf(stimfunction=box, tr_duration=2,
                          hrf_type='double-gamma', device=CPU)
    out = tsim.convolve_hrf(stimfunction=box, tr_duration=2,
                            hrf_type='double_gamma', device=CPU)
    assert out.shape[0] == 10
    np.testing.assert_array_equal(
        np.asarray(tsim._double_gamma_hrf(temporal_resolution=50.0)),
        np.asarray(jsim._double_gamma_hrf(temporal_resolution=50.0)))
