"""The port's real-time fMRI generator against the JAX package's on the
CPU.

``brainiak_tpu_torch.utils.fmrisim_real_time_generator`` on
``device="cpu"`` against ``brainiak_tpu.utils.fmrisim_real_time_generator``:
the cases of ``tests/utils/test_fmrisim_real_time.py`` on the port, and
from one seed (``rng=`` or the global stream) the same scan: the
float64 ``brain`` within 1e-10 relative to its largest magnitude
(``RTOL``), the mask, ROIs and labels equal.  The ``.npy`` volumes are
int16 casts of ``brain`` (truncated toward zero), so a round-off step
across an integer can move one by 1: the written volumes are held to the
JAX package's within 1.
"""

import os

import numpy as np
import pytest
import torch

import brainiak_tpu.utils.fmrisim_real_time_generator as jrtg
import brainiak_tpu_torch.utils.fmrisim_real_time_generator as rtg
from brainiak_tpu_torch.utils.fmrisim_real_time_generator import (
    default_settings, generate_data, generate_stream)

RTOL = 1e-10
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same_scan(got, want):
    """Two ``RealtimeStream``s: the same brain to RTOL, the rest equal."""
    assert got.brain.dtype == np.float64
    assert got.brain.shape == want.brain.shape
    np.testing.assert_allclose(got.brain, want.brain, rtol=RTOL,
                               atol=RTOL * np.abs(want.brain).max())
    for name in ("mask", "roi_a", "roi_b", "labels"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype
    assert got.tr_duration_s == want.tr_duration_s


def test_the_public_names_are_the_jax_packages():
    assert rtg.__all__ == jrtg.__all__
    assert rtg.default_settings == jrtg.default_settings
    assert callable(rtg.main)


@pytest.mark.parametrize("settings", [
    {'numTRs': 20},
    {'numTRs': 12, 'multivariate_pattern': True},
    {'numTRs': 14, 'different_ROIs': True, 'trDuration': 1,
     'event_duration': 2, 'isi': 1, 'burn_in': 1},
], ids=["default", "multivariate", "different_rois"])
def test_generate_stream_matches_jax(settings):
    _same_scan(generate_stream(settings, rng=21, device=CPU),
               jrtg.generate_stream(settings, rng=21))


def test_generate_realtime_data(tmp_path):
    out = str(tmp_path / "rt")
    settings = dict(default_settings)
    settings.update({'numTRs': 20, 'save_dicom': False,
                     'save_realtime': False})
    np.random.seed(0)
    generate_data(out, settings, device=CPU)
    jout = str(tmp_path / "rt_jax")
    np.random.seed(0)
    jrtg.generate_data(jout, settings)
    files = sorted(os.listdir(out))
    assert files == sorted(os.listdir(jout))
    assert 'mask.npy' in files and 'labels.npy' in files
    vols = [f for f in files if f.startswith('rt_')]
    assert len(vols) == 20
    for name in files:
        got = np.load(os.path.join(out, name))
        want = np.load(os.path.join(jout, name))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name
    vol = np.load(os.path.join(out, vols[0]))
    assert vol.ndim == 3
    mask = np.load(os.path.join(out, 'mask.npy'))
    assert vol[mask > 0].mean() > vol[mask == 0].mean()
    labels = np.load(os.path.join(out, 'labels.npy'))
    assert set(np.unique(labels)).issubset({0.0, 1.0, 2.0})


def test_generate_realtime_multivariate(tmp_path):
    out = str(tmp_path / "rt_mv")
    settings = dict(default_settings)
    settings.update({'numTRs': 12, 'multivariate_pattern': True})
    np.random.seed(1)
    generate_data(out, settings, device=CPU)
    assert len([f for f in os.listdir(out) if f.startswith('rt_')]) == 12


def test_generate_realtime_custom_inputs(tmp_path, monkeypatch):
    """User-supplied template/ROI/noise-dict files and the
    different_ROIs + save_realtime branches, the same scan as the JAX
    package's."""
    dims = (20, 20, 12)
    template = np.ones(dims) * 800
    template_path = tmp_path / "template.npy"
    np.save(template_path, template)
    roi_a = np.zeros(dims)
    roi_a[4:8, 4:8, 4:8] = 1
    roi_b = np.zeros(dims)
    roi_b[12:16, 12:16, 4:8] = 1
    roi_a_path = tmp_path / "roi_a.npy"
    roi_b_path = tmp_path / "roi_b.npy"
    np.save(roi_a_path, roi_a)
    np.save(roi_b_path, roi_b)
    nd_path = tmp_path / "noise.txt"
    nd_path.write_text("{'snr': 25, 'sfnr': 60, 'max_activity': 800,"
                       " 'matched': 0}")

    out = str(tmp_path / "rt_custom")
    settings = dict(default_settings)
    settings.update({'numTRs': 14, 'trDuration': 1,
                     'event_duration': 2, 'isi': 1, 'burn_in': 1,
                     'template_path': str(template_path),
                     'ROI_A_file': str(roi_a_path),
                     'ROI_B_file': str(roi_b_path),
                     'noise_dict_file': str(nd_path),
                     'different_ROIs': True,
                     'save_realtime': True})
    sleeps = []
    monkeypatch.setattr(rtg.time, "sleep", sleeps.append)
    np.random.seed(3)
    generate_data(out, settings, device=CPU)
    vols = [f for f in sorted(os.listdir(out)) if f.startswith('rt_')]
    assert len(vols) == 14
    vol = np.load(os.path.join(out, vols[0]))
    assert vol.shape == dims
    assert len(sleeps) == 14
    assert all(0.0 <= s <= 1.0 for s in sleeps)
    assert sum(sleeps) > 10
    stream_settings = dict(settings, save_realtime=False)
    _same_scan(generate_stream(stream_settings, rng=4, device=CPU),
               jrtg.generate_stream(stream_settings, rng=4))


def test_dicom_gated(tmp_path):
    """Without pydicom the DICOM path raises the JAX package's error;
    with it, the ``.dcm`` volumes round-trip."""
    try:
        import pydicom  # noqa: F401
    except ImportError:
        settings = dict(default_settings)
        settings.update({'numTRs': 3, 'save_dicom': True})
        np.random.seed(2)
        with pytest.raises(ImportError, match="pydicom"):
            generate_data(str(tmp_path / "rt_dcm"), settings, device=CPU)
    else:
        out = str(tmp_path / "rt_dcm")
        settings = dict(default_settings)
        settings.update({'numTRs': 2, 'save_dicom': True})
        generate_data(out, settings, rng=0, device=CPU)
        vols = sorted(f for f in os.listdir(out) if f.endswith(".dcm"))
        assert len(vols) == 2
        ds = pydicom.dcmread(os.path.join(out, vols[0]))
        assert int(ds.NumberOfFrames) == 16
        assert (int(ds.Rows), int(ds.Columns)) == (24, 24)


def test_seeded_generate_data_is_byte_deterministic(tmp_path):
    settings = dict(default_settings)
    settings.update({'numTRs': 6})
    a, b, c = (str(tmp_path / name) for name in "abc")
    generate_data(a, settings, rng=11, device=CPU)
    generate_data(b, settings, rng=11, device=CPU)
    generate_data(c, settings, rng=12, device=CPU)
    files = sorted(os.listdir(a))
    assert sorted(os.listdir(b)) == files
    for name in files:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    vol_a = np.load(os.path.join(a, "rt_000.npy"))
    vol_c = np.load(os.path.join(c, "rt_000.npy"))
    assert not np.array_equal(vol_a, vol_c)


def test_generate_stream_matches_on_disk_volumes(tmp_path):
    settings = dict(default_settings)
    settings.update({'numTRs': 5})
    out = str(tmp_path / "rt")
    generate_data(out, settings, rng=21, device=CPU)
    stream = generate_stream({'numTRs': 5}, rng=21, device=CPU)
    assert stream.n_trs == 5 and len(stream) == 5
    assert stream.brain.shape[3] == 5
    assert np.array_equal(stream.mask, np.load(os.path.join(out, "mask.npy")))
    assert np.array_equal(stream.labels,
                          np.load(os.path.join(out, "labels.npy")))
    for tr, vol in enumerate(stream):
        on_disk = np.load(os.path.join(out, f"rt_{tr:0>3}.npy"))
        assert np.array_equal(vol.astype(np.int16), on_disk)
        assert np.array_equal(vol, stream.volume(tr))


def test_generate_stream_accepts_generator_instances():
    s1 = generate_stream({'numTRs': 3}, rng=np.random.default_rng(5),
                         device=CPU)
    s2 = generate_stream({'numTRs': 3}, rng=np.random.default_rng(5),
                         device=CPU)
    assert np.array_equal(s1.brain, s2.brain)
    _same_scan(s1, jrtg.generate_stream({'numTRs': 3},
                                        rng=np.random.default_rng(5)))


def test_paced_stream_follows_absolute_schedule(monkeypatch):
    sleeps = []
    monkeypatch.setattr(rtg.time, "sleep", sleeps.append)
    monkeypatch.setattr(rtg.time, "monotonic", lambda: 100.0)
    stream = rtg.generate_stream({'numTRs': 4, 'trDuration': 1},
                                 rng=0, paced=True, device=CPU)
    assert len(list(stream)) == 4
    assert sleeps == pytest.approx([1.0, 2.0, 3.0])


def test_seeded_simulation_restores_global_rng_stream():
    np.random.seed(123)
    expected = np.random.rand(3)
    np.random.seed(123)
    generate_stream({'numTRs': 3}, rng=5, device=CPU)
    assert np.array_equal(np.random.rand(3), expected)


def test_unseeded_stream_draws_from_the_global_state():
    """``rng=None`` draws from NumPy's global state: the same seed gives
    the same scan as the JAX package's, and leaves the stream where
    the JAX package leaves it."""
    np.random.seed(7)
    want = jrtg.generate_stream({'numTRs': 6})
    after = np.random.rand()
    np.random.seed(7)
    _same_scan(generate_stream({'numTRs': 6}, device=CPU), want)
    assert np.random.rand() == after
