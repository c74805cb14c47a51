"""The port's ``utils/utils.py`` against the JAX package's on the CPU.

``brainiak_tpu_torch.utils.utils`` on ``device="cpu"`` against
``brainiak_tpu.utils.utils`` in float64: the cases of
``tests/utils/test_utils.py`` and ``tests/utils/test_gen_design.py``
(on ``tests/utils/example_design.1D``) run on both packages, the
device-side results (``sumexp_stable``, ``center_mass_exp``,
``gen_design``) within 1e-10 relative (``RTOL``), the host copies
equal.  ``phase_randomize`` draws its phases from a ``torch.Generator``
where the JAX package draws them from ``jax.random``: it is held to the
JAX package through the JAX key's own angles and through the power
spectrum it keeps.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.utils import utils as jutils
from brainiak_tpu_torch.ops import stats as tops_stats
from brainiak_tpu_torch.utils import utils as tutils

RTOL = 1e-10
CPU = "cpu"

DESIGN_1D = os.path.join(os.path.dirname(__file__), "utils",
                         "example_design.1D")

# stimulus timing fixtures of tests/utils/test_gen_design.py
FSL_1 = "5.2 2.0 2.0\n40.0 1.5 4.0\n50.0 1.0 2.0\n"
FSL_HALF = "5.2 2.0 1.0\n40.0 1.5 2.0\n50.0 1.0 1.0\n"
AFNI_1 = "5.2*2.0:2.0 40.0*4.0:1.5\n2.0*2.0:1.0\n"
AFNI_NEG = "-1.0\n"


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_the_public_names_are_the_jax_packages():
    assert tutils.__all__ == jutils.__all__
    for name in tutils.__all__:
        assert hasattr(tutils, name), name


def test_tri_sym_roundtrip():
    rng = np.random.RandomState(0)
    dim = 5
    sym = rng.rand(dim, dim)
    sym = sym + sym.T
    tri = tutils.from_sym_2_tri(sym)
    np.testing.assert_array_equal(tri, jutils.from_sym_2_tri(sym))
    assert tri.shape == (dim * (dim + 1) // 2,)
    back = tutils.from_tri_2_sym(tri, dim)
    np.testing.assert_array_equal(back, jutils.from_tri_2_sym(tri, dim))
    assert np.allclose(np.triu(back), np.triu(sym))


def test_sumexp_stable():
    rng = np.random.RandomState(1)
    data = rng.randn(4, 3) * 50
    s, m, e = tutils.sumexp_stable(data, device=CPU)
    for got, want in zip((s, m, e), jutils.sumexp_stable(data)):
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        _close(got, want)
    assert np.allclose(m.numpy(), data.max(axis=0))
    assert torch.all(torch.isfinite(s))
    soft = e / s
    assert np.allclose(soft.sum(dim=0).numpy(), 1.0)


def test_concatenate_not_none():
    a = np.ones((2, 3))
    out = tutils.concatenate_not_none([None, a, None, 2 * a], axis=0)
    np.testing.assert_array_equal(
        out, jutils.concatenate_not_none([None, a, None, 2 * a], axis=0))
    assert out.shape == (4, 3)
    assert np.allclose(out[2:], 2.0)


def test_cov2corr():
    rng = np.random.RandomState(2)
    x = rng.randn(100, 4)
    cov = np.cov(x.T)
    corr = tutils.cov2corr(cov)
    np.testing.assert_array_equal(corr, jutils.cov2corr(cov))
    assert np.allclose(np.diag(corr), 1.0)
    assert np.allclose(corr, np.corrcoef(x.T))


def test_circ_dist():
    x = np.array([0.0, np.pi / 2])
    y = np.array([np.pi / 2, 0.0])
    d = tutils.circ_dist(x, y)
    np.testing.assert_array_equal(d, jutils.circ_dist(x, y))
    assert np.allclose(d, [-np.pi / 2, np.pi / 2])
    with pytest.raises(ValueError):
        tutils.circ_dist(np.zeros(2), np.zeros(3))


@pytest.mark.parametrize("interval, scale", [((0, np.inf), 2.0),
                                             ((0.0, 1.0), 1.0),
                                             ((0.5, 3.0), 0.7)])
def test_center_mass_exp(interval, scale):
    got = tutils.center_mass_exp(interval, scale=scale, device=CPU)
    assert got.dtype == torch.float64 and got.dim() == 0
    _close(got, jutils.center_mass_exp(interval, scale=scale))


def test_center_mass_exp_rejects_bad_arguments():
    """Where the JAX package asserts, the port raises ValueError (an
    assert is gone under ``python -O``)."""
    assert np.isclose(float(tutils.center_mass_exp((0, np.inf), 2.0,
                                                   device=CPU)), 2.0)
    m = float(tutils.center_mass_exp((0.0, 1.0), 1.0, device=CPU))
    assert 0 < m < 0.5
    for interval, scale in (([0.0, 1.0], 1.0), ((0.0, 1.0, 2.0), 1.0),
                            ((-1.0, 1.0), 1.0), ((1.0, 0.5), 1.0),
                            ((0.0, 1.0), 0.0)):
        with pytest.raises(AssertionError):
            jutils.center_mass_exp(interval, scale)
        with pytest.raises(ValueError):
            tutils.center_mass_exp(interval, scale, device=CPU)


def test_array_correlation():
    rng = np.random.RandomState(3)
    x = rng.randn(50, 7)
    y = rng.randn(50, 7)
    r = tutils.array_correlation(x, y)
    np.testing.assert_array_equal(r, jutils.array_correlation(x, y))
    expected = [np.corrcoef(x[:, i], y[:, i])[0, 1] for i in range(7)]
    assert np.allclose(r, expected)
    assert np.allclose(tutils.array_correlation(x, y, axis=1),
                       tutils.array_correlation(x.T, y.T, axis=0))
    with pytest.raises(ValueError):
        tutils.array_correlation(x, y[:, :3])


def test_p_from_null():
    null = np.array([-2.0, -1.0, 0.0, 1.0, 2.0])
    for observed, side, exact in ((3.0, 'right', True), (3.0, 'right', False),
                                  (0.0, 'two-sided', True),
                                  (-3.0, 'left', True)):
        assert tutils.p_from_null(observed, null, side=side, exact=exact) \
            == jutils.p_from_null(observed, null, side=side, exact=exact)
    assert tutils.p_from_null(3.0, null, side='right', exact=True) == 0.0
    assert tutils.p_from_null(3.0, null, side='right') == \
        pytest.approx(1 / 6)
    assert tutils.p_from_null(0.0, null, side='two-sided', exact=True) == 1.0
    with pytest.raises(ValueError):
        tutils.p_from_null(0.0, null, side='up')


def test_phase_randomize_preserves_spectrum():
    rng = np.random.RandomState(4)
    data = rng.randn(60, 3, 2)
    with pytest.warns(DeprecationWarning):
        shifted = tutils.phase_randomize(data, random_state=0, device=CPU)
    assert shifted.dtype == torch.float64
    shifted = shifted.numpy()
    assert shifted.shape == data.shape
    assert not np.allclose(shifted, data)
    p0 = np.abs(np.fft.fft(data, axis=0))
    assert np.allclose(p0, np.abs(np.fft.fft(shifted, axis=0)), atol=1e-8)
    with pytest.warns(DeprecationWarning):
        shifted_odd = tutils.phase_randomize(data[:59], random_state=0,
                                             device=CPU).numpy()
    assert np.allclose(np.abs(np.fft.fft(data[:59], axis=0)),
                       np.abs(np.fft.fft(shifted_odd, axis=0)), atol=1e-8)
    d2 = rng.randn(40, 3)
    with pytest.warns(DeprecationWarning):
        assert tutils.phase_randomize(d2, random_state=1,
                                      device=CPU).shape == d2.shape


@pytest.mark.parametrize("shape, voxelwise", [((48, 2, 3), False),
                                              ((49, 4, 2), True),
                                              ((40, 3), False)])
def test_phase_randomize_matches_jax_on_its_angles(shape, voxelwise):
    """The JAX package's shim rotates by the angles its key draws; the
    port's op on those angles gives its surrogate within 1e-10 (2-D
    input as one voxel in both)."""
    rng = np.random.RandomState(6)
    data = rng.randn(*shape)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jutils.phase_randomize(data, voxelwise=voxelwise,
                                      random_state=7)
    n_trs = shape[0]
    n_vox = shape[1] if len(shape) == 3 else 1
    n_subj = shape[-1]
    angles = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(7),
        (tops_stats.n_positive_bins(n_trs), n_vox if voxelwise else 1,
         n_subj), dtype=jnp.float64)) * 2 * np.pi
    got = tops_stats.phase_randomize(torch.as_tensor(data),
                                     torch.as_tensor(angles))
    _close(got, want)


def test_phase_randomize_shim_delegates_to_the_op():
    """The shim seeds a CPU ``torch.Generator`` from ``random_state``
    (an int, a RandomState's next draw, or the global stream's) and
    hands it to ``ops.stats.phase_randomize``; seeds repeat, surrogates
    keep each series' mean, and the phase at one bin is uniform over
    seeds (the JAX shim's contract)."""
    rng = np.random.RandomState(6)
    data = rng.randn(48, 2, 3)
    with pytest.warns(DeprecationWarning):
        a = tutils.phase_randomize(data, random_state=7, device=CPU)
    want = tops_stats.phase_randomize(
        torch.as_tensor(data), generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        b = tutils.phase_randomize(data, random_state=7, device=CPU)
        c = tutils.phase_randomize(data, random_state=8, device=CPU)
        d = tutils.phase_randomize(data, device=CPU,
                                   random_state=np.random.RandomState(9))
        e = tutils.phase_randomize(data, device=CPU,
                                   random_state=np.random.RandomState(9))
        np.random.seed(3)
        f = tutils.phase_randomize(data, device=CPU)
        np.random.seed(3)
        g = tutils.phase_randomize(data, device=CPU)
        vox = tutils.phase_randomize(data, voxelwise=True, random_state=7,
                                     device=CPU)
        series = rng.randn(32, 1, 1)
        angles = np.array([np.angle(np.fft.fft(tutils.phase_randomize(
            series, random_state=seed, device=CPU)[:, 0, 0].numpy())[3])
            for seed in range(128)])
    assert torch.equal(a, b) and torch.equal(d, e) and torch.equal(f, g)
    assert not np.allclose(a.numpy(), c.numpy())
    assert not np.allclose(vox[:, 0].numpy(), vox[:, 1].numpy() *
                           data[:, 0].std() / data[:, 1].std())
    assert np.allclose(a.numpy().mean(axis=0), data.mean(axis=0), atol=1e-8)
    resultant = np.abs(np.mean(np.exp(1j * angles)))
    assert resultant < 4.0 / np.sqrt(len(angles))
    assert angles.min() < -2.0 and angles.max() > 2.0


def test_check_timeseries_input():
    rng = np.random.RandomState(5)
    arrays = [rng.randn(10, 4) for _ in range(3)]
    data, n_TRs, n_voxels, n_subjects = tutils._check_timeseries_input(arrays)
    np.testing.assert_array_equal(
        data, jutils._check_timeseries_input(arrays)[0])
    assert data.shape == (10, 4, 3)
    assert (n_TRs, n_voxels, n_subjects) == (10, 4, 3)
    data2, *_ = tutils._check_timeseries_input(rng.randn(10, 3))
    assert data2.shape == (10, 1, 3)
    with pytest.raises(ValueError):
        tutils._check_timeseries_input(rng.randn(10))
    with pytest.raises(ValueError):
        tutils._check_timeseries_input([rng.randn(10, 4), rng.randn(10, 5)])


def test_usable_cpu_count():
    assert tutils.usable_cpu_count() == jutils.usable_cpu_count() >= 1


class _FrozenClock:
    """A monotonic clock that moves when told to or slept on, recording
    the sleeps asked of it."""

    def __init__(self):
        self.now = 100.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.sleeps.append(seconds)
        self.now += seconds


@pytest.mark.parametrize("module", [jutils, tutils], ids=["jax", "port"])
def test_monotonic_pacer_schedule(module):
    """Tick t is due at start + t * period: consumer time between waits
    counts against the period, ``reset`` restarts the clock, and a
    period of 0 never sleeps; the port's pacer and the JAX package's
    ask for the same sleeps."""
    clock = _FrozenClock()
    pacer = module.MonotonicPacer(2.0)
    pacer._time = clock
    assert pacer.wait() == 0.0
    clock.now += 0.5
    assert pacer.wait() == pytest.approx(1.5)
    clock.now += 3.0        # a late consumer: no sleep, no drift
    assert pacer.wait() == 0.0
    assert pacer.wait() == pytest.approx(1.0)
    assert pacer.reset() is pacer
    assert pacer.wait() == 0.0
    assert clock.sleeps == pytest.approx([1.5, 1.0])
    assert module.MonotonicPacer(0.0).wait() == 0.0


# ---------------------------------------------------------------------------
# ReadDesign and gen_design (tests/utils/test_gen_design.py)

@pytest.fixture
def stim_files(tmp_path):
    paths = {}
    for name, content in [("fsl1", FSL_1), ("fsl_half", FSL_HALF),
                          ("afni1", AFNI_1), ("afni_neg", AFNI_NEG)]:
        p = tmp_path / f"{name}.txt"
        p.write_text(content)
        paths[name] = str(p)
    return paths


def _design(files, scan_duration, TR, style='FSL', **kw):
    """The port's design on the CPU, held to the JAX package's."""
    got = tutils.gen_design(files, scan_duration=scan_duration, TR=TR,
                            style=style, device=CPU, **kw)
    assert got.dtype == torch.float64
    _close(got, jutils.gen_design(files, scan_duration=scan_duration,
                                  TR=TR, style=style, **kw))
    return got.numpy()


def test_gen_design_fsl(stim_files):
    d1 = _design([stim_files["fsl1"]], [48, 20], 2)
    assert d1.shape == (34, 1)
    assert d1[24] == 0
    d3 = _design([stim_files["fsl1"]], 68, 2)
    assert d3[24] != 0
    d4 = _design([stim_files["fsl_half"]], [48, 20], 2)
    assert np.allclose(d1 * 0.5, d4)
    d5 = _design([stim_files["fsl_half"]], [48, 20], 1)
    assert np.abs(d4 - d5[::2]).mean() < 0.1
    d2 = _design([stim_files["fsl1"], stim_files["fsl_half"]], [48, 20], 2)
    assert d2.shape == (34, 2)
    hrf = {'response_delay': 5, 'undershoot_delay': 14,
           'response_dispersion': 1.1, 'undershoot_dispersion': 0.8,
           'undershoot_scale': 0.1}
    _design([stim_files["fsl1"]], [48, 20], 2, hrf_para=hrf, temp_res=0.02)


def test_gen_design_afni_equals_fsl(stim_files):
    d_fsl = _design([stim_files["fsl1"]], [48, 20], 2)
    d_afni = _design([stim_files["afni1"]], [48, 20], 2, style='AFNI')
    assert np.allclose(d_fsl, d_afni)


def test_gen_design_afni_negative_onset(stim_files):
    d = _design([stim_files["afni_neg"]], [48], 2, style='AFNI')
    assert np.all(d == 0.0)


def test_gen_design_bad_style(stim_files):
    with pytest.raises(ValueError):
        tutils.gen_design([stim_files["fsl1"]], scan_duration=[48], TR=2,
                          style='SPM', device=CPU)
    with pytest.raises(ValueError):
        tutils.gen_design([stim_files["afni1"]], scan_duration=[48], TR=2,
                          style='AFNI', device=CPU)


def test_gen_design_arg_validation(stim_files):
    with pytest.raises(ValueError, match="TR"):
        tutils.gen_design([stim_files["fsl1"]], scan_duration=[48], TR=0,
                          device=CPU)
    with pytest.raises(ValueError, match="scan_duration"):
        tutils.gen_design([stim_files["fsl1"]], scan_duration=[1], TR=2,
                          device=CPU)
    single = _design(stim_files["fsl1"], [48], 2)
    listed = _design([stim_files["fsl1"]], [48], 2)
    np.testing.assert_array_equal(single, listed)


def test_gen_design_fsl_short_columns(tmp_path):
    full = tmp_path / "full.txt"
    full.write_text("5.0 1.0 1.0\n20.0 1.0 1.0\n")
    short = tmp_path / "short.txt"
    short.write_text("5.0\n20.0\n")
    np.testing.assert_allclose(_design([str(short)], [48], 2),
                               _design([str(full)], [48], 2))


def test_read_design_header_mismatch_warns(tmp_path):
    ref = tutils.ReadDesign(DESIGN_1D)
    text = open(DESIGN_1D).read()
    bad = text.replace(f'ni_type = "{ref.n_col}*double"',
                       f'ni_type = "{ref.n_col + 3}*double"')
    assert bad != text
    p = tmp_path / "bad.1D"
    p.write_text(bad)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        d = tutils.ReadDesign(str(p))
    assert d.n_col == ref.n_col
    assert any("columns" in str(w.message) for w in caught)


@pytest.mark.parametrize("include_orth, include_pols",
                         [(True, True), (False, False), (True, False)])
def test_read_design_afni_fixture(include_orth, include_pols):
    d = tutils.ReadDesign(DESIGN_1D, include_orth=include_orth,
                          include_pols=include_pols)
    j = jutils.ReadDesign(DESIGN_1D, include_orth=include_orth,
                          include_pols=include_pols)
    for name in ("design", "column_types", "cols_task", "design_task",
                 "cols_nuisance"):
        np.testing.assert_array_equal(getattr(d, name), getattr(j, name))
    for name in ("n_col", "n_basis", "n_stim", "n_orth", "n_TR",
                 "StimLabels"):
        assert getattr(d, name) == getattr(j, name), name
    if j.reg_nuisance is None:
        assert d.reg_nuisance is None
    else:
        np.testing.assert_array_equal(d.reg_nuisance, j.reg_nuisance)
    assert d.n_TR == 186 and d.n_col == 27 and d.n_basis == 4
    assert d.n_stim > 0
    assert (d.reg_nuisance is None) == (not include_orth
                                        and not include_pols)
