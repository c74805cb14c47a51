"""The port's inverted encoding models and hyperparameter optimizer
against the JAX package on the CPU.

``brainiak_tpu_torch.reconstruct`` on ``device="cpu"`` against
``brainiak_tpu.reconstruct`` in float64 (the harness turns the JAX
package's x64 on; the port through its private ``_fit(..., dtype)``),
on ``tests/reconstruct/test_iem.py``'s data and seeds: ``W_``, channel
responses, feature responses and scores within 1e-10 relative,
predictions equal; the JAX tests' own bars on the port's float32
``fit``; the validation errors and the rank-deficient warning; the
reconstruction-space scores against sklearn's distances.
``brainiak_tpu_torch.hyperparamopt`` against
``brainiak_tpu.hyperparamopt``: the same trial list from one
``np.random.seed``, and ``tests/hyperparamopt/test_hpo.py``'s checks.
"""

import numpy as np
import pytest
import scipy.stats as st
import torch
from sklearn.metrics.pairwise import cosine_distances, euclidean_distances

from brainiak_tpu.hyperparamopt import hpo as jhpo
from brainiak_tpu.reconstruct import iem as jiem
from brainiak_tpu_torch import convert
from brainiak_tpu_torch.funcalign.srm import NotFittedError
from brainiak_tpu_torch.hyperparamopt import hpo as thpo
from brainiak_tpu_torch.reconstruct import iem as tiem

F64 = torch.float64
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def make_1d_data(n_per=12, n_voxels=30, noise=0.2, seed=0,
                 mode='halfcircular'):
    """``tests/reconstruct/test_iem.py``'s voxels with random tuning."""
    rng = np.random.RandomState(seed)
    span = 180.0 if mode == 'halfcircular' else 360.0
    features = np.repeat(np.linspace(0, span - span / 6, 6), n_per)
    prefs = rng.rand(n_voxels) * span
    factor = 2.0 if mode == 'halfcircular' else 1.0
    tuning = np.cos(np.deg2rad(factor * (features[:, None]
                                         - prefs[None, :]))) ** 2
    X = tuning + noise * rng.randn(len(features), n_voxels)
    return X, features


CASES_1D = {
    "halfcircular": dict(),
    "circular": dict(stimulus_mode='circular', range_stop=360.),
    "stimulus_resolution": dict(stimulus_resolution=90),
}


def _same_model(port, ref, X, y):
    _close(port.W_, ref.W_)
    _close(port._predict_channel_responses(X),
           ref._predict_channel_responses(X))
    responses = (port._predict_feature_responses(X)
                 if hasattr(port, "_predict_feature_responses")
                 else port.predict_feature_responses(X))
    ref_responses = (ref._predict_feature_responses(X)
                     if hasattr(ref, "_predict_feature_responses")
                     else ref.predict_feature_responses(X))
    _close(responses, ref_responses)
    assert np.array_equal(port.predict(X), ref.predict(X))
    _close(port.score(X, y), ref.score(X, y))


@pytest.mark.parametrize("case", sorted(CASES_1D))
def test_iem1d_matches_jax(case):
    kw = dict(n_channels=6, channel_exp=5, **CASES_1D[case])
    X, y = make_1d_data(mode=kw.get("stimulus_mode", "halfcircular"))
    ref = jiem.InvertedEncoding1D(**kw).fit(X, y)
    port = tiem.InvertedEncoding1D(device="cpu", **kw)._fit(X, y, F64)
    assert port.W_.dtype == np.float64
    _close(port.channels_, ref.channels_)
    _close(port.channel_centers_, ref.channel_centers_)
    _same_model(port, ref, X, y)
    conv = convert.iem_from_jax(ref, device="cpu")
    _same_model(conv, ref, X, y)


@pytest.mark.parametrize("case,bar,half", [("halfcircular", 20, 90),
                                           ("circular", 40, 180),
                                           ("stimulus_resolution", 20, 90)])
def test_iem1d_recovers_features(case, bar, half):
    """The JAX tests' bars on the port's float32 fit."""
    kw = dict(n_channels=6, channel_exp=5, **CASES_1D[case])
    X, y = make_1d_data(mode=kw.get("stimulus_mode", "halfcircular"))
    model = tiem.InvertedEncoding1D(device="cpu", **kw).fit(X, y)
    assert model.W_.dtype == np.float32
    pred = model.predict(X)
    err = np.abs(((pred - y) + half) % (2 * half) - half)
    assert np.median(err) < bar
    if case == "halfcircular":
        assert model.score(X, y) > 0.5


def test_iem1d_validation():
    X, y = make_1d_data()
    for kw in (dict(range_start=100, range_stop=80),
               dict(stimulus_mode='halfcircular', range_stop=90.),
               dict(stimulus_mode='circular', range_stop=180.),
               dict(n_channels=1), dict(stimulus_mode='oval')):
        with pytest.raises(ValueError) as port_err:
            tiem.InvertedEncoding1D(device="cpu", **kw)
        with pytest.raises(ValueError) as jax_err:
            jiem.InvertedEncoding1D(**kw)
        assert str(port_err.value) == str(jax_err.value)
    model = tiem.InvertedEncoding1D(device="cpu")
    with pytest.raises(ValueError, match="Fewer observations"):
        model.fit(X[:3], y[:3])
    with pytest.raises(ValueError, match="Mismatched"):
        model.fit(X, y[:-2])
    with pytest.raises(NotFittedError):
        model.predict(X)
    params = model.get_params()
    assert params["n_channels"] == 6 and params["device"] == "cpu"
    model.set_params(n_channels=8)
    assert model.n_channels == 8
    bad = tiem.InvertedEncoding1D(n_channels=6, channel_exp=5,
                                  channel_density=180,
                                  stimulus_resolution=77, device="cpu")
    with pytest.raises(NotImplementedError):
        bad.fit(X, y)


def test_iem1d_rank_deficient_warns():
    """A single repeated stimulus gives a rank-deficient design: the
    port warns as the JAX package does, and its pseudo-inverse drops
    the singular values the JAX package's drops (``jnp.linalg.pinv``'s
    cutoff), so both fit the same ``W_``."""
    X, y = make_1d_data()
    y_const = np.zeros_like(y)
    ref = jiem.InvertedEncoding1D(n_channels=6, channel_exp=5)
    port = tiem.InvertedEncoding1D(n_channels=6, channel_exp=5,
                                   device="cpu")
    with pytest.warns(RuntimeWarning, match="full rank"):
        try:
            ref.fit(X, y_const)
        except ValueError:
            pass
    with pytest.warns(RuntimeWarning, match="full rank"):
        try:
            port._fit(X, y_const, F64)
        except ValueError:
            pass
    C = ref._define_trial_activations(y_const)
    want = np.asarray(jiem.jnp.asarray(X).T
                      @ jiem.jnp.linalg.pinv(jiem.jnp.asarray(C).T))
    got = tiem._fit_weights(torch.as_tensor(X), C, F64)
    _close(got, want)
    assert tiem._cond(torch.as_tensor(X)) == pytest.approx(
        np.linalg.cond(X), rel=1e-10)


def test_pinv_cutoff_is_the_jax_packages():
    """A singular value between torch's default cutoff (max(m, n) eps
    s_max) and ``jnp.linalg.pinv``'s (ten times it) is dropped, as the
    JAX package drops it."""
    rng = np.random.RandomState(6)
    u, _ = np.linalg.qr(rng.randn(72, 6))
    v, _ = np.linalg.qr(rng.randn(6, 6))
    eps = np.finfo(np.float64).eps
    a = (u * [1.0, 0.5, 0.2, 0.1, 0.05, 5 * 72 * eps]) @ v.T
    want = np.asarray(jiem.jnp.linalg.pinv(jiem.jnp.asarray(a)))
    _close(tiem._pinv(torch.as_tensor(a)).numpy(), want)
    plain = torch.linalg.pinv(torch.as_tensor(a)).numpy()
    assert np.abs(plain - want).max() > 1e10 * np.abs(want).max()


def _iem2d_data():
    """``tests/reconstruct/test_iem.py``'s 2-D data."""
    rng = np.random.RandomState(1)
    n_trials, n_voxels = 60, 20
    centers = rng.rand(n_trials, 2) * 8 + 1
    kw = dict(stim_xlim=[0, 10], stim_ylim=[0, 10], stimulus_resolution=20,
              stim_radius=1.5)
    ref = jiem.InvertedEncoding2D(**kw)
    ref.define_basis_functions_sqgrid(5)
    C = ref._define_trial_activations(centers)
    W = rng.rand(n_voxels, 25)
    X = C @ W.T + 0.1 * rng.randn(n_trials, n_voxels)
    return kw, X, centers


@pytest.mark.parametrize("grid", ["sqgrid", "trigrid"])
def test_iem2d_matches_jax(grid):
    kw, X, centers = _iem2d_data()
    ref = jiem.InvertedEncoding2D(**kw)
    port = tiem.InvertedEncoding2D(device="cpu", **kw)
    if grid == "sqgrid":
        want = ref.define_basis_functions_sqgrid(5)
        got = port.define_basis_functions_sqgrid(5)
    else:
        want = ref.define_basis_functions_trigrid(3)
        got = port.define_basis_functions_trigrid(3)
    for g, w in zip(got, want):
        _close(g, w)
    _close(port._define_trial_activations(centers),
           ref._define_trial_activations(centers))
    ref.fit(X, centers)
    port._fit(X, centers, F64)
    _same_model(port, ref, X, centers)
    conv = convert.iem_from_jax(ref, device="cpu")
    _same_model(conv, ref, X, centers)
    # a target away from every reconstruction: the euclidean formula
    # cancels to rounding noise at a distance near 0
    target = ref.predict_feature_responses(X)[:, :1] + 0.5
    for metric in ("euclidean", "cosine"):
        _close(port.score_against_reconstructed(X, target, metric),
               ref.score_against_reconstructed(X, target, metric))


def test_iem2d_recovers_positions():
    """The JAX test's bars on the port's float32 fit."""
    kw, X, centers = _iem2d_data()
    model = tiem.InvertedEncoding2D(device="cpu", **kw)
    channels, _ = model.define_basis_functions_sqgrid(5)
    assert channels.shape[0] == 25
    model.fit(X, centers)
    err = np.linalg.norm(model.predict(X) - centers, axis=1)
    assert np.median(err) < 2.0
    assert np.mean(model.score(X, centers)) > 0.0
    recon = model.predict_feature_responses(X)
    d = model.score_against_reconstructed(X, recon[:, :1])
    assert d.shape == (X.shape[0],)


@pytest.mark.parametrize("metric,fn", [("euclidean", euclidean_distances),
                                       ("cosine", cosine_distances)])
def test_distances_are_sklearns(metric, fn):
    """The written-out distances against sklearn's, including a zero
    column and a column equal to the target (euclidean clamped at 0,
    cosine clipped to [0, 2])."""
    rng = np.random.RandomState(4)
    y = rng.randn(40, 1)
    yhat = np.column_stack([rng.randn(40, 5), np.zeros(40), y[:, 0],
                            -y[:, 0]])
    ours = {"euclidean": tiem._euclidean_distances,
            "cosine": tiem._cosine_distances}[metric]
    _close(ours(y.T, yhat.T), fn(y.T, yhat.T), 1e-12)
    assert ours(y.T, yhat.T).min() >= 0.0


def test_iem2d_validation():
    model = tiem.InvertedEncoding2D(stim_xlim=[0, 10], stim_ylim=[0, 10],
                                    stimulus_resolution=15, stim_radius=1.0,
                                    device="cpu")
    channels, centers = model.define_basis_functions_trigrid(3)
    assert channels.shape[1] == 15 * 15
    assert centers.shape[1] == 2
    for args in (([10, 0], [0, 10]), (5, [0, 10])):
        with pytest.raises(ValueError) as port_err:
            tiem.InvertedEncoding2D(*args, stimulus_resolution=10,
                                    device="cpu")
        with pytest.raises(ValueError) as jax_err:
            jiem.InvertedEncoding2D(*args, stimulus_resolution=10)
        assert str(port_err.value) == str(jax_err.value)
    m2 = tiem.InvertedEncoding2D(stim_xlim=[0, 10], stim_ylim=[0, 10],
                                 stimulus_resolution=10, device="cpu")
    rng = np.random.RandomState(0)
    with pytest.raises(ValueError, match="Must define channels"):
        m2.fit(rng.rand(20, 5), rng.rand(20, 2))
    m2.define_basis_functions_sqgrid(4)
    with pytest.raises(ValueError, match="No defined stimulus radius"):
        m2._define_trial_activations(rng.rand(5, 2))
    with pytest.raises(ValueError, match="metric"):
        m2.W_ = np.eye(16)[:, :16]
        m2.score_against_reconstructed(rng.rand(2, 16),
                                       np.zeros((100, 1)), "manhattan")
    with pytest.raises(ValueError, match="Defined 16 channels"):
        m2.set_params(channels=np.ones((16, 7)))


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    X, y = make_1d_data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiem.InvertedEncoding1D().fit(X, y)
    kw, X, centers = _iem2d_data()
    model = tiem.InvertedEncoding2D(**kw)
    model.define_basis_functions_sqgrid(5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.fit(X, centers)


# -- hyperparamopt -----------------------------------------------------------

def test_get_sigma_matches_jax():
    x = np.array([1.0, 2.0, 5.0])
    sigma = thpo.get_sigma(x, min_limit=0.0, max_limit=6.0)
    assert np.allclose(sigma, [1.0, 3.0, 3.0])
    assert np.array_equal(sigma, jhpo.get_sigma(x, 0.0, 6.0))
    assert thpo.get_sigma(np.array([1.0]), min_limit=0.0)[0] == 1.0


def test_gmm_pdf_and_samples_match_jax():
    x = np.array([0.2, 0.5, 0.8])
    gmm = thpo.gmm_1d_distribution(x, min_limit=0.0, max_limit=1.0)
    ref = jhpo.gmm_1d_distribution(x, min_limit=0.0, max_limit=1.0)
    grid = np.linspace(-0.1, 1.1, 301)
    assert np.array_equal(gmm(grid), ref(grid))
    assert gmm(0.5) == ref(0.5) > 0 and gmm(-0.1) == 0 and gmm(1.1) == 0
    inside = np.linspace(0, 1, 2000)
    assert np.isclose(np.trapezoid(gmm(inside), inside), gmm.N / gmm.W_sum,
                      atol=0.01)
    np.random.seed(0)
    samples = gmm.get_samples(500)
    np.random.seed(0)
    assert np.array_equal(samples, ref.get_samples(500))
    assert np.all((samples >= 0) & (samples <= 1))


def test_get_next_sample_matches_jax():
    np.random.seed(1)
    x = np.random.rand(40)
    y = (x - 0.3) ** 2
    state = np.random.get_state()
    nxt = thpo.get_next_sample(x, y, min_limit=0.0, max_limit=1.0)
    np.random.set_state(state)
    assert nxt == jhpo.get_next_sample(x, y, min_limit=0.0, max_limit=1.0)
    assert abs(nxt - 0.3) < 0.25


@pytest.mark.parametrize("seeded", [False, True])
def test_fmin_trial_lists_match_jax(seeded):
    """One ``np.random.seed`` gives one trial list in both packages
    (``tests/hyperparamopt/test_hpo.py``'s runs), and the JAX tests'
    bars hold."""
    def run(mod):
        if seeded:
            np.random.seed(3)
            trials = [{'x': v, 'loss': v ** 2}
                      for v in np.linspace(-1, 1, 40)]
            best = mod.fmin(lambda p: p['x'] ** 2,
                            {'x': {'dist': st.uniform(-1, 2), 'lo': -1,
                                   'hi': 1}}, max_evals=10, trials=trials)
        else:
            np.random.seed(2)
            trials = []
            best = mod.fmin(lambda p: (p['x'] - 0.7) ** 2,
                            {'x': {'dist': st.uniform(0, 1), 'lo': 0,
                                   'hi': 1}}, max_evals=60, trials=trials,
                            init_random_evals=15)
        return best, trials

    best, trials = run(thpo)
    ref_best, ref_trials = run(jhpo)
    assert trials == ref_trials
    assert best == ref_best
    if seeded:
        assert abs(best['x']) < 0.2
    else:
        assert len(trials) == 60
        assert abs(best['x'] - 0.7) < 0.1 and best['loss'] < 0.01


def test_fmin_validation():
    with pytest.raises(ValueError, match="Unknown distribution"):
        thpo.fmin(lambda p: p['x'] ** 2, {'x': {'dist': "not-a-dist"}}, 5,
                  [])


def test_fmin_over_an_iem_fit():
    """``fmin`` over the 2-D model's channel size, each loss a port fit
    and a held-out score: the same trial list as the JAX package's
    ``fmin`` over the JAX model."""
    kw, X, centers = _iem2d_data()

    def loss_for(mod, **extra):
        def loss(p):
            model = mod.InvertedEncoding2D(**kw, **extra)
            model.define_basis_functions_sqgrid(5, channel_size=p['fwhm'])
            fit = model._fit if extra else model.fit
            fit(X[:40], centers[:40], *([F64] if extra else []))
            err = np.linalg.norm(model.predict(X[40:]) - centers[40:],
                                 axis=1)
            return float(np.median(err))
        return loss

    space = {'fwhm': {'dist': st.uniform(1.5, 3.0), 'lo': 1.5, 'hi': 4.5}}
    out = []
    for mod, extra in ((thpo, dict(device="cpu")), (jhpo, {})):
        np.random.seed(5)
        trials = []
        mod.fmin(loss_for(tiem if extra else jiem, **extra), dict(space),
                 max_evals=8, trials=trials, init_random_evals=4)
        out.append(trials)
    assert [t['fwhm'] for t in out[0]] == [t['fwhm'] for t in out[1]]
    _close([t['loss'] for t in out[0]], [t['loss'] for t in out[1]])
