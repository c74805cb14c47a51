"""TFA, HTFA and the RBF ops of the port against the JAX package on the
CPU.

``brainiak_tpu_torch.ops.rbf`` and ``factoranalysis`` on
``device="cpu"``, in float64 (the harness turns the JAX package's x64
on), with inputs made by numpy from a seed:

- the RBF ops against the JAX package's: factors within 1e-6 absolute,
  products, residual sums (soft-L1 with masks and pad rows) within
  1e-5 relative; ``rbf_factors`` in float32 at scanner coordinates
  200 mm off the origin within 1e-5 of a float64 broadcast form;
- the NLLS objective and its gradient at the same parameters within
  1e-5 relative of ``jax.grad`` of the JAX package's;
- the port's k-means against sklearn's on well-separated clusters:
  the same centres up to a permutation, within 1e-6;
- the fits, both packages seeded with the same centres (their
  ``init_centers_widths`` patched: the JAX package's k-means is
  sklearn's, the port's its own), drawing the same subsample indices:
  they recover the planted centres to the JAX package's tests'
  tolerances and lie within 0.25 grid units of the JAX package's fit.
  Fits are held to the recovered factors, not to iterates, since the
  JAX package's L-BFGS is optax's and the port's its own;
- HTFA on a 4-position subject mesh of the CPU and on two gloo ranks
  bit for bit the meshless fit;
- validation errors of the JAX package's types and texts.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.factoranalysis import htfa as jhtfa
from brainiak_tpu.factoranalysis import tfa as jtfa
from brainiak_tpu.ops import rbf as jrbf
from brainiak_tpu.utils import utils as jutils
from brainiak_tpu_torch.factoranalysis import HTFA, TFA
from brainiak_tpu_torch.factoranalysis import tfa as ttfa
from brainiak_tpu_torch.factoranalysis._kmeans import kmeans
from brainiak_tpu_torch.ops import rbf
from brainiak_tpu_torch.ops.optimize import _value_and_grad
from brainiak_tpu_torch.parallel import make_mesh
from brainiak_tpu_torch.parallel.testing import run_distributed
from brainiak_tpu_torch.resilience import faults
from brainiak_tpu_torch.utils import utils as tutils
from tests.conftest import REPO_ROOT
from tests.torch_card_workers import (fixed_centers_widths, make_rbf_data,
                                      make_rbf_subjects)
from tests.torch_dist_workers import HTFA_KW

RTOL = 1e-5
#: float32 factors at scanner offsets against float64: eps32 times the
#: squared distances over the widths, about 1e-6 here
OFFSET_ATOL = 1e-5
#: the fits against the JAX package's, in grid units
FIT_ATOL = 0.25


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def same_seeding(monkeypatch):
    """Both packages' TFA / HTFA seeded with the same centres."""
    monkeypatch.setattr(jtfa.TFA, "init_centers_widths",
                        fixed_centers_widths)
    monkeypatch.setattr(TFA, "init_centers_widths", fixed_centers_widths)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rbf_inputs(seed, v=300, k=4, t=7, offset=0.0):
    rng = np.random.RandomState(seed)
    R = rng.rand(v, 3) * 20 + offset
    centers = rng.rand(k, 3) * 20 + offset
    widths = rng.rand(k, 1) * 20 + 5
    X = rng.randn(v, t)
    W = rng.randn(k, t)
    return R, centers, widths, X, W


def _sorted_centers(model, est):
    c = model.get_centers(est)
    return c[np.argsort(c[:, 0])]


# -- packing helpers and the RBF ops ---------------------------------------

def test_packing_helpers_match_jax():
    sym = np.arange(16.0).reshape(4, 4)
    sym = sym + sym.T
    tri = tutils.from_sym_2_tri(sym)
    np.testing.assert_array_equal(tri, jutils.from_sym_2_tri(sym))
    np.testing.assert_array_equal(tutils.from_tri_2_sym(tri, 4),
                                  jutils.from_tri_2_sym(tri, 4))


@pytest.mark.parametrize("width_shape", [(-1,), (-1, 1)])
def test_rbf_factors_match_jax(width_shape):
    R, centers, widths, _, _ = _rbf_inputs(0)
    widths = widths.reshape(width_shape)
    got = rbf.rbf_factors(_t(R), _t(centers), _t(widths)).numpy()
    want = np.asarray(jrbf.rbf_factors(jnp.asarray(R), jnp.asarray(centers),
                                       jnp.asarray(widths)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_rbf_factors_float32_at_scanner_offsets():
    """float32 coordinates 200 mm off the origin: the centring keeps
    the factors within ``OFFSET_ATOL`` of a float64 broadcast form on
    the same float32 inputs (float32's own rounding of distances of a
    few hundred mm²); without it ``||R||² - 2R·c`` cancels, over ten
    times further off."""
    R, centers, widths = (a.astype(np.float32).astype(np.float64) for a
                          in _rbf_inputs(1, offset=200.0)[:3])
    ref = np.exp(-((R[:, None, :] - centers[None]) ** 2).sum(-1)
                 / widths.T)
    r32, c32, w32 = (torch.as_tensor(a, dtype=torch.float32)
                     for a in (R, centers, widths))
    got = rbf.rbf_factors(r32, c32, w32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=OFFSET_ATOL)
    assert got.max() <= 1.0
    # what the centring guards against: the same expansion uncentred
    sq = ((r32 * r32).sum(1)[:, None] - 2.0 * r32 @ c32.T
          + (c32 * c32).sum(1)[None, :])
    naive = torch.exp(-torch.clamp(sq, min=0.0) / w32.T).numpy()
    assert np.abs(naive - ref).max() > 10 * OFFSET_ATOL


@pytest.mark.parametrize("chunk", [1024, 64, 7])
def test_rbf_weight_products_match_jax(chunk):
    R, centers, widths, X, _ = _rbf_inputs(2)
    vmask = (np.arange(R.shape[0]) % 5 != 0).astype(float)
    for vm in (None, vmask):
        got = rbf.rbf_weight_products(
            _t(R), _t(centers), _t(widths), _t(X),
            vmask=None if vm is None else _t(vm), chunk=chunk)
        want = jrbf.rbf_weight_products(
            jnp.asarray(R), jnp.asarray(centers), jnp.asarray(widths),
            jnp.asarray(X), vmask=None if vm is None else jnp.asarray(vm),
            chunk=chunk)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


@pytest.mark.parametrize("loss", ["linear", "soft_l1"])
@pytest.mark.parametrize("masked", [False, True])
def test_rbf_residual_sum_matches_jax(loss, masked):
    R, centers, widths, X, W = _rbf_inputs(3)
    kw, jkw = {}, {}
    if masked:
        vmask = (np.arange(R.shape[0]) % 3 != 0).astype(float)
        tmask = (np.arange(X.shape[1]) < 5).astype(float)
        kw = dict(vmask=_t(vmask), tmask=_t(tmask))
        jkw = dict(vmask=jnp.asarray(vmask), tmask=jnp.asarray(tmask))
    got = rbf.rbf_residual_sum(_t(R), _t(centers), _t(widths), _t(X),
                               _t(W), 0.7, nlss_loss=loss, chunk=64, **kw)
    want = jrbf.rbf_residual_sum(
        jnp.asarray(R), jnp.asarray(centers), jnp.asarray(widths),
        jnp.asarray(X), jnp.asarray(W), 0.7, nlss_loss=loss, chunk=64,
        **jkw)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("loss", ["linear", "soft_l1"])
def test_pad_rows_stay_inert(loss):
    """Rows masked out (as the chunk pad is) add exactly nothing, under
    soft-L1 too: the residual sum of the data with masked rows
    appended equals that of the data alone."""
    R, centers, widths, X, W = _rbf_inputs(4, v=100)
    extra = np.random.RandomState(5).randn(28, X.shape[1])
    R2 = np.concatenate([R, R[:28]])
    X2 = np.concatenate([X, extra])
    vmask = np.r_[np.ones(100), np.zeros(28)]
    whole = rbf.rbf_residual_sum(_t(R), _t(centers), _t(widths), _t(X),
                                 _t(W), 1.3, nlss_loss=loss, chunk=100)
    padded = rbf.rbf_residual_sum(_t(R2), _t(centers), _t(widths),
                                  _t(X2), _t(W), 1.3, vmask=_t(vmask),
                                  nlss_loss=loss, chunk=100)
    assert float(padded) == float(whole)


def test_reconstruction_residual_matches_jax():
    R, centers, widths, X, W = _rbf_inputs(6)
    F = np.asarray(jrbf.rbf_factors(jnp.asarray(R), jnp.asarray(centers),
                                    jnp.asarray(widths)))
    got = rbf.reconstruction_residual(_t(X), _t(F), _t(W), 0.5).numpy()
    want = np.asarray(jrbf.reconstruction_residual(
        jnp.asarray(X), jnp.asarray(F), jnp.asarray(W), 0.5))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _jax_objective(params, R, X, W, sigma, scaling, tmpl, K, n_dim, loss,
                   has_template):
    """The JAX package's NLLS objective (the closure of
    ``tfa._fit_centers_widths``) on its own ops."""
    centers = params[:K * n_dim].reshape(K, n_dim)
    widths = params[K * n_dim:]
    total = jrbf.rbf_residual_sum(R, centers, widths, X, W, sigma,
                                  nlss_loss=loss)
    if has_template:
        tc, cov_inv, tw, reci = tmpl
        diff = centers - tc
        maha = jnp.einsum('kd,kde,ke->k', diff, cov_inv, diff)
        total = total + jtfa._rho_sum(scaling * maha, loss)
        wdist = scaling * reci.reshape(-1) * (widths - tw.reshape(-1)) ** 2
        total = total + jtfa._rho_sum(wdist, loss)
    return 0.5 * total


@pytest.mark.parametrize("loss", ["linear", "soft_l1"])
@pytest.mark.parametrize("has_template", [False, True])
def test_objective_and_gradient_match_jax(loss, has_template):
    K, n_dim = 4, 3
    R, centers, widths, X, W = _rbf_inputs(7, k=K)
    rng = np.random.RandomState(8)
    params = np.concatenate([centers.ravel() + rng.randn(K * n_dim),
                             widths.ravel() * 1.3])
    a = rng.randn(K, n_dim, n_dim)
    tmpl = (centers + 0.5, a @ a.transpose(0, 2, 1) + np.eye(n_dim),
            widths * 0.8, np.full((K, 1), 0.05))
    got_v, got_g = _value_and_grad(
        lambda p: ttfa._nlls_objective(
            p, _t(R), _t(X), _t(W), 0.9, 0.3, *(_t(t) for t in tmpl),
            K=K, n_dim=n_dim, nlss_loss=loss, has_template=has_template),
        _t(params))
    want_v, want_g = jax.value_and_grad(
        lambda p: _jax_objective(p, *(jnp.asarray(a) for a in (R, X, W)),
                                 0.9, 0.3,
                                 tuple(jnp.asarray(t) for t in tmpl), K,
                                 n_dim, loss, has_template))(
        jnp.asarray(params))
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=RTOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               rtol=RTOL, atol=RTOL * np.abs(want_g).max())


# -- k-means ---------------------------------------------------------------

def test_kmeans_matches_sklearn_on_separated_clusters():
    from sklearn.cluster import KMeans

    rng = np.random.RandomState(0)
    means = np.array([[0.0, 0.0, 0.0], [30.0, 0.0, 0.0], [0.0, 30.0, 0.0],
                      [0.0, 0.0, 30.0], [30.0, 30.0, 30.0]]) + 150.0
    X = np.concatenate([m + rng.randn(40, 3) for m in means])
    got, inertia = kmeans(X, 5, n_init=10, random_state=100)
    km = KMeans(init='k-means++', n_clusters=5, n_init=10,
                random_state=100).fit(X)
    want = km.cluster_centers_
    order = np.argsort(got @ [1.0, 100.0, 1e4])
    order_w = np.argsort(want @ [1.0, 100.0, 1e4])
    np.testing.assert_allclose(got[order], want[order_w], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(inertia, km.inertia_, rtol=1e-9)


# -- TFA -------------------------------------------------------------------

def _tfa_pair(**kw):
    return TFA(device="cpu", **kw), jtfa.TFA(**kw)


def test_tfa_subsample_indices_equal(monkeypatch, same_seeding):
    """Both packages draw the same voxels and TRs (the host draws of
    ``np.random.RandomState(seed).choice``, kept verbatim)."""
    X, R, _, _ = make_rbf_data()
    seen = {}
    for cls, key in ((TFA, "port"), (jtfa.TFA, "jax")):
        def spy(self, r, x, w, centers, widths, *args, _key=key,
                **kwargs):
            # records the draw and keeps the prior: the draws alone
            # are compared, so neither package's NLLS needs to run
            seen.setdefault(_key, []).append((np.array(r), np.array(x)))
            return np.hstack((centers.ravel(), widths.ravel())), 0.0

        monkeypatch.setattr(cls, "_estimate_centers_widths", spy)
    # a negative threshold: the kept prior never reads as converged
    kw = dict(K=2, max_iter=2, threshold=-1.0, max_num_voxel=200,
              max_num_tr=30, seed=3)
    for model in _tfa_pair(**kw):
        model.fit(X, R)
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for (pr, px), (jr, jx) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(pr, jr)
        np.testing.assert_array_equal(px, jx)


@pytest.mark.parametrize("case", ["full", "subsampled", "ols"])
def test_tfa_recovers_centers_and_matches_jax(same_seeding, case):
    kw = {"full": dict(K=2, max_iter=8, threshold=0.1, max_num_voxel=512,
                       max_num_tr=60),
          "subsampled": dict(K=2, max_iter=10, threshold=0.5,
                             max_num_voxel=200, max_num_tr=30, seed=7),
          "ols": dict(K=2, max_iter=2, threshold=5.0, weight_method="ols",
                      max_num_voxel=200, max_num_tr=30)}[case]
    X, R, true_centers, true_widths = make_rbf_data(
        noise=0.02 if case == "subsampled" else 0.05)
    port, ref = _tfa_pair(**kw)
    port.fit(X, R)
    ref.fit(X, R)
    est = _sorted_centers(port, port.local_posterior_)
    truth = true_centers[np.argsort(true_centers[:, 0])]
    atol = {"full": 0.5, "subsampled": 1.0, "ols": 1.5}[case]
    np.testing.assert_allclose(est, truth, atol=atol)
    if case == "full":
        w = port.get_widths(port.local_posterior_)[
            np.argsort(port.get_centers(port.local_posterior_)[:, 0])]
        np.testing.assert_allclose(
            w, true_widths[np.argsort(true_centers[:, 0])], atol=1.5)
    np.testing.assert_allclose(est, _sorted_centers(ref,
                                                    ref.local_posterior_),
                               atol=FIT_ATOL)
    assert port.F_.shape == (X.shape[0], 2)
    assert port.W_.shape == (2, X.shape[1])
    assert np.all(np.isfinite(port.W_))
    assert port.F_.dtype == np.float64


def test_tfa_with_template_prior_matches_jax(same_seeding):
    X, R, _, _ = make_rbf_data()
    models = []
    for cls, extra in ((TFA, {"device": "cpu"}), (jtfa.TFA, {})):
        tfa = cls(K=2, max_iter=3, threshold=0.5, max_num_voxel=256,
                  max_num_tr=40, **extra)
        tfa.n_dim = 3
        tfa.cov_vec_size = 6
        tfa.get_map_offset()
        template_prior, _, _ = tfa.get_template(R)
        tfa2 = cls(K=2, max_iter=3, threshold=0.5, max_num_voxel=256,
                   max_num_tr=40, nlss_loss='soft_l1', **extra)
        tfa2.fit(X, R, template_prior=template_prior)
        assert tfa2.local_posterior_.shape == (2 * 4,)
        # the template path sets no F_ / W_ (reference tfa.py:1017-1023)
        assert not hasattr(tfa2, "F_")
        models.append(tfa2)
    np.testing.assert_allclose(
        _sorted_centers(models[0], models[0].local_posterior_),
        _sorted_centers(models[1], models[1].local_posterior_),
        atol=FIT_ATOL)


def test_tfa_fits_in_float32(same_seeding):
    X, R, true_centers, _ = make_rbf_data()
    port = TFA(K=2, max_iter=2, threshold=0.1, max_num_voxel=512,
               max_num_tr=60, device="cpu").fit(X.astype(np.float32), R)
    assert port.F_.dtype == np.float32 and port.W_.dtype == np.float32
    np.testing.assert_allclose(
        _sorted_centers(port, port.local_posterior_),
        true_centers[np.argsort(true_centers[:, 0])], atol=0.5)


@pytest.mark.parametrize("method", ["rr", "ols"])
def test_weight_solves_match_jax(method):
    X, R, centers, widths = make_rbf_data()
    F = np.asarray(jrbf.rbf_factors(jnp.asarray(R), jnp.asarray(centers),
                                    jnp.asarray(widths)))
    ref = np.asarray(jtfa._solve_weights(jnp.asarray(X), jnp.asarray(F),
                                         method))
    got = ttfa._solve_weights(_t(X), _t(F), method).numpy()
    fused = ttfa._solve_weights_fused(_t(X), _t(R), _t(centers),
                                      _t(widths), method, chunk=100).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(fused, ref, rtol=RTOL, atol=1e-6)


def _errors(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("bad", ["list", "1d_R", "short_X", "method"])
def test_tfa_input_validation_matches_jax(bad):
    X, R, _, _ = make_rbf_data()
    args = {"list": (list(X), R), "1d_R": (X, R[:, 0]),
            "short_X": (X[:-5], R), "method": (X, R)}[bad]
    kw = {"weight_method": "lasso"} if bad == "method" else {}
    got = _errors(lambda: TFA(K=2, device="cpu", **kw).fit(*args))
    want = _errors(lambda: jtfa.TFA(K=2, **kw).fit(*args))
    assert got is not None and got == want


def test_tfa_reference_calling_conventions(caplog):
    X, R, centers, widths = make_rbf_data()
    tfa = TFA(K=1, device="cpu").set_K(2).set_seed(7).set_prior(None)
    assert tfa.K == 2 and tfa.seed == 7 and tfa.local_prior is None
    tfa.n_dim = R.shape[1]
    unique_R, inds = tfa.get_unique_R(R)
    assert len(unique_R) == 3 and len(inds) == 3
    recon = np.stack([u[i] for u, i in zip(unique_R, inds)], axis=1)
    np.testing.assert_array_equal(recon, R)
    F = tfa.get_factors(unique_R, inds, centers, widths)
    expected = np.exp(-((R[:, None, :] - centers[None]) ** 2).sum(-1)
                      / widths.T)
    np.testing.assert_allclose(F, expected, atol=1e-6)
    with caplog.at_level(logging.INFO,
                         logger="brainiak_tpu_torch.factoranalysis.tfa"):
        TFA(K=2, max_iter=2, threshold=0.1, max_num_voxel=256,
            max_num_tr=40, verbose=True, device="cpu").fit(X, R)
    assert any("max diff" in r.message and "mse" in r.message
               for r in caplog.records)


def test_map_offset_and_packing():
    tfa = TFA(K=3, device="cpu")
    tfa.n_dim = 3
    tfa.cov_vec_size = 6
    assert list(tfa.get_map_offset()) == [0, 9, 12, 30]
    est = np.zeros(3 * (3 + 2 + 6))
    centers = np.arange(9.0).reshape(3, 3)
    tfa.set_centers(est, centers)
    assert np.allclose(tfa.get_centers(est), centers)
    widths = np.array([[1.0], [2.0], [3.0]])
    tfa.set_widths(est, widths)
    assert np.allclose(tfa.get_widths(est), widths)


def test_get_params_and_set_params():
    tfa = TFA(K=3, max_iter=4, device="cpu")
    params = tfa.get_params()
    assert params["K"] == 3 and params["max_iter"] == 4
    assert params["device"] == "cpu"
    assert tfa.set_params(max_iter=7, K=5) is tfa
    assert tfa.miter == 7 and tfa.K == 5
    with pytest.raises(ValueError, match="invalid parameter"):
        tfa.set_params(bogus=1)
    htfa = HTFA(K=2, n_subj=3, device="cpu")
    assert htfa.get_params()["n_subj"] == 3
    assert htfa.get_params()["mesh"] is None


def test_tfa_checkpoint_resume_bit_for_bit(tmp_path, same_seeding):
    X, R, _, _ = make_rbf_data()
    kw = dict(K=2, max_iter=4, threshold=0.0, max_num_voxel=200,
              max_num_tr=30, seed=5, device="cpu")
    full = TFA(**kw).fit(X, R)
    ckpt = str(tmp_path / "ck")
    with pytest.raises(faults.PreemptionError):
        with faults.inject("preempt", at_step=2):
            TFA(**kw).fit(X, R, checkpoint_dir=ckpt, checkpoint_every=1)
    resumed = TFA(**kw).fit(X, R, checkpoint_dir=ckpt, checkpoint_every=1)
    np.testing.assert_array_equal(resumed.local_posterior_,
                                  full.local_posterior_)
    np.testing.assert_array_equal(resumed.W_, full.W_)


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    X, R, _, _ = make_rbf_data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFA(K=2).fit(X, R)
    Xs, Rs, _, _ = make_rbf_subjects(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HTFA(K=2, n_subj=2).fit(Xs, Rs)


# -- HTFA ------------------------------------------------------------------

def test_htfa_subsample_draws_equal_jax(same_seeding):
    """A subject's subsample of the port (its own draw) is the unpadded
    part of the JAX package's batched draw."""
    X, R, _, _ = make_rbf_subjects(3)
    X = [X[0], X[1][:-37], X[2][:-101]]
    R = [R[0], R[1][:-37], R[2][:-101]]
    kw = dict(K=2, n_subj=3, voxel_ratio=0.5, tr_ratio=0.5, max_voxel=200,
              max_tr=60)
    port = HTFA(device="cpu", **kw)
    ref = jhtfa.HTFA(**kw)
    for m in (port, ref):
        m.n_dim = 3
        m._prepare_subject_batch([x.shape for x in X], R)
    rngs = [np.random.RandomState(4) for _ in range(3)]
    bdata, bR, vmask, tmask, beta, sigma = ref._gather_subsample_batch(
        X, R, rngs, [0, 1, 2])
    for s in range(3):
        curr, curr_R, b, sg = port._gather_subsample(
            X[s], R[s], np.random.RandomState(4), s)
        nv, nt = curr.shape
        assert vmask[s].sum() == nv and tmask[s].sum() == nt
        np.testing.assert_array_equal(curr, bdata[s, :nv, :nt])
        np.testing.assert_array_equal(curr_R, bR[s, :nv])
        assert b == beta[s] and sg == sigma[s]


@pytest.fixture(scope="module")
def jax_htfa():
    """The JAX package's HTFA fit at ``HTFA_KW``, seeded with the fixed
    centres (shared by the tests that hold the port to it)."""
    X, R, _, _ = make_rbf_subjects(HTFA_KW["n_subj"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtfa.TFA, "init_centers_widths", fixed_centers_widths)
        np.random.seed(0)
        return jhtfa.HTFA(**HTFA_KW).fit(X, R)


def test_htfa_recovers_template_and_matches_jax(same_seeding, jax_htfa):
    X, R, true_centers, _ = make_rbf_subjects(HTFA_KW["n_subj"])
    np.random.seed(0)
    port = HTFA(device="cpu", **HTFA_KW).fit(X, R)
    ref = jax_htfa
    assert port.global_posterior_.shape[0] == 2 * (3 + 2 + 6)
    est = _sorted_centers(port, port.global_posterior_)
    np.testing.assert_allclose(
        est, true_centers[np.argsort(true_centers[:, 0])], atol=1.0)
    np.testing.assert_allclose(
        est, _sorted_centers(ref, ref.global_posterior_), atol=FIT_ATOL)
    assert port.local_posterior_.shape == (3 * 2 * 4,)
    np.testing.assert_allclose(port.local_posterior_,
                               ref.local_posterior_, atol=FIT_ATOL)
    assert port.local_weights_.shape == (3 * 2 * X[0].shape[1],)
    assert np.all(np.isfinite(port.local_weights_))


@pytest.mark.parametrize("n_subj,positions,trim", [(4, 4, False),
                                                   (3, 2, True)])
def test_htfa_mesh_bit_for_bit_meshless(same_seeding, n_subj, positions,
                                        trim):
    """A subject mesh of CPU positions (3 subjects on 2: padded, the pad
    dropped; ragged subjects) fits bit for bit as without a mesh."""
    X, R, _, _ = make_rbf_subjects(n_subj)
    if trim:
        X = [X[0], X[1][:-37], X[2][:-101]]
        R = [R[0], R[1][:-37], R[2][:-101]]
    kw = dict(K=2, n_subj=n_subj, max_global_iter=2, max_local_iter=1,
              threshold=0.5, voxel_ratio=0.5 if trim else 1.0,
              tr_ratio=1.0, max_voxel=200 if trim else 512, max_tr=60,
              lbfgs_iters=10, device="cpu")
    np.random.seed(1)
    single = HTFA(**kw).fit(X, R)
    np.random.seed(1)
    mesh = make_mesh(("subject",), (positions,),
                     devices=["cpu"] * positions)
    sharded = HTFA(mesh=mesh, **kw).fit(X, R)
    for attr in ("global_posterior_", "local_posterior_",
                 "local_weights_"):
        np.testing.assert_array_equal(getattr(sharded, attr),
                                      getattr(single, attr))


def test_htfa_across_two_ranks(jax_htfa):
    """Two gloo ranks of two CPU positions each, 3 subjects: each rank's
    fit bit for bit the other's and the meshless one, and within
    ``FIT_ATOL`` of the JAX package's fit."""
    ranks = run_distributed("tests.torch_dist_workers", "htfa_worker",
                            n_procs=2, local_devices=2, timeout=120,
                            extra_path=REPO_ROOT)
    ref = jax_htfa
    for r in ranks:
        for got, want, base in zip(r["mesh"], r["single"],
                                   ranks[0]["single"]):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(want, base)
    glob, local, _ = ranks[0]["mesh"]
    np.testing.assert_allclose(glob[:8], ref.global_posterior_[:8],
                               atol=FIT_ATOL)
    np.testing.assert_allclose(local, ref.local_posterior_, atol=FIT_ATOL)


@pytest.mark.parametrize("bad", ["not_list", "short_R", "ragged",
                                 "flat_R", "method", "mesh_axis"])
def test_htfa_input_validation_matches_jax(bad):
    X, R, _, _ = make_rbf_subjects(2)
    args = {"not_list": (X[0], R), "short_R": (X, R[:1]),
            "ragged": ([X[0], X[1][:-3]], R),
            "flat_R": (X, [R[0], R[1].ravel()]),
            "method": (X, R), "mesh_axis": (X, R)}[bad]
    kw, jkw = {}, {}
    if bad == "method":
        kw = jkw = {"weight_method": "bogus"}
    if bad == "mesh_axis":
        kw = {"mesh": make_mesh(("wrong",), (1,), devices=["cpu"])}
        jkw = {"mesh": jax.sharding.Mesh(np.array(jax.devices()[:1]),
                                         ("wrong",))}
    got = _errors(lambda: HTFA(K=2, n_subj=2, device="cpu", **kw)
                  .fit(*args))
    want = _errors(lambda: jhtfa.HTFA(K=2, n_subj=2, **jkw).fit(*args))
    assert got is not None
    if bad == "mesh_axis":
        # the mesh's repr differs between the packages
        assert got[0] is want[0] is ValueError
        assert got[1].split(" but ")[0] == want[1].split(" but ")[0]
    else:
        assert got == want


def test_htfa_refuses_a_subject_store():
    class Store:
        def read(self, s):
            return None
        voxel_counts = (10,)
        digests = ("x",)

    with pytest.raises(NotImplementedError, match="SubjectStore"):
        HTFA(K=2, n_subj=1, device="cpu").fit(Store(), [np.zeros((10, 3))])


def test_htfa_verbose_logging_and_resume(caplog, tmp_path, same_seeding):
    X, R, _, _ = make_rbf_subjects(2)
    kw = dict(K=2, n_subj=2, max_global_iter=2, max_local_iter=1,
              threshold=1e-6, max_voxel=64, max_tr=20, lbfgs_iters=10,
              device="cpu")
    with caplog.at_level(logging.INFO,
                         logger="brainiak_tpu_torch.factoranalysis.htfa"):
        np.random.seed(0)
        full = HTFA(verbose=True, **kw).fit(X, R)
    assert any("global iter" in r.message for r in caplog.records)
    ck = str(tmp_path / "ck")
    np.random.seed(0)
    with pytest.raises(faults.PreemptionError):
        with faults.inject("preempt", at_step=1):
            HTFA(**kw).fit(X, R, checkpoint_dir=ck, checkpoint_every=1)
    np.random.seed(1)  # the resume restores the template: the draw is moot
    resumed = HTFA(**kw).fit(X, R, checkpoint_dir=ck, checkpoint_every=1)
    np.testing.assert_array_equal(resumed.global_posterior_,
                                  full.global_posterior_)
