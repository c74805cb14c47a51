"""The port's encoding tier against the JAX package on the CPU.

``brainiak_tpu_torch.encoding`` on ``device="cpu"`` against
``brainiak_tpu.encoding`` on the same float32 data (both packages cast
the design and the responses to float32), made by numpy from a seed
(``tests/encoding/test_ridge.py``'s recipe): ``W_`` within 1e-4 of
max|W|, ``cv_scores_`` within 1e-4, ``lambda_`` equal, with and without
the intercept, standardized, on a rank-deficient design, in lambda
blocks, banded.  The Gram on the SUMMA ring of a 4-position CPU mesh
(the JAX package's own ring moves under jax 0.9.0, so the meshed port
is held to the JAX package's meshless fit), and on a mesh of two gloo
ranks against the meshless fit within 1e-5.  Checkpoint resume, grid
rejection, validation errors of the JAX package's types and texts, and
the ``encoding.fit`` / ``encoding.sweep_chunk`` spans.
"""

import numpy as np
import pytest
import torch

from brainiak_tpu.encoding import BandedRidgeEncoder as JBanded
from brainiak_tpu.encoding import RidgeEncoder as JRidge
from brainiak_tpu.obs import sink as jsink
from brainiak_tpu_torch.encoding import (DEFAULT_LAMBDAS, BandedRidgeEncoder,
                                         RidgeEncoder)
from brainiak_tpu_torch.obs import sink as tsink
from brainiak_tpu_torch.ops import distla
from brainiak_tpu_torch.parallel import make_mesh
from brainiak_tpu_torch.parallel.testing import run_distributed
from brainiak_tpu_torch.resilience import faults
from tests.conftest import REPO_ROOT
from tests.torch_dist_workers import make_ridge_data
from torch_obs_state import clean_obs, span_tree  # noqa: F401

RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(t, f, v, seed=0, noise=0.5):
    return make_ridge_data(t, f, v, seed=seed, noise=noise)


def _same_fit(port, ref, lambda_equal=1.0):
    np.testing.assert_allclose(port.cv_scores_, ref.cv_scores_, rtol=0,
                               atol=RTOL)
    same = np.all(port.lambda_ == ref.lambda_, axis=tuple(
        range(1, np.ndim(ref.lambda_))))
    assert same.mean() >= lambda_equal
    w, w_ref = port.W_[:, same], ref.W_[:, same]
    np.testing.assert_allclose(w, w_ref, rtol=0,
                               atol=RTOL * np.abs(ref.W_).max())
    for attr in ("x_mean_", "x_scale_", "y_mean_", "lambdas_"):
        np.testing.assert_allclose(getattr(port, attr), getattr(ref, attr),
                                   rtol=1e-6)


def _standardize_data():
    rng = np.random.RandomState(2)
    x = (rng.randn(60, 8) * rng.gamma(2.0, 2.0, 8)).astype(np.float32)
    return x, _data(60, 8, 10, seed=2)[1]


CASES = {
    "sweep": (lambda: _data(200, 64, 512),
              dict(lambdas=tuple(np.logspace(1, 3, 10)), n_folds=5)),
    "no_intercept": (lambda: _data(48, 12, 20, seed=1),
                     dict(lambdas=(1.0, 10.0, 100.0), n_folds=3,
                          fit_intercept=False)),
    "standardize": (_standardize_data,
                    dict(lambdas=(1.0, 10.0), n_folds=3, standardize=True)),
    "rank_deficient": (lambda: _data(30, 64, 12, seed=3),
                       dict(lambdas=(10.0, 100.0), n_folds=3)),
    "lambda_block": (lambda: _data(40, 8, 12, seed=4),
                     dict(lambdas=(0.5, 5.0, 50.0, 500.0, 5000.0),
                          n_folds=4, lambda_block=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ridge_matches_jax(case):
    make, kw = CASES[case]
    x, y = make()
    port = RidgeEncoder(device="cpu", **kw).fit(x, y)
    ref = JRidge(**kw).fit(x, y)
    _same_fit(port, ref)
    assert port.W_.shape == (x.shape[1], y.shape[1])
    assert port.W_.dtype == np.float32
    np.testing.assert_allclose(port.predict(x), ref.predict(x), rtol=0,
                               atol=RTOL * np.abs(ref.predict(x)).max())
    np.testing.assert_allclose(port.score(x, y), ref.score(x, y), rtol=0,
                               atol=RTOL)


def test_default_grid_and_standardize_scale():
    assert DEFAULT_LAMBDAS == (0.01, 0.1, 1.0, 10.0, 100.0, 1000.0,
                               10000.0)
    x, y = _standardize_data()
    enc = RidgeEncoder(lambdas=(1.0, 10.0), n_folds=3, standardize=True,
                       device="cpu").fit(x, y)
    assert enc.x_scale_.shape == (8,)
    assert not np.allclose(enc.x_scale_, 1.0)
    assert enc.score(x, y).mean() > 0.5


def test_lambda_block_chunking_is_exact():
    x, y = _data(40, 8, 12, seed=4)
    lams = (0.5, 5.0, 50.0, 500.0, 5000.0)
    ref = RidgeEncoder(lambdas=lams, n_folds=4, device="cpu").fit(x, y)
    blocked = RidgeEncoder(lambdas=lams, n_folds=4, lambda_block=2,
                           device="cpu").fit(x, y)
    np.testing.assert_allclose(blocked.cv_scores_, ref.cv_scores_,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(blocked.lambda_, ref.lambda_)


def test_checkpoint_preempt_resume_parity(tmp_path):
    x, y = _data(40, 8, 12, seed=5)
    kw = dict(lambdas=(0.5, 5.0, 50.0, 500.0), n_folds=4, lambda_block=1,
              device="cpu")
    ref = RidgeEncoder(**kw).fit(x, y)
    ckpt = str(tmp_path / "ck")
    with pytest.raises(faults.PreemptionError):
        with faults.inject("preempt", at_step=2):
            RidgeEncoder(**kw).fit(x, y, checkpoint_dir=ckpt)
    enc = RidgeEncoder(**kw).fit(x, y, checkpoint_dir=ckpt)
    np.testing.assert_array_equal(enc.cv_scores_, ref.cv_scores_)
    np.testing.assert_array_equal(enc.W_, ref.W_)


@pytest.mark.parametrize("changed", [
    dict(lambdas=(1.0, 10.0, 100.0, 1000.0), lambda_block=1),
    dict(lambdas=(0.5, 5.0, 50.0, 500.0), lambda_block=2)])
def test_checkpoint_rejects_different_grid_or_block(tmp_path, changed):
    x, y = _data(40, 8, 12, seed=6)
    ckpt = str(tmp_path / "ck")
    with pytest.raises(faults.PreemptionError):
        with faults.inject("preempt", at_step=1):
            RidgeEncoder(lambdas=(0.5, 5.0, 50.0, 500.0), n_folds=4,
                         lambda_block=1, device="cpu").fit(
                             x, y, checkpoint_dir=ckpt)
    with pytest.raises(ValueError, match="different data"):
        RidgeEncoder(n_folds=4, device="cpu", **changed).fit(
            x, y, checkpoint_dir=ckpt)


def test_banded_single_band_matches_plain_ridge():
    x, y = _data(48, 10, 14, seed=7)
    lams = (1.0, 10.0, 100.0)
    plain = RidgeEncoder(lambdas=lams, n_folds=3, device="cpu").fit(x, y)
    banded = BandedRidgeEncoder(np.zeros(10, np.int32), lambdas=lams,
                                n_folds=3, candidate_block=3,
                                device="cpu").fit(x, y)
    np.testing.assert_allclose(banded.cv_scores_, plain.cv_scores_,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(banded.W_, plain.W_, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(banded.lambda_[:, 0], plain.lambda_)


def _two_band_data():
    rng = np.random.RandomState(8)
    t, v = 80, 24
    x_sig = rng.randn(t, 6).astype(np.float32)
    x_noise = rng.randn(t, 6).astype(np.float32)
    x = np.concatenate([x_sig, x_noise], axis=1)
    w = (rng.randn(6, v) / np.sqrt(6)).astype(np.float32)
    y = (x_sig @ w + 0.3 * rng.randn(t, v)).astype(np.float32)
    return x, y, np.repeat(np.arange(2), 6)


@pytest.mark.parametrize("block", [4, 5])
def test_banded_matches_jax(block):
    """Two bands, the second pure noise (an uneven last block at 5):
    the port's fit is the JAX package's, and it regularizes the noise
    band at least as hard as the signal band."""
    x, y, bands = _two_band_data()
    kw = dict(lambdas=(0.1, 10.0, 1000.0), n_folds=4,
              candidate_block=block)
    port = BandedRidgeEncoder(bands, device="cpu", **kw).fit(x, y)
    ref = JBanded(bands, **kw).fit(x, y)
    assert port.lambda_.shape == (24, 2)
    np.testing.assert_array_equal(port.candidates_, ref.candidates_)
    _same_fit(port, ref)
    assert np.median(port.lambda_[:, 1]) >= np.median(port.lambda_[:, 0])


def _errors(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is compared
        return type(e), str(e)
    return None


BANDED_BAD = {
    "candidates": (np.zeros(4, np.int32), dict(candidates=np.ones((3, 2))),
                   (30, 4, 6)),
    "max_candidates": (np.repeat(np.arange(4), 2),
                       dict(lambdas=tuple(float(i + 1) for i in range(10)),
                            max_candidates=100), (30, 8, 6)),
    "bands_length": (np.zeros(5, np.int32), {}, (30, 4, 6)),
    "dense": (np.array([0, 0, 5, 5]), dict(lambdas=(1.0, 10.0)),
              (30, 4, 6)),
    "negative": (np.array([0, -1, 0, 0]), {}, (30, 4, 6)),
    "nonpositive": (np.zeros(4, np.int32),
                    dict(candidates=np.zeros((2, 1))), (30, 4, 6)),
}


@pytest.mark.parametrize("case", sorted(BANDED_BAD))
def test_banded_validation_matches_jax(case):
    bands, kw, shape = BANDED_BAD[case]
    x, y = _data(*shape)
    got = _errors(lambda: BandedRidgeEncoder(bands, device="cpu", **kw)
                  .fit(x, y))
    want = _errors(lambda: JBanded(bands, **kw).fit(x, y))
    assert got is not None and got == want


RIDGE_BAD = {
    "nan": (lambda x, y: (np.full_like(x, np.nan), y), {}),
    "matching_t": (lambda x, y: (x, y[:-1]), {}),
    "negative_lambda": (lambda x, y: (x, y), dict(lambdas=(1.0, -2.0))),
    "empty_grid": (lambda x, y: (x, y), dict(lambdas=())),
    "too_many_folds": (lambda x, y: (x, y), dict(n_folds=40)),
    "one_fold": (lambda x, y: (x, y), dict(n_folds=1)),
    "one_d": (lambda x, y: (x[:, 0], y), {}),
}


@pytest.mark.parametrize("case", sorted(RIDGE_BAD))
def test_ridge_validation_matches_jax(case):
    make, kw = RIDGE_BAD[case]
    args = make(*_data(30, 4, 6))
    got = _errors(lambda: RidgeEncoder(device="cpu", **kw).fit(*args))
    want = _errors(lambda: JRidge(**kw).fit(*args))
    assert got is not None and got == want


def test_predict_validation_matches_jax():
    x, y = _data(30, 4, 6)
    for make in (lambda: RidgeEncoder(device="cpu"), JRidge):
        with pytest.raises(ValueError, match="not fitted"):
            make().predict(x)
    port = RidgeEncoder(lambdas=(1.0,), n_folds=3, device="cpu").fit(x, y)
    ref = JRidge(lambdas=(1.0,), n_folds=3).fit(x, y)
    for bad in (x[:, :-1], x[None]):
        assert _errors(lambda: port.predict(bad)) == \
            _errors(lambda: ref.predict(bad))
    assert _errors(lambda: port.score(x, y[:-1])) == \
        _errors(lambda: ref.score(x, y[:-1]))


def _cpu_mesh(n=4):
    return make_mesh(("voxel",), (n,), devices=["cpu"] * n)


def test_ring_gram_and_meshed_fit_match_jax(monkeypatch):
    """With a mesh and the Gram over the budget, the fit's ``Xᵀ X``
    takes the SUMMA ring (``force='summa'`` on its own: the raw
    product), and the fit is the JAX package's meshless one."""
    x, y = _data(40, 8, 12, seed=9)
    g = distla.gram(x, mesh=_cpu_mesh(), force="summa", normalize=False,
                    device="cpu").numpy()
    np.testing.assert_allclose(g, x.T @ x, rtol=1e-5, atol=1e-4)
    calls = []
    ring = distla.summa_gram

    def counted(*args, **kwargs):
        calls.append(kwargs.get("normalize"))
        return ring(*args, **kwargs)

    monkeypatch.setattr(distla, "summa_gram", counted)
    monkeypatch.setenv(distla.BUDGET_ENV, "1")
    kw = dict(lambdas=(1.0, 10.0), n_folds=4)
    port = RidgeEncoder(mesh=_cpu_mesh(), device="cpu", **kw).fit(x, y)
    banded = BandedRidgeEncoder(np.repeat(np.arange(2), 4),
                                mesh=_cpu_mesh(2), device="cpu",
                                **kw).fit(x, y)
    assert calls == [False, False]
    monkeypatch.delenv(distla.BUDGET_ENV)
    _same_fit(port, JRidge(**kw).fit(x, y))
    _same_fit(banded, JBanded(np.repeat(np.arange(2), 4), **kw).fit(x, y))


def test_across_two_ranks():
    """The Gram's ring across two gloo ranks of two CPU positions each:
    each rank's fit within 1e-5 of the meshless one, and of the JAX
    package's."""
    ranks = run_distributed("tests.torch_dist_workers", "ridge_worker",
                            n_procs=2, local_devices=2, timeout=120,
                            extra_path=REPO_ROOT)
    x, y = make_ridge_data()
    ref = JRidge(lambdas=(1.0, 10.0), n_folds=4).fit(x, y)
    for r in ranks:
        (w, lam, cv), (w1, lam1, cv1) = r["mesh"], r["single"]
        np.testing.assert_array_equal(lam, lam1)
        np.testing.assert_allclose(w, w1, rtol=0, atol=1e-5)
        np.testing.assert_allclose(cv, cv1, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(lam, ref.lambda_)
        np.testing.assert_allclose(w, ref.W_, rtol=0,
                                   atol=RTOL * np.abs(ref.W_).max())


def test_spans_match_jax(clean_obs):  # noqa: F811
    """A fit emits the JAX package's ``encoding.fit`` span, a
    ``encoding.sweep_chunk`` span a block inside it, and the Gram's
    ``distla.gram`` span."""
    x, y = _data(40, 8, 12, seed=4)
    kw = dict(lambdas=(0.5, 5.0, 50.0), n_folds=4, lambda_block=2)
    trees = {}
    for name, snk, fit in (
            ("jax", jsink, lambda: JRidge(**kw).fit(x, y)),
            ("torch", tsink, lambda: RidgeEncoder(device="cpu", **kw)
             .fit(x, y))):
        mem = snk.add_sink(snk.MemorySink())
        fit()
        snk.remove_sink(mem)
        trees[name] = [s for s in span_tree(mem.records)
                       if s[0].startswith(("encoding.", "distla."))]
    assert trees["torch"] == trees["jax"]
    names = [s[0] for s in trees["torch"]]
    assert names.count("encoding.sweep_chunk") == 2
    assert names[-1] == "encoding.fit"


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x, y = _data(30, 4, 6)
    for enc in (RidgeEncoder(), BandedRidgeEncoder(np.zeros(4, np.int32))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            enc.fit(x, y)
