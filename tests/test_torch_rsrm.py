"""The port's RSRM against the JAX package's on the CPU.

Inputs come from a numpy seed (``X_i = W_i R + S_i + 0.05 noise`` with
orthonormal ``W_i`` and a sparse ``S_i`` of amplitude 5 on 2% of the
entries).  The JAX package runs under the harness's x64.  Tolerances:

- the chunk functions (``_shrink``, ``_rsrm_chunk`` ragged and not,
  ``_rsrm_objective``, ``_transform_new_data``,
  ``_transform_subject``) in float64 from the same state: every leaf
  to 1e-9;
- ``RSRM.fit``, the port in float32 from the JAX package's ``w0``
  (``srm._init_w`` patched), against the JAX fit in float64: ``w_``
  and ``r_`` to 1e-4 of their largest entry (at least 1),
  ``objective_`` to 1e-4 relative; the supports of ``s_`` equal but on
  entries within 1e-5 of the threshold (where float32 rounding may
  flip the shrinkage);
- a 2-position CPU mesh against no mesh, both float32: 2e-4 (the JAX
  package's ``mesh_atol`` in float32);
- a JAX model carried across (``convert``): ``transform`` and
  ``transform_subject`` to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.funcalign import rsrm as jrsrm
from brainiak_tpu.funcalign import srm as jsrm
from brainiak_tpu_torch import convert
from brainiak_tpu_torch.funcalign import rsrm, srm
from brainiak_tpu_torch.parallel import mesh as tmesh

GAMMA = 0.5


def make_rsrm_data(n_subjects=4, voxels=40, features=3, trs=50,
                   noise=0.05, outlier_frac=0.02, seed=0, ragged=False):
    rng = np.random.RandomState(seed)
    R = rng.randn(features, trs)
    X, S = [], []
    for i in range(n_subjects):
        v = voxels + (3 * i if ragged else 0)
        q, _ = np.linalg.qr(rng.randn(v, features))
        s = np.zeros((v, trs))
        idx = rng.rand(v, trs) < outlier_frac
        s[idx] = rng.randn(idx.sum()) * 5
        X.append(q @ R + s + noise * rng.randn(v, trs))
        S.append(s)
    return X, R, S


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_w0(stacked, counts, features=3, seed=0):
    return np.asarray(jsrm._init_w(
        jax.random.PRNGKey(seed), stacked.shape[1], stacked.shape[0],
        features, jnp.asarray(counts), dtype=jnp.float64))


def _state(ragged):
    X, _, _ = make_rsrm_data(ragged=ragged)
    stacked, vc, _, _ = jsrm._stack_and_pad(X, np.float64, demean=False)
    w0 = _jax_w0(stacked, vc.astype(np.float64))
    s0 = np.zeros_like(stacked)
    r0 = np.asarray(jrsrm._shared_response(jnp.asarray(stacked),
                                           jnp.asarray(s0),
                                           jnp.asarray(w0), len(X)))
    return X, stacked, vc, w0, s0, r0


def test_shrink_matches_jax():
    v = np.random.RandomState(1).randn(30, 7) * 2
    np.testing.assert_array_equal(
        rsrm._shrink(_t(v), GAMMA).numpy(),
        np.asarray(jrsrm._shrink(jnp.asarray(v), GAMMA)))


@pytest.mark.parametrize("ragged", [False, True])
def test_rsrm_chunk_and_objective_match_jax_in_float64(ragged):
    _, stacked, _, w0, s0, r0 = _state(ragged)
    got_r0 = rsrm._shared_response(_t(stacked), _t(s0), _t(w0), 4)
    np.testing.assert_allclose(got_r0.numpy(), r0, atol=1e-12, rtol=0)
    want = jrsrm._rsrm_chunk(jnp.asarray(stacked), jnp.asarray(w0),
                             jnp.asarray(s0), jnp.asarray(r0), GAMMA,
                             n_steps=5)
    got = rsrm._rsrm_chunk(_t(stacked), _t(w0), _t(s0), _t(r0), GAMMA, 5)
    for name, g, w in zip("wsr", got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9,
                                   rtol=0, err_msg=name)
    obj = float(rsrm._rsrm_objective(_t(stacked), *got, GAMMA))
    jobj = float(jrsrm._rsrm_objective(jnp.asarray(stacked), *want, GAMMA))
    assert abs(obj - jobj) <= 1e-9 * abs(jobj)


def test_transforms_match_jax_in_float64():
    X, _, _, _, _, _ = _state(False)
    jm = jrsrm.RSRM(n_iter=5, features=3, gamma=GAMMA).fit(X[:3])
    w, r = jm.w_[0], jm.r_
    want = jrsrm._transform_new_data(jnp.asarray(X[0]), jnp.asarray(w),
                                      GAMMA, 5)
    got = rsrm._transform_new_data(_t(X[0]), _t(w), GAMMA, 5)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-9,
                                   rtol=0)
    want = jrsrm._transform_subject(jnp.asarray(X[3]), jnp.asarray(r),
                                    GAMMA, 5)
    got = rsrm._transform_subject(_t(X[3]), _t(r), GAMMA, 5)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-9,
                                   rtol=0)


def _with_jax_w0(monkeypatch, w0):
    monkeypatch.setattr(
        srm, "_init_w",
        lambda *a, device="cpu", **k: torch.tensor(w0).float().to(device))


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= \
        1e-4 * scale, what


@pytest.mark.parametrize("ragged", [False, True])
def test_rsrm_fit_matches_jax(monkeypatch, ragged):
    X, _, _, w0, _, _ = _state(ragged)
    want = jrsrm.RSRM(n_iter=10, features=3, gamma=GAMMA).fit(X)
    _with_jax_w0(monkeypatch, w0)
    got = rsrm.RSRM(n_iter=10, features=3, gamma=GAMMA,
                    device="cpu").fit(X)
    assert got.r_.dtype == np.float32
    for g, w in zip(got.w_, want.w_):
        assert g.shape == w.shape
        _close(g, w, "w_")
    _close(got.r_, want.r_, "r_")
    assert abs(got.objective_ - want.objective_) <= \
        1e-4 * abs(want.objective_)
    for g, w in zip(got.s_, want.s_):
        flip = (g != 0) != (w != 0)
        assert np.all(np.maximum(np.abs(g), np.abs(w))[flip] <= 1e-5)
        assert np.abs(g - w).max() <= 1e-3


# -- mirrors of tests/funcalign/test_rsrm.py ----------------------------

def test_rsrm_recovery():
    X, _, _ = make_rsrm_data()
    model = rsrm.RSRM(n_iter=15, features=3, gamma=GAMMA, device="cpu")
    model.fit(X)
    assert len(model.w_) == 4
    for w in model.w_:
        assert np.allclose(w.T @ w, np.eye(3), atol=1e-5)
    assert model.r_.shape == (3, 50)
    projections = [model.w_[i].T @ (X[i] - model.s_[i]) for i in range(4)]
    for i in range(1, 4):
        c = np.corrcoef(projections[0].ravel(), projections[i].ravel())[0, 1]
        assert c > 0.9
    for s in model.s_:
        assert np.mean(np.abs(s) > 1e-8) < 0.2
    assert np.isfinite(model.objective_)
    assert model.get_params()["gamma"] == GAMMA


def test_rsrm_transform_and_transform_subject():
    X, _, _ = make_rsrm_data()
    model = rsrm.RSRM(n_iter=10, features=3, gamma=GAMMA, device="cpu")
    model.fit(X[:3])
    r, s = model.transform(X[:3])
    assert len(r) == 3 and r[0].shape == (3, 50) and s[0].shape == (40, 50)
    r2, s2 = model.transform([X[0], None, X[2]])
    assert r2[1] is None and s2[1] is None
    np.testing.assert_array_equal(r2[0], r[0])
    w, s = model.transform_subject(X[3])
    assert w.shape == (40, 3) and s.shape == (40, 50)
    assert np.allclose(w.T @ w, np.eye(3), atol=1e-5)
    with pytest.raises(ValueError):
        model.transform_subject(X[3][:, :-1])


def test_rsrm_errors():
    X, _, _ = make_rsrm_data(n_subjects=2)
    texts = []
    for mod, kw in ((rsrm, {"device": "cpu"}), (jrsrm, {})):
        with pytest.raises(ValueError) as e1:
            mod.RSRM(gamma=-1.0, **kw).fit(X)
        with pytest.raises(ValueError) as e2:
            mod.RSRM(features=3, **kw).fit([X[0]])
        with pytest.raises(ValueError) as e3:
            mod.RSRM(features=100, **kw).fit(X)
        with pytest.raises(ValueError) as e4:
            mod.RSRM(features=3, **kw).fit([X[0], X[1][:, :-2]])
        texts.append([str(e.value) for e in (e1, e2, e3, e4)])
    assert texts[0] == texts[1]
    bad = [X[0], X[1].copy()]
    bad[1][0, 0] = np.inf
    with pytest.raises(ValueError, match="infinity"):
        rsrm.RSRM(features=3, device="cpu").fit(bad)
    with pytest.raises(srm.NotFittedError):
        rsrm.RSRM(device="cpu").transform(X)
    with pytest.raises(srm.NotFittedError):
        rsrm.RSRM(device="cpu").transform_subject(X[0])
    model = rsrm.RSRM(n_iter=5, features=3, gamma=GAMMA,
                      device="cpu").fit(X)
    with pytest.raises(ValueError):
        model.transform([X[0]])


def test_fit_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, _, _ = make_rsrm_data(n_subjects=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rsrm.RSRM(n_iter=2, features=3).fit(X)


def test_mesh_fit_matches_no_mesh():
    X, _, _ = make_rsrm_data(n_subjects=4)
    mesh = tmesh.make_mesh(("subject",), (2,), devices=["cpu"] * 2)
    single = rsrm.RSRM(n_iter=8, features=3, gamma=GAMMA,
                       device="cpu").fit(X)
    dist = rsrm.RSRM(n_iter=8, features=3, gamma=GAMMA, mesh=mesh).fit(X)
    for w0, w1 in zip(single.w_, dist.w_):
        np.testing.assert_allclose(w0, w1, atol=2e-4, rtol=0)
    for s0, s1 in zip(single.s_, dist.s_):
        np.testing.assert_allclose(s0, s1, atol=2e-4, rtol=0)
    np.testing.assert_allclose(single.r_, dist.r_, atol=2e-4, rtol=0)
    assert dist.objective_ == pytest.approx(single.objective_, rel=1e-5)


def test_model_carried_from_jax():
    X, _, _ = make_rsrm_data(ragged=True)
    jm = jrsrm.RSRM(n_iter=6, features=3, gamma=GAMMA).fit(X[:3])
    tm = convert.rsrm_from_jax(jm, device="cpu")
    assert isinstance(tm, rsrm.RSRM)
    assert (tm.n_iter, tm.features, tm.gamma) == (6, 3, GAMMA)
    assert tm.objective_ == jm.objective_
    for g, w in zip(tm.transform(X[:3]), jm.transform(X[:3])):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for a, b in zip(tm.transform_subject(X[3][:40]),
                    jm.transform_subject(X[3][:40])):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
