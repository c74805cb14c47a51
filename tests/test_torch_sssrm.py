"""The port's SS-SRM against the JAX package's on the CPU.

Inputs come from a numpy seed: alignment data sharing a response, and
labelled data whose two classes are separable in shared space.  The
JAX package runs under the harness's x64.  Tolerances:

- ``_fit_mlr`` in float64 on the same stacked data: ``theta``,
  ``bias`` and the loss to 1e-6 relative to their largest entry (both
  packages reach the optimum; their L-BFGS iterates differ);
- ``_fit_w_subject`` and ``_fit_w_subject_unsup`` in float64 from the
  same ``w0``, ``s``, ``theta`` and ``bias``: to 1e-8;
- ``SSSRM`` fitted in float64 (``_fit(..., torch.float64)``) against
  the JAX fit: the same initial W (both draw it from
  ``np.random.RandomState(rand_seed)``), ``w_`` and ``s_`` to 1e-5,
  ``predict`` equal;
- a JAX model carried across (``convert``): ``transform`` to 1e-6,
  ``predict`` equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.funcalign import sssrm as jsssrm
from brainiak_tpu_torch import convert
from brainiak_tpu_torch.funcalign import srm, sssrm

F64 = torch.float64


def make_sssrm_data(n_subjects=3, voxels=30, features=3, n_align=40,
                    n_sup=20, noise=0.1, seed=0):
    rng = np.random.RandomState(seed)
    S_align = rng.randn(features, n_align)
    class_means = rng.randn(features, 2) * 3
    X, Z, y = [], [], []
    for i in range(n_subjects):
        q, _ = np.linalg.qr(rng.randn(voxels, features))
        X.append(q @ S_align + noise * rng.randn(voxels, n_align))
        labels = rng.randint(0, 2, n_sup)
        latent = class_means[:, labels] + 0.3 * rng.randn(features, n_sup)
        Z.append(q @ latent + noise * rng.randn(voxels, n_sup))
        y.append(labels + 5)  # arbitrary label values
    return X, y, Z


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        max(1.0, np.abs(np.asarray(want)).max())


def _mlr_inputs():
    rng = np.random.RandomState(2)
    data = rng.randn(40, 3)
    labels = rng.randint(0, 3, 40)
    data[np.arange(40), labels] += 2.0
    weights = np.r_[np.full(15, 15.0), np.full(25, 25.0)]
    return data, labels, weights


def test_fit_mlr_matches_jax_in_float64():
    data, labels, weights = _mlr_inputs()
    jt, jb = jsssrm._fit_mlr(jnp.asarray(data), jnp.asarray(labels),
                             jnp.asarray(weights), 0.7, 3)
    tt, tb = sssrm._fit_mlr(_t(data), torch.tensor(labels), _t(weights),
                            0.7, 3)
    assert tt.dtype == F64 and tt.shape == (3, 3) and tb.shape == (3,)
    assert _rel(tt.numpy(), jt) <= 1e-6
    assert _rel(tb.numpy(), jb) <= 1e-6

    def loss(theta, bias):
        logits = data @ theta + bias
        logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
        return -0.7 * np.sum(logp[np.arange(40), labels] / weights) + \
            0.5 * np.sum(theta ** 2)

    want = loss(np.asarray(jt), np.asarray(jb))
    assert abs(loss(tt.numpy(), tb.numpy()) - want) <= 1e-6 * abs(want)


def _w_update_inputs():
    X, y, Z = make_sssrm_data()
    rng = np.random.RandomState(4)
    w0, _ = np.linalg.qr(rng.randn(30, 3))
    s = rng.randn(3, 40)
    theta, bias = rng.randn(3, 2), rng.randn(2)
    labels = y[0] - 5
    return X[0], Z[0], labels, w0, s, theta, bias


def test_fit_w_subject_matches_jax_in_float64():
    xa, xs, labels, w0, s, theta, bias = _w_update_inputs()
    args = (0.5 * 0.5 / 40, -0.5 / 20)
    jw, jv = jsssrm._fit_w_subject(
        jnp.asarray(xa), jnp.asarray(xs), jnp.asarray(labels),
        jnp.asarray(w0), jnp.asarray(s), jnp.asarray(theta),
        jnp.asarray(bias), *args)
    tw, tv = sssrm._fit_w_subject(
        _t(xa), _t(xs), torch.tensor(labels), _t(w0), _t(s), _t(theta),
        _t(bias), *args)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-8,
                               rtol=0)
    assert abs(float(tv) - float(jv)) <= 1e-8 * max(1.0, abs(float(jv)))
    jw, _ = jsssrm._fit_w_subject_unsup(jnp.asarray(xa), jnp.asarray(w0),
                                        jnp.asarray(s), args[0])
    tw, _ = sssrm._fit_w_subject_unsup(_t(xa), _t(w0), _t(s), args[0])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-8,
                               rtol=0)


def test_sssrm_fit_matches_jax_in_float64():
    X, y, Z = make_sssrm_data()
    want = jsssrm.SSSRM(n_iter=3, features=3, gamma=1.0,
                        alpha=0.5).fit(X, y, Z)
    got = sssrm.SSSRM(n_iter=3, features=3, gamma=1.0, alpha=0.5,
                      device="cpu")._fit(X, y, Z, F64)
    assert got.s_.dtype == np.float64
    for g, w in zip(got.w_, want.w_):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.s_, want.s_, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.classes_, want.classes_)
    for g, w in zip(got.predict(Z), want.predict(Z)):
        np.testing.assert_array_equal(g, w)


# -- mirrors of tests/funcalign/test_sssrm.py ---------------------------
# (2 BCD iterations where the JAX package's tests take 4: the port's
# float32 MLR update runs its 200 L-BFGS steps eagerly, ~1 s on the
# CPU; the checks are the same)

def _accuracy(preds, y):
    return np.mean([np.mean(p == yy) for p, yy in zip(preds, y)])


def test_sssrm_fit_and_predict():
    X, y, Z = make_sssrm_data()
    model = sssrm.SSSRM(n_iter=2, features=3, gamma=1.0, alpha=0.5,
                        device="cpu")
    model.fit(X, y, Z)
    assert len(model.w_) == 3
    for w in model.w_:
        assert w.dtype == np.float32
        assert np.allclose(w.T @ w, np.eye(3), atol=1e-5)
    assert model.s_.shape == (3, 40)
    assert set(model.classes_) == {5, 6}
    assert _accuracy(model.predict(Z), y) > 0.85
    assert model.score(Z, y) == pytest.approx(_accuracy(model.predict(Z),
                                                        y))
    assert model.transform(X)[0].shape == (3, 40)
    assert model.get_params()["alpha"] == 0.5


def test_sssrm_improves_alignment():
    X, y, Z = make_sssrm_data(noise=0.05)
    model = sssrm.SSSRM(n_iter=2, features=3, gamma=1.0, alpha=0.3,
                        device="cpu")
    proj = model.fit(X, y, Z).transform(X)
    for i in range(1, len(proj)):
        assert np.corrcoef(proj[0].ravel(), proj[i].ravel())[0, 1] > 0.9


def test_sssrm_unsupervised_subject():
    X, y, Z = make_sssrm_data(n_subjects=3)
    y[1], Z[1] = None, None
    model = sssrm.SSSRM(n_iter=3, features=3, gamma=1.0, alpha=0.5,
                        device="cpu")
    model.fit(X, y, Z)
    for w in model.w_:
        assert np.allclose(w.T @ w, np.eye(3), atol=1e-5)
    proj = model.transform(X)
    assert np.corrcoef(proj[0].ravel(), proj[1].ravel())[0, 1] > 0.9
    preds = model.predict([Z[0], None, Z[2]])
    assert preds[1] is None
    assert _accuracy((preds[0], preds[2]), (y[0], y[2])) > 0.85
    s = model.transform([X[0], None, X[2]])
    assert s[1] is None and s[0].shape == (3, 40)


def test_sssrm_errors():
    X, y, Z = make_sssrm_data(n_subjects=2)
    texts = []
    for mod, kw in ((sssrm, {"device": "cpu"}), (jsssrm, {})):
        raised = []
        for params, args in (
                (dict(alpha=1.5), (X, y, Z)),
                (dict(gamma=-1.0), (X, y, Z)),
                ({}, ([X[0]], [y[0]], [Z[0]])),
                ({}, (X, y[:1], Z)),
                (dict(features=100), (X, y, Z)),
                (dict(features=3), ([X[0], X[1][:, :-2]], y, Z)),
                (dict(features=3), (X, [y[0], y[1][:-3]], Z)),
                (dict(features=3), (X, y, [Z[0], Z[1][:-1]]))):
            with pytest.raises(ValueError) as e:
                mod.SSSRM(**params, **kw).fit(*args)
            raised.append(str(e.value))
        texts.append(raised)
    assert texts[0] == texts[1]
    with pytest.raises(srm.NotFittedError):
        sssrm.SSSRM(device="cpu").transform(X)
    with pytest.raises(srm.NotFittedError):
        sssrm.SSSRM(device="cpu").predict(Z)


def _label_cases():
    mixed = np.array(["a", 1, "b", 2], dtype=object)
    return [(mixed,), (np.array([1, "a"], dtype=object),),
            (np.array([1, 2], dtype=object),), (np.array([0.5, 1.0]),),
            (np.array([np.nan, 1.0]),),
            (np.array(["a", "b"]), np.array([1, 2])),
            (np.array([6, 5, 5, 7]),), (np.array([1.0, 0.0, 1.0]),),
            (np.array(["b", "a", "b"]),)]


@pytest.mark.parametrize("case", range(9))
def test_unique_labels_as_sklearn(case):
    """The same labels, or the same error type and message head."""
    import re

    from sklearn.utils.multiclass import unique_labels

    ys = _label_cases()[case]
    try:
        want = unique_labels(*ys)
    except (TypeError, ValueError) as exc:
        with pytest.raises(type(exc)) as got:
            sssrm.unique_labels(*ys)
        assert re.split("[:;.,]", str(got.value))[0] == \
            re.split("[:;.,]", str(exc))[0]
    else:
        np.testing.assert_array_equal(sssrm.unique_labels(*ys), want)


def test_mixed_label_types_raise_in_fit():
    """Strings and numbers in the labels: both packages' fits raise
    what sklearn's sort of the concatenated labels raises."""
    X, _, Z = make_sssrm_data(n_subjects=2, n_sup=2)
    y = [np.array(["a", 1], dtype=object), np.array(["b", 2], dtype=object)]
    with pytest.raises(TypeError, match="not supported"):
        sssrm.SSSRM(features=3, device="cpu").fit(X, y, Z)
    with pytest.raises(TypeError, match="not supported"):
        jsssrm.SSSRM(features=3).fit(X, y, Z)


def test_fit_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, Z = make_sssrm_data(n_subjects=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sssrm.SSSRM(n_iter=1, features=3).fit(X, y, Z)


def test_model_carried_from_jax():
    X, y, Z = make_sssrm_data()
    jm = jsssrm.SSSRM(n_iter=2, features=3, alpha=0.5).fit(X, y, Z)
    tm = convert.sssrm_from_jax(jm, device="cpu")
    assert isinstance(tm, sssrm.SSSRM)
    assert (tm.n_iter, tm.features, tm.alpha) == (2, 3, 0.5)
    for g, w in zip(tm.transform(X), jm.transform(X)):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    for g, w in zip(tm.predict(Z), jm.predict(Z)):
        np.testing.assert_array_equal(g, w)
