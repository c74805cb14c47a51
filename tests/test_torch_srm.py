"""The port's SRM and DetSRM against the JAX package on the CPU.

Inputs come from a numpy seed (``X_i = W_i S + 0.1 noise`` with
orthonormal ``W_i``).  The JAX package runs under the harness's x64,
so its fits and chunk functions are float64.  Tolerances:

- the polar factors (``_procrustes``, ``_polar_ns``,
  ``_procrustes_batch``) on the same float64 inputs: 1e-10, but 1e-8
  on rank-deficient inputs with ``perturbation=0``, whose Gram has a
  repeated zero eigenvalue: its eigenvectors are not unique, so the
  output's part outside the input's range is rounding amplified by the
  eigenvalue floor, and differs between the two packages' LAPACK calls
  at about 3e-9 (it does not within one package);
- the EM and BCD chunks in float64 from the JAX package's own
  ``_init_w`` draw, 5 steps: every leaf to 1e-9;
- the estimators, the port in float32 from the JAX package's ``w0``
  (``_init_w`` patched), against the JAX fit in float64: ``w_``,
  ``s_`` and ``rho2_`` to 1e-4 of their largest entry (at least 1),
  ``logprob_`` / ``objective_`` to 1e-4 relative;
- a 4-position CPU mesh against no mesh, both float32: 2e-4 (the JAX
  package's ``mesh_atol`` in float32; measured 3e-7 on ``w_`` and
  7e-5 on SRM's ``s_``, whose partial sums are added in another
  order);
- a JAX model carried across (``convert``) against the JAX model:
  ``transform`` and ``transform_subject`` to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.funcalign import srm as jsrm
from brainiak_tpu.obs import sink as jsink
from brainiak_tpu.utils.checkpoint import FORCE_NPZ_ENV_VAR
from brainiak_tpu_torch import convert
from brainiak_tpu_torch.funcalign import srm
from brainiak_tpu_torch.obs import sink as tsink
from brainiak_tpu_torch.parallel import mesh as tmesh
from torch_obs_state import clean_obs, span_tree  # noqa: F401

F64 = torch.float64


def make_synthetic(n_subjects=4, voxels=30, samples=40, features=4,
                   noise=0.1, seed=0, ragged=False):
    """X_i = W_i S + noise with orthonormal W_i."""
    rng = np.random.RandomState(seed)
    S = rng.randn(features, samples)
    X, W = [], []
    for i in range(n_subjects):
        v = voxels + (i if ragged else 0)
        q, _ = np.linalg.qr(rng.randn(v, features))
        W.append(q)
        X.append(q @ S + noise * rng.randn(v, samples))
    return X, W, S


def shared_space_correlation(model, X):
    """Mean pairwise correlation of per-subject shared responses."""
    s = model.transform(X)
    corrs = []
    for i in range(len(s)):
        for j in range(i + 1, len(s)):
            corrs.append(np.corrcoef(s[i].ravel(), s[j].ravel())[0, 1])
    return np.mean(corrs)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the polar factors --------------------------------------------------

def _conditioned_matrix(kappa, v=600, k=20):
    rng = np.random.RandomState(1)
    u, _ = np.linalg.qr(rng.randn(v, k))
    vv, _ = np.linalg.qr(rng.randn(k, k))
    return (u * np.logspace(0, -np.log10(kappa), k)) @ vv.T


def _procrustes_case(name):
    rng = np.random.RandomState(0)
    return {
        "tall": (rng.randn(600, 12), 0.001, 1e-10),
        "square": (rng.randn(12, 12), 0.001, 1e-10),
        "short": (rng.randn(30, 12), 0.001, 1e-10),
        "conditioned": (_conditioned_matrix(1000.0), 0.001, 1e-10),
        "zero": (np.zeros((600, 12)), 0.001, 1e-10),
        "zero_unperturbed": (np.zeros((600, 12)), 0.0, 1e-10),
        "rank1": (np.outer(rng.randn(600), np.ones(12)), 0.0, 1e-8),
        "rank6": (rng.randn(600, 6) @ rng.randn(6, 12), 0.0, 1e-8),
    }[name]


@pytest.mark.parametrize("name", ["tall", "square", "short",
                                  "conditioned", "zero",
                                  "zero_unperturbed", "rank1", "rank6"])
def test_procrustes_matches_jax(name):
    a, pert, tol = _procrustes_case(name)
    want = np.asarray(jsrm._procrustes(jnp.asarray(a), perturbation=pert))
    got = srm._procrustes(_t(a), perturbation=pert).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    if name in ("tall", "square", "conditioned"):
        k = a.shape[1]
        np.testing.assert_allclose(got.T @ got, np.eye(k), atol=1e-10)


@pytest.mark.parametrize("kappa", [1.0, 100.0, 1000.0])
def test_polar_ns_matches_jax(kappa):
    a = _conditioned_matrix(kappa)
    want = np.asarray(jsrm._polar_ns(jnp.asarray(a)))
    got = srm._polar_ns(_t(a)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)
    uu, _, vt = np.linalg.svd(a, full_matrices=False)
    assert np.abs(got - uu @ vt).max() < 1e-6


def test_procrustes_ns_route_matches_jax(monkeypatch):
    """POLAR_METHOD='ns' with the SRM perturbation, in both packages."""
    a = _conditioned_matrix(1000.0)
    monkeypatch.setattr(jsrm, "POLAR_METHOD", "ns")
    monkeypatch.setattr(srm, "POLAR_METHOD", "ns")
    want = np.asarray(jsrm._procrustes(jnp.asarray(a)))
    got = srm._procrustes(_t(a)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)
    monkeypatch.setattr(srm, "POLAR_METHOD", "eigh")
    assert np.abs(got - srm._procrustes(_t(a)).numpy()).max() < 1e-6


@pytest.mark.parametrize("use_mesh", [False, True])
@pytest.mark.parametrize("shape", [(8, 200, 10), (4, 12, 12)])
def test_procrustes_batch_matches_jax(shape, use_mesh):
    b = np.random.RandomState(2).randn(*shape)
    b[1] = 0.0
    jmesh = tmesh_ = None
    if use_mesh:
        from brainiak_tpu.parallel import make_mesh
        jmesh = make_mesh(("subject",), (4,))
        tmesh_ = tmesh.make_mesh(("subject",), (4,), devices=["cpu"] * 4)
    want = np.asarray(jsrm._procrustes_batch(jnp.asarray(b), jmesh))
    got = srm._procrustes_batch(_t(b), tmesh_).numpy()
    np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)


# -- the chunk functions in float64 -------------------------------------

def _jax_w0(stacked, counts, features=4, seed=0):
    return np.asarray(jsrm._init_w(
        jax.random.PRNGKey(seed), stacked.shape[1], stacked.shape[0],
        features, jnp.asarray(counts), dtype=jnp.float64))


@pytest.mark.parametrize("ragged", [False, True])
def test_em_chunk_matches_jax_in_float64(ragged):
    X, _, _ = make_synthetic(ragged=ragged)
    stacked, vc, _, tr = jsrm._stack_and_pad(X, np.float64)
    counts = vc.astype(np.float64)
    w0 = _jax_w0(stacked, counts)
    init = (w0, np.ones(4), np.eye(4), np.zeros((4, 40)))
    want = jsrm._em_chunk(jnp.asarray(stacked), jnp.asarray(tr),
                          jnp.asarray(counts),
                          *(jnp.asarray(a) for a in init), n_steps=5)
    got = srm._em_chunk(_t(stacked), _t(tr), _t(counts),
                        *(_t(a) for a in init), n_steps=5)
    for name, g, w in zip(("w", "rho2", "sigma_s", "shared"), got, want):
        assert g.dtype == F64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9,
                                   rtol=0, err_msg=name)
    ll = srm._final_log_likelihood(_t(stacked), *got[:3], _t(tr),
                                   _t(counts))
    jll = jsrm._final_log_likelihood(
        jnp.asarray(stacked), *want[:3], jnp.asarray(tr),
        jnp.asarray(counts))
    assert abs(float(ll) - float(jll)) <= 1e-9 * abs(float(jll))


@pytest.mark.parametrize("ragged", [False, True])
def test_det_chunk_matches_jax_in_float64(ragged):
    X, _, _ = make_synthetic(ragged=ragged)
    stacked, vc, _, _ = jsrm._stack_and_pad(X, np.float64, demean=False)
    w0 = _jax_w0(stacked, vc.astype(np.float64))
    shared0 = np.einsum('svk,svt->kt', w0, stacked) / 4
    want = jsrm._det_chunk(jnp.asarray(stacked), jnp.asarray(w0),
                           jnp.asarray(shared0), n_steps=5)
    got = srm._det_chunk(_t(stacked), _t(w0), _t(shared0), n_steps=5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9,
                                   rtol=0)
    obj = float(srm._det_objective(_t(stacked), *got))
    jobj = float(jsrm._det_objective(jnp.asarray(stacked), *want))
    assert abs(obj - jobj) <= 1e-9 * abs(jobj)


def test_init_w_is_orthonormal_and_seeded():
    counts = torch.tensor([30.0, 33.0])
    w = srm._init_w(3, 33, 2, 4, counts)
    assert w.dtype == torch.float32 and w.shape == (2, 33, 4)
    assert torch.all(w[0, 30:] == 0)
    for i, v in enumerate((30, 33)):
        np.testing.assert_allclose((w[i, :v].T @ w[i, :v]).numpy(),
                                   np.eye(4), atol=1e-6)
    assert torch.equal(w, srm._init_w(3, 33, 2, 4, counts))
    assert not torch.equal(w, srm._init_w(4, 33, 2, 4, counts))


# -- the estimators against the JAX fits --------------------------------

def _with_jax_w0(monkeypatch, X, demean):
    stacked, vc, _, _ = jsrm._stack_and_pad(X, np.float64, demean=demean)
    w0 = _jax_w0(stacked, vc.astype(np.float64))
    monkeypatch.setattr(
        srm, "_init_w",
        lambda *a, device="cpu", **k: torch.tensor(w0).float().to(
            device))


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= \
        1e-4 * scale, what


@pytest.mark.parametrize("ragged", [False, True])
def test_srm_fit_matches_jax(monkeypatch, ragged):
    X, _, _ = make_synthetic(ragged=ragged)
    want = jsrm.SRM(n_iter=10, features=4).fit(X)
    _with_jax_w0(monkeypatch, X, True)
    got = srm.SRM(n_iter=10, features=4, device="cpu").fit(X)
    assert got.s_.dtype == np.float32
    for g, w in zip(got.w_, want.w_):
        assert g.shape == w.shape
        _close(g, w, "w_")
    _close(got.s_, want.s_, "s_")
    _close(got.rho2_, want.rho2_, "rho2_")
    _close(got.sigma_s_, want.sigma_s_, "sigma_s_")
    for g, w in zip(got.mu_, want.mu_):
        _close(g, w, "mu_")
    assert abs(got.logprob_ - want.logprob_) <= 1e-4 * abs(want.logprob_)


@pytest.mark.parametrize("ragged", [False, True])
def test_detsrm_fit_matches_jax(monkeypatch, ragged):
    X, _, _ = make_synthetic(ragged=ragged)
    want = jsrm.DetSRM(n_iter=10, features=4).fit(X)
    _with_jax_w0(monkeypatch, X, False)
    got = srm.DetSRM(n_iter=10, features=4, device="cpu").fit(X)
    for g, w in zip(got.w_, want.w_):
        _close(g, w, "w_")
    _close(got.s_, want.s_, "s_")
    assert abs(got.objective_ - want.objective_) <= \
        1e-4 * abs(want.objective_)


# -- mirrors of tests/funcalign/test_srm.py -----------------------------

@pytest.mark.parametrize("cls", [srm.SRM, srm.DetSRM])
def test_srm_recovers_shared_structure(cls):
    X, _, _ = make_synthetic()
    model = cls(n_iter=10, features=4, device="cpu")
    model.fit(X)
    assert len(model.w_) == len(X)
    for i, w in enumerate(model.w_):
        assert w.shape == (X[i].shape[0], 4)
        assert np.allclose(w.T @ w, np.eye(4), atol=1e-5)
    assert model.s_.shape == (4, 40)
    assert shared_space_correlation(model, X) > 0.9


@pytest.mark.parametrize("cls", [srm.SRM, srm.DetSRM])
def test_srm_ragged_voxel_counts(cls):
    X, _, _ = make_synthetic(ragged=True)
    model = cls(n_iter=8, features=4, device="cpu")
    model.fit(X)
    for i, w in enumerate(model.w_):
        assert w.shape == (X[i].shape[0], 4)
        assert np.allclose(w.T @ w, np.eye(4), atol=1e-5)
    assert shared_space_correlation(model, X) > 0.9


def test_srm_attributes_and_logprob():
    X, _, _ = make_synthetic()
    model = srm.SRM(n_iter=10, features=4, device="cpu")
    model.fit(X)
    assert model.sigma_s_.shape == (4, 4)
    assert model.rho2_.shape == (4,)
    assert np.all(model.rho2_ > 0)
    assert len(model.mu_) == 4
    assert np.isfinite(model.logprob_)
    # rho2 approximates the injected noise variance (0.1^2)
    assert np.all(model.rho2_ < 0.1)
    assert model.get_params()["features"] == 4
    assert model.set_params(n_iter=3).n_iter == 3
    with pytest.raises(ValueError):
        model.set_params(bogus=1)
    s = srm.SRM(n_iter=4, features=4, device="cpu").fit_transform(X)
    assert len(s) == 4 and s[0].shape == (4, 40)


def test_srm_errors():
    X, _, _ = make_synthetic(n_subjects=2)
    texts = []
    for mod, kw in ((srm, {"device": "cpu"}), (jsrm, {})):
        with pytest.raises(ValueError) as e1:
            mod.SRM(n_iter=2, features=4, **kw).fit([X[0]])
        with pytest.raises(ValueError) as e2:
            mod.SRM(n_iter=2, features=4, **kw).fit([X[0], X[1][:, :-3]])
        with pytest.raises(ValueError) as e3:
            mod.SRM(n_iter=2, features=100, **kw).fit(X)
        texts.append([str(e.value) for e in (e1, e2, e3)])
    assert texts[0] == texts[1]
    bad = [X[0], X[1].copy()]
    bad[1][0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        srm.SRM(n_iter=2, features=4, device="cpu").fit(bad)
    model = srm.SRM(n_iter=2, features=4, device="cpu")
    with pytest.raises(srm.NotFittedError):
        model.transform(X)
    with pytest.raises(srm.NotFittedError):
        model.transform_subject(X[0])
    assert issubclass(srm.NotFittedError, (ValueError, AttributeError))
    model.fit(X)
    with pytest.raises(ValueError):
        model.transform([X[0]])
    with pytest.raises(ValueError):
        model.transform_subject(X[0][:, :-2])


def test_fit_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, _, _ = make_synthetic(n_subjects=2)
    for cls in (srm.SRM, srm.DetSRM):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(n_iter=2, features=4).fit(X)


def test_a_store_is_refused():
    """A SubjectStore (the JAX package's data plane) is not ported."""
    from brainiak_tpu.data.store import write_store

    X, _, _ = make_synthetic(n_subjects=2)
    return_store = _store(write_store, X)
    for cls in (srm.SRM, srm.DetSRM):
        with pytest.raises(NotImplementedError, match="item 13"):
            cls(n_iter=2, features=4, device="cpu").fit(return_store)


def _store(write_store, X):
    import tempfile
    root = tempfile.mkdtemp(prefix="srm_store_")
    return write_store(root, X)


def test_transform_subject_new():
    X, _, _ = make_synthetic(n_subjects=5)
    model = srm.SRM(n_iter=10, features=4, device="cpu")
    model.fit(X[:4])
    w_new = model.transform_subject(X[4])
    assert w_new.shape == (X[4].shape[0], 4)
    assert np.allclose(w_new.T @ w_new, np.eye(4), atol=1e-5)
    s_new = w_new.T @ X[4]
    s0 = model.w_[0].T @ X[0]
    assert np.corrcoef(s_new.ravel(), s0.ravel())[0, 1] > 0.8


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_save_load_across_packages(tmp_path, writer, ragged):
    """A file either package saves, both load to the same model."""
    X, _, _ = make_synthetic(ragged=ragged)
    model = (srm.SRM(n_iter=5, features=4, device="cpu")
             if writer == "torch" else jsrm.SRM(n_iter=5, features=4))
    model.fit(X)
    path = tmp_path / "model.npz"
    model.save(path)
    if not ragged:
        # uniform voxel counts: readable with pickle disabled
        with np.load(path, allow_pickle=False) as f:
            assert f["w_"].shape == (4, 30, 4)
    for loaded in (srm.load(path, device="cpu"), jsrm.load(path)):
        assert loaded.features == 4 and loaded.n_iter == 5
        for w0, w1 in zip(model.w_, loaded.w_):
            assert w0.shape == w1.shape and np.array_equal(w0, w1)
        for name in ("s_", "sigma_s_", "rho2_"):
            assert np.array_equal(getattr(model, name),
                                  getattr(loaded, name))
        for m0, m1 in zip(model.mu_, loaded.mu_):
            assert np.array_equal(m0, m1)
        s = loaded.transform(X)
        assert s[0].shape == (4, 40)


def test_unfitted_save(tmp_path):
    with pytest.raises(srm.NotFittedError):
        srm.SRM(device="cpu").save(tmp_path / "x.npz")


@pytest.mark.parametrize("cls", ["SRM", "DetSRM"])
def test_mesh_fit_matches_no_mesh(cls):
    """Subjects laid out over a 4-position CPU mesh against no mesh."""
    X, _, _ = make_synthetic(n_subjects=8, voxels=20, samples=30,
                             features=3)
    mesh = tmesh.make_mesh(("subject",), (4,), devices=["cpu"] * 4)
    single = getattr(srm, cls)(n_iter=6, features=3, device="cpu").fit(X)
    dist = getattr(srm, cls)(n_iter=6, features=3, mesh=mesh).fit(X)
    for w0, w1 in zip(single.w_, dist.w_):
        np.testing.assert_allclose(w0, w1, atol=2e-4, rtol=0)
    np.testing.assert_allclose(single.s_, dist.s_, atol=2e-4, rtol=0)
    if cls == "SRM":
        np.testing.assert_allclose(single.rho2_, dist.rho2_, atol=2e-4,
                                   rtol=0)


def test_mesh_places_subjects_on_positions(monkeypatch):
    """With a mesh the stack is laid out along its subject axis, one
    product a position, and the W solves go through shard_vmap."""
    from brainiak_tpu_torch.ops import distla

    X, _, _ = make_synthetic(n_subjects=4)
    mesh = tmesh.make_mesh(("subject",), (2,), devices=["cpu"] * 2)
    seen, real = [], distla.shard_vmap

    def spy(fn, mesh_, axis, n):
        seen.append((mesh_, axis, n))
        return real(fn, mesh_, axis, n)

    monkeypatch.setattr(distla, "shard_vmap", spy)
    model = srm.SRM(n_iter=2, features=4, mesh=mesh)
    x = model._device_place(np.zeros((4, 30, 40), np.float32), "cpu")
    assert isinstance(x, tmesh.Sharded) and len(x.chunks) == 2
    assert x.chunks[0].shape == (2, 30, 40)
    model.fit(X)
    assert seen and all(s == (mesh, "subject", 4) for s in seen)


# -- spans of a checkpointed fit ----------------------------------------

@pytest.mark.parametrize("cls", ["SRM", "DetSRM"])
def test_fit_chunk_spans_match_jax(clean_obs, monkeypatch, tmp_path,  # noqa: F811
                                   cls):
    monkeypatch.setenv(FORCE_NPZ_ENV_VAR, "1")
    X, _, _ = make_synthetic()
    trees = []
    for pkg, snk, kw in ((srm, tsink, {"device": "cpu"}),
                         (jsrm, jsink, {})):
        mem = snk.add_sink(snk.MemorySink())
        try:
            getattr(pkg, cls)(n_iter=7, features=4, **kw).fit(
                X, checkpoint_dir=str(tmp_path / pkg.__name__),
                checkpoint_every=3)
        finally:
            snk.remove_sink(mem)
        trees.append(span_tree(mem.records))
        assert all(r["fit_id"] for r in mem.records
                   if r["kind"] == "span")
    assert trees[0] == trees[1]
    assert [a["step"] for _, _, a in trees[0]] == [0, 3, 6]
    assert trees[0][0][2]["estimator"] == cls + ".fit"


# -- carried across from the JAX package --------------------------------

@pytest.mark.parametrize("name", ["SRM", "DetSRM"])
def test_model_carried_from_jax(name):
    X, _, _ = make_synthetic(n_subjects=5, ragged=True)
    jm = getattr(jsrm, name)(n_iter=6, features=4).fit(X[:4])
    fn = convert.srm_from_jax if name == "SRM" else convert.detsrm_from_jax
    tm = fn(jm, device="cpu")
    assert isinstance(tm, getattr(srm, name))
    assert (tm.n_iter, tm.features, tm.rand_seed) == (6, 4, 0)
    for g, w in zip(tm.transform(X[:4]), jm.transform(X[:4])):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tm.transform_subject(X[4]),
                               jm.transform_subject(X[4]), atol=1e-6,
                               rtol=0)
    if name == "SRM":
        assert tm.logprob_ == jm.logprob_
    else:
        assert tm.objective_ == jm.objective_
