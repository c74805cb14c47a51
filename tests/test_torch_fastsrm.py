"""The port's FastSRM against the JAX package's on the CPU.

Inputs come from a numpy seed (``X_ij = W_i S_j + 0.05 noise``, two
sessions of 30 and 25 TRs, orthonormal ``W_i``).  The JAX package runs
under the harness's x64.  Tolerances:

- ``_reduce_one`` (deterministic atlas, probabilistic atlas, streamed
  in voxel chunks, an ``.npy`` path through its memmap) against the
  JAX function in float64: 1e-6;
- ``FastSRM.fit``, the port in float32 from the JAX package's
  reduced-space ``w0`` (``srm._init_w`` patched), against the JAX fit
  in float64: ``basis_list`` to 1e-4;
- ``n_jobs=2`` against ``n_jobs=1``: bit for bit;
- a JAX model carried across (``convert``): ``transform`` and
  ``inverse_transform`` to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.funcalign import fastsrm as jfast
from brainiak_tpu.funcalign import srm as jsrm
from brainiak_tpu_torch import convert
from brainiak_tpu_torch.funcalign import fastsrm, srm


def make_fastsrm_data(n_subjects=4, voxels=60, components=3,
                      session_lengths=(30, 25), noise=0.05, seed=0):
    rng = np.random.RandomState(seed)
    shared = [rng.randn(components, t) for t in session_lengths]
    imgs = []
    for _ in range(n_subjects):
        q, _ = np.linalg.qr(rng.randn(voxels, components))
        imgs.append([q @ s + noise * rng.randn(voxels, s.shape[1])
                     for s in shared])
    return imgs, shared


def _fast(**kw):
    return fastsrm.FastSRM(device="cpu", **kw)


# -- _reduce_one --------------------------------------------------------

def _atlases():
    rng = np.random.RandomState(1)
    return rng.randint(0, 7, size=60), np.abs(rng.randn(10, 60))


@pytest.mark.parametrize("kind", ["deterministic", "probabilistic"])
@pytest.mark.parametrize("route", ["memory", "chunks", "path"])
def test_reduce_one_matches_jax(tmp_path, kind, route):
    data = make_fastsrm_data()[0][0][0]
    det, prob = _atlases()
    atlas, inv = (det, None) if kind == "deterministic" else \
        (None, np.linalg.pinv(prob))
    src, chunk = data, None
    if route == "chunks":
        chunk = 7
    elif route == "path":
        src = str(tmp_path / "subject.npy")
        np.save(src, data)
        chunk = 16
    want = jfast._reduce_one(src, atlas, inv, chunk_voxels=chunk)
    got = fastsrm._reduce_one(src, atlas, inv, chunk_voxels=chunk,
                              device="cpu")
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


# -- the fit against the JAX package's ---------------------------------

def _with_jax_w0(monkeypatch, reduced_shape, n_subjects, k=3):
    w0 = np.asarray(jsrm._init_w(
        jax.random.PRNGKey(0), reduced_shape, n_subjects, k,
        jnp.full((n_subjects,), float(reduced_shape)), dtype=jnp.float64))
    monkeypatch.setattr(
        srm, "_init_w",
        lambda *a, device="cpu", **k: torch.tensor(w0).float().to(device))


@pytest.mark.parametrize("atlas", [False, True])
def test_fit_matches_jax(monkeypatch, atlas):
    imgs, _ = make_fastsrm_data()
    det = _atlases()[0] if atlas else None
    want = jfast.FastSRM(atlas=det, n_components=3, n_iter=10).fit(imgs)
    _with_jax_w0(monkeypatch, 6 if atlas else 60, 4)
    got = _fast(atlas=det, n_components=3, n_iter=10).fit(imgs)
    for g, w in zip(got.basis_list, want.basis_list):
        assert g.dtype == np.float32 and g.shape == (3, 60)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)
        np.testing.assert_allclose(g @ g.T, np.eye(3), atol=1e-5)


# -- mirrors of tests/funcalign/test_fastsrm.py -------------------------

def test_transform_inverse_and_aggregate():
    imgs, shared = make_fastsrm_data()
    model = _fast(n_components=3, n_iter=20, aggregate="mean").fit(imgs)
    assert len(model.basis_list) == 4
    out = model.transform(imgs)
    assert len(out) == 2
    assert out[0].shape == (3, 30) and out[1].shape == (3, 25)
    recon = model.inverse_transform(out)
    rel = np.linalg.norm(recon[0][0] - imgs[0][0]) / \
        np.linalg.norm(imgs[0][0])
    assert rel < 0.2
    one = model.inverse_transform(out[0], subjects_indexes=[1])
    np.testing.assert_allclose(one[0], recon[1][0], atol=1e-6)
    model.aggregate = None
    per = model.transform(imgs, subjects_indexes=[0, 1, 2, 3])
    assert len(per) == 4 and per[0][1].shape == (3, 25)
    np.testing.assert_allclose(np.mean([p[0] for p in per], axis=0),
                               out[0], atol=1e-6)
    flat = [subj[0] for subj in imgs]
    single = _fast(n_components=3, n_iter=20, aggregate=None)
    assert len(single.fit_transform(flat)) == 4
    with pytest.raises(ValueError):
        _fast(aggregate="median")
    assert single.get_params()["n_components"] == 3


def test_probabilistic_atlas_fit():
    imgs, _ = make_fastsrm_data()
    model = _fast(atlas=_atlases()[1], n_components=3, n_iter=20)
    assert model.fit(imgs).transform(imgs)[0].shape == (3, 30)


def test_n_jobs_and_spills_are_bit_for_bit(tmp_path):
    imgs, _ = make_fastsrm_data(n_subjects=3)
    serial = _fast(n_components=3, n_iter=15, n_jobs=1).fit(imgs)
    parallel = _fast(n_components=3, n_iter=15, n_jobs=2).fit(imgs)
    spill = _fast(n_components=3, n_iter=15, n_jobs=2,
                  temp_dir=str(tmp_path), low_ram=True).fit(imgs)
    names = sorted(__import__("os").listdir(spill.temp_dir))
    assert names == sorted([f"basis_{i}.npy" for i in range(3)]
                           + [f"reduced_{i}_{j}.npy" for i in range(3)
                              for j in range(2)])
    for b0, b1, b2 in zip(serial.basis_list, parallel.basis_list,
                          spill.basis_list):
        assert isinstance(b2, str)
        np.testing.assert_array_equal(b0, b1)
        np.testing.assert_array_equal(b0, np.load(b2))
    spill.clean()
    assert not any(p.name.startswith("fastsrm") for p in tmp_path.iterdir())


def test_paths_and_low_ram(tmp_path):
    imgs, _ = make_fastsrm_data(n_subjects=3)
    paths = np.empty((3, 2), dtype=object)
    for i, subj in enumerate(imgs):
        for j, sess in enumerate(subj):
            p = tmp_path / f"s{i}_{j}.npy"
            np.save(p, sess)
            paths[i, j] = str(p)
    model = _fast(n_components=3, n_iter=15, temp_dir=str(tmp_path),
                  low_ram=True).fit(paths)
    assert isinstance(model.basis_list[0], str)
    memory = _fast(n_components=3, n_iter=15).fit(imgs)
    for b0, b1 in zip(memory.basis_list, model.basis_list):
        np.testing.assert_allclose(b0, np.load(b1), atol=1e-5)
    assert model.transform(paths)[0].shape == (3, 30)
    model.clean()
    assert not any(p.name.startswith("fastsrm") for p in tmp_path.iterdir())


def test_add_subjects():
    imgs, _ = make_fastsrm_data(n_subjects=5)
    model = _fast(n_components=3, n_iter=20).fit(imgs[:4])
    shared = model.transform(imgs[:4])
    model.add_subjects(imgs[4:], shared)
    assert len(model.basis_list) == 5
    recon = model.inverse_transform(shared, subjects_indexes=[4])
    rel = np.linalg.norm(recon[0][0] - imgs[4][0]) / \
        np.linalg.norm(imgs[4][0])
    assert rel < 0.25


def test_errors_and_validation():
    imgs, _ = make_fastsrm_data()
    with pytest.raises(srm.NotFittedError):
        _fast(n_components=3).transform(imgs)
    with pytest.raises(ValueError):
        _fast(n_components=3).fit(imgs[:1])
    with pytest.raises(ValueError):
        _fast(n_components=3).fit([imgs[0], imgs[1][:1]])
    rng = np.random.RandomState(0)
    V, T, K = 60, 40, 4
    data = [rng.randn(V, T) for _ in range(3)]
    for match, kw, args in (
            ("voxels", {}, [data[0], data[1], rng.randn(V + 5, T)]),
            ("timeframes", {}, [[data[0]], [rng.randn(V, T - 3)],
                                [data[2]]]),
            ("2 axes", {}, [rng.randn(V), data[1], data[2]]),
            ("Atlas has", dict(atlas=np.tile(np.arange(1, 11), 5)), data),
            ("regions", dict(atlas=np.tile(np.arange(1, 4), 20)), data)):
        for mod, extra in ((fastsrm, {"device": "cpu"}), (jfast, {})):
            with pytest.raises(ValueError, match=match):
                mod.FastSRM(n_components=K, **kw, **extra).fit(args)
    with pytest.raises(ValueError, match="shorter than"):
        _fast(n_components=50).fit(data)
    model = _fast(n_components=K).fit(data)
    with pytest.raises(ValueError, match="out of range"):
        model.transform(data, subjects_indexes=[0, 1, 5])
    with pytest.raises(ValueError, match="must match"):
        model.transform(data[:2], subjects_indexes=[0, 1, 2])
    with pytest.raises(ValueError, match="out of range"):
        model.inverse_transform(rng.randn(K, T), subjects_indexes=[9])


def test_a_store_is_refused(tmp_path):
    from brainiak_tpu.data import write_store

    imgs, _ = make_fastsrm_data(session_lengths=(30,))
    store = write_store(str(tmp_path / "st"), [s[0] for s in imgs],
                        dtype=np.float64)
    for arg in (store, [[store.ref(i)] for i in range(4)]):
        with pytest.raises(NotImplementedError, match="item 13"):
            _fast(n_components=3).fit(arg)


def test_fit_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imgs, _ = make_fastsrm_data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fastsrm.FastSRM(n_components=3, n_iter=2).fit(imgs)


def test_model_carried_from_jax(tmp_path):
    imgs, _ = make_fastsrm_data(n_subjects=5)
    jm = jfast.FastSRM(n_components=3, n_iter=10,
                       temp_dir=str(tmp_path)).fit(imgs[:4])
    tm = convert.fastsrm_from_jax(jm, device="cpu")
    assert isinstance(tm, fastsrm.FastSRM)
    assert tm.basis_list == jm.basis_list  # the spilled paths, as they are
    assert tm.temp_dir == jm.temp_dir and tm.aggregate == "mean"
    for g, w in zip(tm.transform(imgs[:4]), jm.transform(imgs[:4])):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    shared = jm.transform(imgs[:4])
    for g, w in zip(tm.inverse_transform(shared),
                    jm.inverse_transform(shared)):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    tm.add_subjects(imgs[4:], shared)
    jm.add_subjects(imgs[4:], shared)
    np.testing.assert_allclose(np.load(tm.basis_list[4]),
                               np.load(jm.basis_list[4]), atol=1e-6)
    jm.clean()
