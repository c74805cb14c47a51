"""The port's searchlight and MVPA voxel selector against the JAX
package on the CPU: the ten tests of ``tests/searchlight/
test_searchlight.py`` and the two of ``tests/fcma/
test_mvpa_voxel_selection.py`` run through both packages, and the
traced tier's sweep over two gloo ranks.

Tolerances: the shapes, the host tier, ``run_block_function`` and the
MVPA selector equal, value for value (both packages run the same NumPy
or sklearn function on the same patches); the traced tier in float32
within 1e-6 of the JAX package's (the same statistic in jnp and in
torch); the traced tier in float64 within 1e-10 of it; a mesh of 8 CPU
positions equal to the single sweep and the JAX package's within 1e-6
of the largest value (float32 sums of 135 terms in another order: the
batch changes how torch reduces); the sweep over two ranks (float64)
within 1e-10 of the JAX package's float64 volume.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import svm

import brainiak_tpu.searchlight as jsl
import brainiak_tpu_torch.searchlight.searchlight as tslmod
from brainiak_tpu.fcma.mvpa_voxelselector import \
    MVPAVoxelSelector as JaxMVPA
from brainiak_tpu.searchlight import Searchlight as JaxSearchlight
from brainiak_tpu_torch.fcma.mvpa_voxelselector import MVPAVoxelSelector
from brainiak_tpu_torch.parallel import make_mesh
from brainiak_tpu_torch.parallel.testing import run_distributed
from brainiak_tpu_torch.searchlight import (Ball, Cube, Diamond,
                                            Searchlight, Shape)
from tests.conftest import REPO_ROOT
from tests.parallel.dist_workers import make_searchlight_data
from tests.torch_dist_workers import mean_masked

F32_ATOL = 1e-6
F64_ATOL = 1e-10


def _pair(**kw):
    """The port's and the JAX package's searchlight, same settings."""
    return (Searchlight(device="cpu", **kw),
            JaxSearchlight(**{k: _jax_shape(v) if k == "shape" else v
                              for k, v in kw.items()}))


def _jax_shape(shape):
    return getattr(jsl, shape.__name__)


def _equal_volumes(a, b):
    assert a.shape == b.shape
    for idx in np.ndindex(*a.shape):
        x, y = a[idx], b[idx]
        assert (x is None and y is None) or x == y, idx


def test_shapes():
    for cls in (Cube, Diamond, Ball):
        assert issubclass(cls, Shape)
        for rad in (0, 1, 2, 3):
            np.testing.assert_array_equal(cls(rad).mask_,
                                          _jax_shape(cls)(rad).mask_)
    c = Cube(1)
    assert c.mask_.shape == (3, 3, 3) and c.mask_.all()
    assert Diamond(1).mask_.sum() == 7
    assert np.all(Ball(2).mask_ >= Diamond(2).mask_)
    assert Ball(3).mask_.sum() == 123


def _sum_patch(subjects, msk, myrad, bcast):
    # top-level so the Pool tier can pickle it
    return float(np.sum(subjects[0][msk]))


def test_run_searchlight_matches_oracle():
    rng = np.random.RandomState(0)
    dims = (6, 6, 6, 4)
    data = rng.randn(*dims)
    mask = np.ones(dims[:3], dtype=bool)
    outs = []
    for sl in _pair(sl_rad=1, shape=Cube, pool_size=1):
        sl.distribute([data], mask)
        sl.broadcast(None)
        outs.append(sl.run_searchlight(_sum_patch))
    _equal_volumes(*outs)
    out = outs[0]
    assert out[0, 0, 0] is None
    for (i, j, k) in [(1, 1, 1), (2, 3, 4), (4, 4, 4)]:
        expected = data[i - 1:i + 2, j - 1:j + 2, k - 1:k + 2].sum()
        assert np.isclose(out[i, j, k], expected)


def _one(subjects, msk, myrad, bcast):
    return 1.0


def test_searchlight_min_active_proportion():
    dims = (5, 5, 5, 2)
    data = np.ones(dims)
    mask = np.zeros(dims[:3], dtype=bool)
    mask[2, 2, 2] = True  # single active voxel: 1/27 of Cube(1)
    for prop, want in ((0.5, None), (0, 1.0)):
        outs = []
        for sl in _pair(sl_rad=1, shape=Cube,
                        min_active_voxels_proportion=prop, pool_size=1):
            sl.distribute([data], mask)
            outs.append(sl.run_searchlight(_one))
        _equal_volumes(*outs)
        assert outs[0][2, 2, 2] == want


def test_run_block_function():
    dims = (5, 5, 5, 3)
    data = np.arange(np.prod(dims), dtype=float).reshape(dims)
    mask = np.ones(dims[:3], dtype=bool)

    def block_fn(subjects, msk, rad, bcast, extra):
        assert bcast == 42 and extra == ('x',)
        inner = np.empty((3, 3, 3), dtype=object)
        inner[:] = float(np.sum(subjects[0][1:4, 1:4, 1:4]))
        return inner

    outs = []
    for sl in _pair(sl_rad=1, pool_size=1):
        sl.distribute([data], mask)
        sl.broadcast(42)
        outs.append(sl.run_block_function(block_fn,
                                          extra_block_fn_params=('x',)))
    _equal_volumes(*outs)
    assert outs[0][2, 2, 2] == float(np.sum(data[1:4, 1:4, 1:4]))
    assert outs[0][0, 0, 0] is None


def _corr_jax(patches, mpatch, rad, bcast):
    x, y = patches[0], patches[1]
    xd = x - jnp.mean(x, axis=1, keepdims=True)
    yd = y - jnp.mean(y, axis=1, keepdims=True)
    r = jnp.sum(xd * yd, axis=1) / jnp.sqrt(
        jnp.sum(xd ** 2, axis=1) * jnp.sum(yd ** 2, axis=1))
    return jnp.sum(jnp.where(mpatch, r, 0.0)) / jnp.sum(mpatch)


def _corr_torch(patches, mpatch, rad, bcast):
    x, y = patches[0], patches[1]
    xd = x - x.mean(dim=1, keepdim=True)
    yd = y - y.mean(dim=1, keepdim=True)
    r = torch.sum(xd * yd, dim=1) / torch.sqrt(
        torch.sum(xd ** 2, dim=1) * torch.sum(yd ** 2, dim=1))
    return torch.sum(torch.where(mpatch, r, torch.zeros_like(r))) \
        / torch.sum(mpatch)


def _corr_host(subj, msk, rad, bcast):
    flat0, flat1 = subj[0][msk], subj[1][msk]
    return float(np.mean([np.corrcoef(flat0[v], flat1[v])[0, 1]
                          for v in range(flat0.shape[0])]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_traced_tier_matches_generic(dtype):
    """The traced tier against the JAX package's on the same statistic
    (jnp there, torch here), and against the host tier's NumPy one."""
    rng = np.random.RandomState(1)
    dims = (7, 6, 5, 8)
    subjects = [rng.randn(*dims).astype(dtype) for _ in range(2)]
    mask = rng.rand(*dims[:3]) > 0.2
    sl, jsl_ = _pair(sl_rad=1, shape=Diamond, pool_size=1)
    for s in (sl, jsl_):
        s.distribute(subjects, mask)
        s.broadcast(None)
    host_out = sl.run_searchlight(_corr_host)
    got = sl.run_searchlight_jax(_corr_torch, batch_size=16)
    want = np.asarray(jsl_.run_searchlight_jax(_corr_jax))
    assert got.dtype == dtype
    atol = F32_ATOL if dtype == np.float32 else F64_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    checked = 0
    for (i, j, k) in np.argwhere(mask[1:-1, 1:-1, 1:-1]) + 1:
        if host_out[i, j, k] is not None:
            assert np.isclose(got[i, j, k], host_out[i, j, k],
                              atol=1e-5)
            checked += 1
    assert checked > 10
    assert np.isnan(got[0, 0, 0])


def _sum_jax(patches, mpatch, rad, bcast):
    return jnp.sum(patches[0] * mpatch[:, None])


def _sum_torch(patches, mpatch, rad, bcast):
    return torch.sum(patches[0] * mpatch[:, None])


def test_traced_tier_mesh_matches_single():
    """An 8-position CPU mesh (subject 1 x voxel 8): 64 centres padded
    to 64, and a batch smaller than a position's share."""
    rng = np.random.RandomState(2)
    dims = (6, 6, 6, 5)
    subjects = [rng.randn(*dims).astype(np.float32)]
    mask = np.ones(dims[:3], dtype=bool)
    sl = Searchlight(sl_rad=1, shape=Cube, device="cpu")
    sl.distribute(subjects, mask)
    single = sl.run_searchlight_jax(_sum_torch)
    mesh = make_mesh(("subject", "voxel"), (1, 8), devices=["cpu"] * 8)
    sl_m = Searchlight(sl_rad=1, shape=Cube, mesh=mesh)
    sl_m.distribute(subjects, mask)
    dist = sl_m.run_searchlight_jax(_sum_torch, batch_size=3)
    atol = F32_ATOL * np.nanmax(np.abs(single))
    np.testing.assert_allclose(dist, single, rtol=0, atol=atol)
    jsl_ = JaxSearchlight(sl_rad=1, shape=jsl.Cube)
    jsl_.distribute(subjects, mask)
    np.testing.assert_allclose(dist, np.asarray(jsl_.run_searchlight_jax(
        _sum_jax)), rtol=0, atol=atol)
    # 7 voxel positions do not divide the 64 centres: the last repeats
    mesh7 = make_mesh(("voxel",), (7,), devices=["cpu"] * 7)
    sl_7 = Searchlight(sl_rad=1, shape=Cube, mesh=mesh7)
    sl_7.distribute(subjects, mask)
    np.testing.assert_allclose(sl_7.run_searchlight_jax(_sum_torch),
                               single, rtol=0, atol=atol)


def test_searchlight_pool_tier_matches_serial(monkeypatch):
    """pool_size > 1 streams patches through a process Pool; its volume
    equals the serial tier's and the JAX package's.  The CPU count is
    forced to 2, and the test asserts that the Pool ran."""
    rng = np.random.RandomState(2)
    dims = (6, 6, 6, 3)
    data = rng.randn(*dims)
    mask = np.ones(dims[:3], dtype=bool)
    serial = Searchlight(sl_rad=1, shape=Cube, pool_size=1, device="cpu")
    serial.distribute([data], mask)
    out_serial = serial.run_searchlight(_sum_patch)

    monkeypatch.setattr(tslmod, "usable_cpu_count", lambda: 2)
    orig_pool = tslmod.Pool
    pool_used = []
    monkeypatch.setattr(tslmod, "Pool",
                        lambda n: (pool_used.append(n), orig_pool(n))[1])
    pooled = Searchlight(sl_rad=1, shape=Cube, pool_size=2, device="cpu")
    pooled.distribute([data], mask)
    out_pool = pooled.run_searchlight(_sum_patch)
    assert pool_used == [2]
    _equal_volumes(out_serial, out_pool)
    jser = JaxSearchlight(sl_rad=1, shape=jsl.Cube, pool_size=1)
    jser.distribute([data], mask)
    _equal_volumes(out_pool, jser.run_searchlight(_sum_patch))


def test_searchlight_rad_zero():
    rng = np.random.RandomState(3)
    dims = (4, 4, 4, 2)
    data = rng.randn(*dims)
    mask = np.ones(dims[:3], dtype=bool)
    outs = []
    for sl in _pair(sl_rad=0, pool_size=1):
        sl.distribute([data], mask)
        outs.append(sl.run_searchlight(_sum_patch))
    _equal_volumes(*outs)
    for idx in np.ndindex(*dims[:3]):
        assert np.isclose(outs[0][idx], data[idx].sum())
    sl = Searchlight(sl_rad=0, device="cpu")
    sl.distribute([data], mask)
    np.testing.assert_allclose(sl.run_searchlight_jax(_sum_torch),
                               data.sum(axis=3), rtol=0, atol=F64_ATOL)


def test_traced_tier_edge_inputs():
    """An empty active set returns the float64 fill volume; None
    subject placeholders raise (the host tier's alone)."""
    dims = (4, 4, 4, 2)
    data = np.ones(dims)
    sl = Searchlight(sl_rad=1, shape=Cube, device="cpu")
    sl.distribute([data], np.zeros(dims[:3], dtype=bool))
    out = sl.run_searchlight_jax(_sum_torch, fill_value=-7.0)
    jsl_ = JaxSearchlight(sl_rad=1, shape=jsl.Cube)
    jsl_.distribute([data], np.zeros(dims[:3], dtype=bool))
    want = jsl_.run_searchlight_jax(_sum_jax, fill_value=-7.0)
    assert out.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(out, want)
    assert out.shape == dims[:3] and np.all(out == -7.0)

    sl2 = Searchlight(sl_rad=1, shape=Cube, device="cpu")
    sl2.distribute([None, data], np.ones(dims[:3], dtype=bool))
    with pytest.raises(ValueError, match="None"):
        sl2.run_searchlight_jax(_sum_torch)


def test_searchlight_validation(monkeypatch):
    sl = Searchlight(sl_rad=1, device="cpu")
    with pytest.raises(ValueError):
        sl.distribute([np.zeros((4, 4, 4, 2))], np.ones((5, 5, 5),
                                                        dtype=bool))
    with pytest.raises(AssertionError):
        Searchlight(sl_rad=-1)
    with pytest.raises(AssertionError):
        Searchlight(max_blk_edge=0)
    # the traced tier runs on the card unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sl = Searchlight(sl_rad=1)
    sl.distribute([np.ones((4, 4, 4, 2))], np.ones((4, 4, 4), dtype=bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sl.run_searchlight_jax(_sum_torch)


def test_distribute_drops_the_device_copy():
    """Re-staging data (the same objects mutated in place) is seen."""
    data = np.ones((4, 4, 4, 2))
    mask = np.ones((4, 4, 4), dtype=bool)
    sl = Searchlight(sl_rad=1, device="cpu")
    sl.distribute([data], mask)
    first = sl.run_searchlight_jax(_sum_torch)
    assert sl.run_searchlight_jax(_sum_torch) is not first
    data *= 2
    sl.distribute([data], mask)
    np.testing.assert_array_equal(sl.run_searchlight_jax(_sum_torch)[1:3],
                                  2 * first[1:3])


# -- MVPA voxel selection ----------------------------------------------

def _mvpa_data():
    rng = np.random.RandomState(0)
    dims = (5, 5, 5)
    labels = np.array([0, 1] * 10)
    data = rng.randn(*dims, 20).astype(np.float32)
    data[:2, :2, :2, :] += labels[None, None, None, :] * 3.0
    return data, np.ones(dims, dtype=bool), labels


def test_mvpa_voxel_selection_finds_informative_region():
    """sklearn's linear SVC passed to both packages: equal volumes and
    rankings (the port folds with its own stratified_kfold)."""
    data, mask, labels = _mvpa_data()
    clf = svm.SVC(kernel='linear', shrinking=False, C=1)
    vol, results = MVPAVoxelSelector(
        data, mask, labels, 2,
        Searchlight(sl_rad=1, shape=Cube, pool_size=1)).run(clf)
    jvol, jresults = JaxMVPA(
        data, mask, labels, 2,
        JaxSearchlight(sl_rad=1, shape=jsl.Cube, pool_size=1)).run(clf)
    _equal_volumes(vol, jvol)
    assert results == jresults
    assert vol.shape == mask.shape and len(results) == mask.sum()
    accs = [r[1] for r in results]
    assert accs == sorted(accs, reverse=True)
    assert vol[1, 1, 1] > 0.9
    assert vol[3, 3, 3] < vol[1, 1, 1]
    assert not hasattr(clf, "support_")  # each fold fits a copy


def test_mvpa_voxel_selection_empty_mask():
    data = np.zeros((4, 4, 4, 6), dtype=np.float32)
    mask = np.zeros((4, 4, 4), dtype=bool)
    with pytest.raises(ValueError, match="Zero processed voxels"):
        MVPAVoxelSelector(data, mask, np.array([0, 1] * 3), 2,
                          Searchlight(sl_rad=1))


# -- the traced tier across two ranks ----------------------------------

def test_traced_tier_across_processes():
    """Two gloo ranks of two CPU positions each sweep their own
    positions' centres of ``make_searchlight_data``'s volume; every
    rank returns the whole volume, equal on both, within 1e-10 of the
    JAX package's single-process float64 sweep."""
    results = run_distributed("tests.torch_dist_workers",
                              "searchlight_worker", n_procs=2,
                              local_devices=2, timeout=120,
                              extra_path=REPO_ROOT)
    np.testing.assert_array_equal(results[0], results[1])
    data, mask = make_searchlight_data()
    sl = JaxSearchlight(sl_rad=1)
    sl.distribute(data, mask)

    def voxel_fn(patches, mask_patch, rad, bcast):
        return jnp.mean(patches * mask_patch[None, :, None])

    want = np.asarray(sl.run_searchlight_jax(voxel_fn, batch_size=64),
                      dtype=float)
    np.testing.assert_allclose(results[0], want, rtol=0, atol=F64_ATOL)
    single = Searchlight(sl_rad=1, device="cpu")
    single.distribute(data, mask)
    np.testing.assert_allclose(
        results[0], single.run_searchlight_jax(mean_masked, batch_size=64),
        rtol=0, atol=F64_ATOL)
