"""The port's ISC / ISFC against the JAX package on the CPU.

The same float64 numpy arrays, made from a seed, go through
``brainiak_tpu.isc`` (float64 here: the harness turns x64 on) and
``brainiak_tpu_torch.isc`` on ``device="cpu"`` (float32).  Tolerance:
1e-5 absolute on correlations, which lie in [-1, 1] (float32 sums over
T in another order); NaN positions must match exactly.  The mesh paths
run on the JAX package's 8-device CPU mesh and on meshes of repeated
``"cpu"`` devices in the port.
"""

import functools

import numpy as np
import pytest
import torch

from brainiak_tpu import isc as jisc
from brainiak_tpu.ops import distla as jdistla
from brainiak_tpu.parallel import compat as jcompat
from brainiak_tpu.parallel import make_mesh as jmake_mesh
from brainiak_tpu.stats import pvalues as jpvalues
from brainiak_tpu.utils import utils as jutils
from brainiak_tpu_torch import isc as tisc
from brainiak_tpu_torch.ops.kernels import ring as kring
from brainiak_tpu_torch.parallel import make_mesh
from brainiak_tpu_torch.stats import pvalues as tpvalues
from brainiak_tpu_torch.utils import utils as tutils

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_ring(monkeypatch):
    """The JAX package's ring ISFC, the reference (see the fixture of
    the same name in ``tests/test_torch_distla.py``: the ring's
    shard_map is built without the varying-axes type check)."""
    monkeypatch.setattr(jdistla, "shard_map", functools.partial(
        jcompat.shard_map, check_vma=False))
    jdistla._summa_program.cache_clear()
    yield
    jdistla._summa_program.cache_clear()


def _timeseries(seed, n_subjects, n_trs=30, n_voxels=6, nans=True):
    """Shared signal + independent noise per subject -> [T, V, S], with
    NaNs in voxel 1 of subject 0 and in voxel 3 of every subject but
    the last (so the 0.5 threshold drops voxel 3)."""
    prng = np.random.RandomState(seed)
    signal = prng.randn(n_trs, n_voxels)
    data = np.dstack([signal + prng.randn(n_trs, n_voxels)
                      for _ in range(n_subjects)])
    if nans:
        data[2, 1, 0] = np.nan
        data[4, 3, :-1] = np.nan
    return data


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                               equal_nan=True)


def _cpu_mesh(n=4):
    return make_mesh(("voxel",), (n,), devices=["cpu"] * n)


@pytest.mark.parametrize("tolerate_nans", [True, 0.5, False])
@pytest.mark.parametrize("summary_statistic", [None, "mean", "median"])
@pytest.mark.parametrize("pairwise", [False, True])
def test_isc_matches_jax(pairwise, summary_statistic, tolerate_nans):
    data = _timeseries(0, 5)
    kw = dict(pairwise=pairwise, summary_statistic=summary_statistic,
              tolerate_nans=tolerate_nans)
    _close(tisc.isc(data, device="cpu", **kw), jisc.isc(data, **kw))


@pytest.mark.parametrize("tolerate_nans", [True, 0.5, False])
@pytest.mark.parametrize("summary_statistic", [None, "mean", "median"])
@pytest.mark.parametrize("pairwise", [False, True])
def test_isfc_matches_jax(pairwise, summary_statistic, tolerate_nans):
    data = _timeseries(1, 5)
    kw = dict(pairwise=pairwise, summary_statistic=summary_statistic,
              tolerate_nans=tolerate_nans)
    got = tisc.isfc(data, device="cpu", **kw)
    want = jisc.isfc(data, **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("vectorize", [True, False])
def test_isfc_square_and_vectorized_forms(vectorize):
    data = _timeseries(2, 6, nans=False)
    got = tisc.isfc(data, vectorize_isfcs=vectorize, device="cpu")
    want = jisc.isfc(data, vectorize_isfcs=vectorize)
    if vectorize:
        for g, w in zip(got, want):
            _close(g, w)
        back = tisc.squareform_isfc(*got)
        _close(back, jisc.squareform_isfc(*want))
    else:
        _close(got, want)
        v, d = tisc.squareform_isfc(got)
        wv, wd = jisc.squareform_isfc(want)
        _close(v, wv)
        _close(d, wd)
        one_v, one_d = tisc.squareform_isfc(got[0])
        _close(tisc.squareform_isfc(one_v, one_d), got[0])


def test_two_subjects_match_jax():
    data = _timeseries(3, 2, nans=False)
    _close(tisc.isc(data, device="cpu"), jisc.isc(data))
    _close(tisc.isc(data, summary_statistic="mean", device="cpu"),
           jisc.isc(data, summary_statistic="mean"))
    _close(tisc.isfc(data, vectorize_isfcs=False, device="cpu"),
           jisc.isfc(data, vectorize_isfcs=False))
    for g, w in zip(tisc.isfc(data, device="cpu"), jisc.isfc(data)):
        _close(g, w)


@pytest.mark.parametrize("summary_statistic", [None, "mean"])
def test_isfc_asymmetric_targets_match_jax(summary_statistic):
    data = _timeseries(4, 5, n_voxels=4)
    targets = _timeseries(5, 5, n_voxels=7, nans=False)
    got = tisc.isfc(data, targets=targets, device="cpu",
                    summary_statistic=summary_statistic)
    want = jisc.isfc(data, targets=targets,
                     summary_statistic=summary_statistic)
    assert got.shape == ((5, 4, 7) if summary_statistic is None
                         else (4, 7))
    _close(got, want)
    # pairwise is ignored with targets, as in the reference
    _close(tisc.isfc(data, targets=targets, pairwise=True, device="cpu"),
           jisc.isfc(data, targets=targets, pairwise=True))
    with pytest.raises(ValueError, match="subjects"):
        tisc.isfc(data, targets=targets[..., :-1], device="cpu")
    with pytest.raises(ValueError, match="TRs"):
        tisc.isfc(data, targets=targets[:-1], device="cpu")


def test_isc_inputs_and_errors():
    data = _timeseries(6, 5, nans=False)
    listed = [data[..., s] for s in range(5)]
    _close(tisc.isc(listed, device="cpu"), tisc.isc(data, device="cpu"))
    with pytest.raises(ValueError, match="mean"):
        tisc.isc(data, summary_statistic="std", device="cpu")
    with pytest.raises(ValueError, match="between"):
        tisc.isc(data, tolerate_nans=1.5, device="cpu")
    with pytest.raises(ValueError, match="dimensions"):
        tisc.isc(data[None], device="cpu")
    with pytest.raises(ValueError, match="same shape"):
        tisc.isc([data[..., 0], data[:5, :, 1]], device="cpu")


@pytest.mark.parametrize("pairwise", [False, True])
def test_isc_mesh_matches_no_mesh_and_jax(pairwise):
    """13 voxels on 4 positions: the voxel axis is NaN-padded and the
    pad sliced off."""
    data = _timeseries(7, 5, n_voxels=13)
    got = tisc.isc(data, pairwise=pairwise, mesh=_cpu_mesh(),
                   device="cpu")
    _close(got, tisc.isc(data, pairwise=pairwise, device="cpu"))
    _close(got, jisc.isc(data, pairwise=pairwise,
                         mesh=jmake_mesh(("voxel",), (8,))))


@pytest.mark.parametrize("tolerate_nans", [True, False])
def test_isfc_mesh_matches_jax_mesh_and_no_mesh(jax_ring, tolerate_nans):
    """The ring ISFC against the JAX ring ISFC and the port's dense
    path, with a partly NaN voxel kept by the threshold."""
    data = _timeseries(8, 5, n_trs=40, n_voxels=16, nans=False)
    data[:5, 2, 1] = np.nan
    got = tisc.isfc(data, vectorize_isfcs=False, mesh=_cpu_mesh(),
                    tolerate_nans=tolerate_nans, device="cpu")
    want = jisc.isfc(data, vectorize_isfcs=False,
                     mesh=jmake_mesh(("voxel",), (8,)),
                     tolerate_nans=tolerate_nans)
    _close(got, want)
    _close(got, tisc.isfc(data, vectorize_isfcs=False,
                          tolerate_nans=tolerate_nans, device="cpu"))
    for g, w in zip(tisc.isfc(data, mesh=_cpu_mesh(), device="cpu"),
                    jisc.isfc(data, mesh=jmake_mesh(("voxel",), (8,)))):
        _close(g, w)


def test_isfc_constant_voxel_keeps_each_paths_reference(jax_ring):
    """A constant voxel: the ring's z-score gives it correlation 0, the
    dense Pearson NaN (0/0), in both packages."""
    data = _timeseries(9, 5, n_voxels=8, nans=False)
    data[:, 4, :] = 1.5
    ring = tisc.isfc(data, vectorize_isfcs=False, mesh=_cpu_mesh(),
                     device="cpu")
    dense = tisc.isfc(data, vectorize_isfcs=False, device="cpu")
    _close(ring, jisc.isfc(data, vectorize_isfcs=False,
                           mesh=jmake_mesh(("voxel",), (8,))))
    _close(dense, jisc.isfc(data, vectorize_isfcs=False))
    assert np.all(ring[:, 4, :] == 0)
    assert np.all(np.isnan(dense[:, 4, :]))


def test_isfc_mesh_counts_no_launch_on_the_cpu():
    data = _timeseries(10, 4, n_voxels=8, nans=False)
    kring.reset_launches()
    tisc.isfc(data, mesh=_cpu_mesh(2), device="cpu")
    assert kring.launches() == 0


def test_isfc_mesh_errors():
    data = _timeseries(11, 5, n_voxels=12, nans=False)
    mesh = _cpu_mesh()
    with pytest.raises(ValueError, match="more than 2"):
        tisc.isfc(data[..., :2], mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="leave-one-out"):
        tisc.isfc(data, pairwise=True, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="same voxel count"):
        tisc.isfc(data, targets=data[:, :8], mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tisc.isfc(data[:, :10], mesh=mesh, device="cpu")


def test_isc_and_isfc_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _timeseries(12, 3, nans=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tisc.isc(data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tisc.isfc(data)


def test_copied_helpers_match_jax():
    rng = np.random.RandomState(13)
    iscs = rng.uniform(-0.9, 0.9, size=(6, 5))
    iscs[2, 3] = np.nan
    for stat in ("mean", "median"):
        for axis in (None, 0):
            np.testing.assert_allclose(
                tpvalues.compute_summary_statistic(iscs, stat, axis=axis),
                jpvalues.compute_summary_statistic(iscs, stat, axis=axis),
                rtol=1e-12)
    x, y = rng.randn(20, 4), rng.randn(20, 4)
    for axis in (0, 1):
        np.testing.assert_allclose(
            tutils.array_correlation(x, y, axis=axis),
            jutils.array_correlation(x, y, axis=axis), rtol=1e-12)
    with pytest.raises(ValueError, match="same shape"):
        tutils.array_correlation(x, y[:, :3])
    for data in (rng.randn(10, 3), [rng.randn(10, 2), rng.randn(10, 2)],
                 [rng.randn(10), rng.randn(10)]):
        got = tutils._check_timeseries_input(data)
        want = jutils._check_timeseries_input(data)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
