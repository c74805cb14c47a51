"""FCMA on a mesh in one process: ``VoxelSelector(mesh=)``, the
sharded-data2 Gram ``distla.block_gram`` and ``use_distla=``, against
the JAX package on its 8-device CPU mesh.

The port's meshes repeat the ``"cpu"`` device; the sizes are the JAX
package's own mesh fixtures (``tests/fcma/test_voxel_selection.py``:
8 epochs, 16 voxels, 2 voxels a position; ``tests/ops/
test_distla.py``: 21 voxels on 8 positions, padded).  Tolerances:
accuracies within 1e-4, as the JAX package holds its own mesh paths;
the Gram within 1e-5 of each voxel's K[0, 0] (float32 sums in another
order).  Where the data are one mask, every voxel meets itself at the
Fisher-z clamp, where the last bit of a float32 r moves the Fisher-z
by O(1) and the port's CPU products round it by their shape: those
runs are held to the reference's band (one test sample a fold), the
1e-4 comparisons run the same sizes with a second mask.
"""

import functools
import logging
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.random import RandomState
from scipy.stats.mstats import zscore
from sklearn import svm

from brainiak_tpu.fcma.voxelselector import VoxelSelector as JaxSelector
from brainiak_tpu.ops import distla as jdistla
from brainiak_tpu.parallel import compat as jcompat
from brainiak_tpu.parallel import make_mesh as jmake_mesh
from brainiak_tpu_torch.fcma import voxelselector as tvs
from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector
from brainiak_tpu_torch.ops import distla
from brainiak_tpu_torch.ops.fcma_kernels import fcma_gram_plain
from brainiak_tpu_torch.parallel import make_mesh, shard_along

ACC_ATOL = 1e-4
GRAM_RTOL = 1e-5
LABELS = [0, 1] * 4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_block_gram(monkeypatch):
    """The JAX package's ``distla.block_gram``, the reference, built
    without shard_map's varying-axes type check (jax releases with that
    check reject the JAX package's distla programs; it is a type check
    only).  Its program cache is cleared before and after."""
    monkeypatch.setattr(jdistla, "shard_map", functools.partial(
        jcompat.shard_map, check_vma=False))
    jdistla._block_gram_program.cache_clear()
    yield jdistla.block_gram
    jdistla._block_gram_program.cache_clear()


def create_epoch(prng, col):
    """The reference fixture's synthetic epoch recipe."""
    mat = prng.rand(12, col).astype(np.float32)
    mat = np.nan_to_num(zscore(mat, axis=0, ddof=0))
    return mat / math.sqrt(mat.shape[0])


def _masks(col, seed=1234567890, two=True):
    prng = RandomState(seed)
    d1 = [create_epoch(prng, col) for _ in range(8)]
    d2 = [create_epoch(prng, col) for _ in range(8)] if two else None
    return d1, d2


def _cpu_mesh(n=8, names=("voxel",), sizes=None):
    return make_mesh(names, sizes or (n,), devices=["cpu"] * n)


def _accs(results):
    assert sorted(v for v, _ in results) == list(range(len(results)))
    return np.array([a for _, a in sorted(results)])


def _close(got, want, atol=ACC_ATOL):
    np.testing.assert_allclose(_accs(got), _accs(want), rtol=0, atol=atol)


@pytest.mark.parametrize("names,sizes", [(("voxel",), (8,)),
                                         (("subject", "voxel"), (1, 8))])
def test_mesh_matches_jax_mesh_and_meshless(names, sizes):
    """Blocks split over 8 voxel positions (2 voxels a position)
    against the JAX package's mesh run and the port's meshless run."""
    d1, d2 = _masks(16)
    got = VoxelSelector(LABELS, 4, 2, d1, raw_data2=d2, voxel_unit=2,
                        mesh=_cpu_mesh(8, names, sizes),
                        device="cpu").run('svm')
    want = JaxSelector(LABELS, 4, 2, d1, raw_data2=d2, voxel_unit=2,
                       mesh=jmake_mesh(names, sizes),
                       use_pallas=False).run('svm')
    _close(got, want)
    _close(got, VoxelSelector(LABELS, 4, 2, d1, raw_data2=d2,
                              voxel_unit=4, device="cpu").run('svm'))


def test_mesh_one_mask_holds_the_band():
    """The JAX package's one-mask mesh fixture: within one test sample
    a fold of the JAX mesh run and of the port's meshless run."""
    d1, _ = _masks(16, two=False)
    got = _accs(VoxelSelector(LABELS, 4, 2, d1, voxel_unit=2,
                              mesh=_cpu_mesh(), device="cpu").run('svm'))
    for want in (JaxSelector(LABELS, 4, 2, d1, voxel_unit=2,
                             mesh=jmake_mesh(("voxel",), (8,)),
                             use_pallas=False).run('svm'),
                 VoxelSelector(LABELS, 4, 2, d1, voxel_unit=4,
                               device="cpu").run('svm')):
        assert np.max(np.abs(got - _accs(want))) <= 2 / 8 + 1e-6


def test_mesh_runs_k1_once_a_position(monkeypatch):
    """Each block is split over the positions and each position runs
    K1 (its plain version here) once a block on its slice; the SMO
    runs once a distinct device.  16 voxels, 4 positions, voxel_unit 2:
    two blocks of 8."""
    calls, solves = [], []
    real_gram, real_cv = tvs.fcma_gram, tvs.svm_cv_accuracy
    monkeypatch.setattr(tvs, "fcma_gram", lambda blk, *a, **k: (
        calls.append(blk.shape[2]), real_gram(blk, *a, **k))[1])
    monkeypatch.setattr(tvs, "svm_cv_accuracy", lambda kernels, *a, **k: (
        solves.append(kernels.shape[0]), real_cv(kernels, *a, **k))[1])
    d1, d2 = _masks(16)
    VoxelSelector(LABELS, 4, 2, d1, raw_data2=d2, voxel_unit=2,
                  mesh=_cpu_mesh(4), device="cpu").run('svm')
    assert calls == [2] * 8 and solves == [16]


@pytest.mark.parametrize("n_vox", [24, 21])
def test_block_gram_matches_jax(jax_block_gram, n_vox):
    """The Gram of a 5-voxel block against 24 or 21 voxels (3 zero pad
    columns) split over 8 positions, from the array and from data2
    already split, against the JAX package's block_gram and the port's
    K1 (plain) on the whole data2."""
    rng = np.random.RandomState(n_vox)
    stack = rng.randn(8, 12, 5 + n_vox).astype(np.float32)
    stack /= np.linalg.norm(stack, axis=1, keepdims=True)
    blk, data2 = stack[:, :, :5], stack[:, :, 5:]
    mesh = _cpu_mesh()
    got = distla.block_gram(blk, data2, mesh, 4).numpy()
    jmesh = jmake_mesh(("voxel",), (8,))
    pad = (-n_vox) % 8
    want = np.asarray(jax_block_gram(
        jnp.asarray(blk), jnp.pad(jnp.asarray(data2),
                                  ((0, 0), (0, 0), (0, pad))), jmesh, 4))
    k00 = want[:, 0, 0][:, None, None]
    assert np.max(np.abs(got - want) / k00) <= GRAM_RTOL
    whole = fcma_gram_plain(torch.from_numpy(blk), torch.from_numpy(data2),
                            4).numpy()
    assert np.max(np.abs(got - whole) / k00) <= GRAM_RTOL
    padded = np.pad(data2, ((0, 0), (0, 0), (0, pad)))
    split = distla.block_gram(torch.from_numpy(blk),
                              shard_along(padded, mesh, "voxel", 2), mesh,
                              4).numpy()
    np.testing.assert_array_equal(split, got)


def test_block_gram_runs_k1_once_a_shard(monkeypatch):
    calls = []
    real = distla.fcma_gram
    monkeypatch.setattr(distla, "fcma_gram", lambda blk, shard, *a, **k: (
        calls.append(shard.shape[2]), real(blk, shard, *a, **k))[1])
    stack = np.random.RandomState(3).randn(8, 12, 26).astype(np.float32)
    distla.block_gram(stack[:, :, :5], stack[:, :, 5:], _cpu_mesh(4), 4)
    assert calls == [6] * 4


def test_distla_matches_jax_and_replicated():
    """use_distla=True on 21 voxels (data2 padded to the 8 positions)
    against the JAX package's distla run and the port's replicated
    and meshless runs."""
    d1, d2 = _masks(21, seed=0)
    mesh = _cpu_mesh()
    vs = VoxelSelector(LABELS, 4, 2, d1, raw_data2=d2, voxel_unit=7,
                       mesh=mesh, use_distla=True, device="cpu")
    assert vs.use_distla and not vs._distla_auto
    got = vs.run('svm')
    _close(got, JaxSelector(LABELS, 4, 2, d1, raw_data2=d2, voxel_unit=7,
                            mesh=jmake_mesh(("voxel",), (8,)),
                            use_pallas=False,
                            use_distla=True).run('svm'))
    for kw in (dict(mesh=mesh, use_distla=False), {}):
        _close(got, VoxelSelector(LABELS, 4, 2, d1, raw_data2=d2,
                                  voxel_unit=7, device="cpu",
                                  **kw).run('svm'))
    with pytest.raises(ValueError, match="on-device SVM"):
        vs.run(svm.SVC(kernel='precomputed'))
    with pytest.raises(ValueError, match="mesh"):
        VoxelSelector(LABELS, 4, 2, d1, use_distla=True, device="cpu")


def test_distla_auto_falls_back_for_host_cv(caplog):
    """A 1-byte budget engages use_distla='auto'; a host-CV run() then
    degrades to the replicated layout with the JAX package's warning,
    and the sharded path is restored after it."""
    d1, d2 = _masks(16, seed=5)
    mesh = _cpu_mesh()
    vs = VoxelSelector(LABELS, 4, 2, d1, raw_data2=d2, voxel_unit=4,
                       mesh=mesh, replicated_budget_bytes=1, device="cpu")
    assert vs.use_distla and vs._distla_auto
    assert not VoxelSelector(LABELS, 4, 2, d1, raw_data2=d2, mesh=mesh,
                             device="cpu").use_distla
    assert not VoxelSelector(LABELS, 4, 2, d1, raw_data2=d2,
                             replicated_budget_bytes=1,
                             device="cpu").use_distla
    clf = svm.SVC(kernel='precomputed', shrinking=False, C=1)
    with caplog.at_level(logging.WARNING,
                         logger="brainiak_tpu_torch.fcma.voxelselector"):
        host = vs.run(clf)
    assert any("falling back" in r.message for r in caplog.records)
    assert vs.use_distla
    _close(host, VoxelSelector(LABELS, 4, 2, d1, raw_data2=d2,
                               voxel_unit=4, device="cpu").run(clf))
    jvs = JaxSelector(LABELS, 4, 2, d1, raw_data2=d2, voxel_unit=4,
                      mesh=jmake_mesh(("voxel",), (8,)), use_pallas=False,
                      replicated_budget_bytes=1)
    _close(host, jvs.run(clf))
    _close(vs.run('svm'), jvs.run('svm'))


def test_mesh_host_cv_matches_jax():
    """run(clf) with a precomputed SVC on a mesh: K3 (plain) a position
    and host CV, against the JAX package's mesh run."""
    d1, d2 = _masks(16, seed=11)
    clf = svm.SVC(kernel='precomputed', shrinking=False, C=1)
    got = VoxelSelector(LABELS, 4, 2, d1, raw_data2=d2, voxel_unit=2,
                        mesh=_cpu_mesh(), device="cpu").run(clf)
    _close(got, JaxSelector(LABELS, 4, 2, d1, raw_data2=d2, voxel_unit=2,
                            mesh=jmake_mesh(("voxel",), (8,)),
                            use_pallas=False).run(clf))


def test_mesh_without_voxel_axis_raises():
    d1, _ = _masks(16, two=False)
    with pytest.raises(ValueError, match="voxel"):
        VoxelSelector(LABELS, 4, 2, d1, mesh=_cpu_mesh(8, ("subject",)),
                      device="cpu").run('svm')
    with pytest.raises(ValueError, match="voxel"):
        JaxSelector(LABELS, 4, 2, d1, mesh=jmake_mesh(("subject",), (8,)),
                    use_pallas=False).run('svm')
