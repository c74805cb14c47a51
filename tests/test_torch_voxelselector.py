"""FCMA voxel selection end to end: brainiak_tpu_torch against the JAX
package on the CPU.

The whole slice (prepare_fcma_data -> VoxelSelector.run) runs on the
same synthetic images in both packages; the port's selector is built
from the JAX one by ``convert.voxel_selector_from_jax``.  Voxel
accuracies agree exactly on the golden fixtures where no correlation
sits at the Fisher-z clamp, and elsewhere on >= 95% of voxels, never
off by more than one test sample per fold.
"""

import ast
import logging
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from numpy.random import RandomState
from scipy.stats.mstats import zscore
from sklearn import svm
from sklearn.linear_model import LogisticRegression

from brainiak_tpu.fcma import preprocessing as jprep
from brainiak_tpu.fcma.voxelselector import VoxelSelector as JaxSelector
from brainiak_tpu_torch.convert import voxel_selector_from_jax
from brainiak_tpu_torch.fcma import preprocessing as tprep
from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def create_epoch(prng, col=5):
    """The reference fixture's synthetic epoch recipe."""
    mat = prng.rand(12, col).astype(np.float32)
    mat = np.nan_to_num(zscore(mat, axis=0, ddof=0))
    return mat / math.sqrt(mat.shape[0])


def _counts(results, n_voxels, n_epochs=8):
    out = [None] * n_voxels
    for vid, acc in results:
        out[vid] = int(round(n_epochs * acc))
    return out


def _synthetic(seed, n_subj=3, shape=(4, 4, 3), n_trs=40):
    """Images with a condition-dependent coupling between voxel 0 and a
    few others, the per-subject condition specs (2 conditions x 2
    epochs of 8 TRs), and two disjoint masks (10 and 38 voxels), so
    that no correlation sits at the Fisher-z clamp."""
    rng = np.random.RandomState(seed)
    n_vox = int(np.prod(shape))
    images, conditions = [], []
    for _ in range(n_subj):
        data = rng.randn(n_vox, n_trs)
        for start in (10, 30):  # condition 1 epochs
            data[1:6, start:start + 8] += data[0, start:start + 8]
        images.append(data.reshape(shape + (n_trs,)).astype(np.float32))
        cond = np.zeros((2, 2, n_trs), dtype=np.int64)
        cond[0, 0, 0:8] = cond[0, 1, 20:28] = 1
        cond[1, 0, 10:18] = cond[1, 1, 30:38] = 1
        conditions.append(cond)
    mask1 = np.zeros(shape, dtype=bool)
    mask1.flat[:10] = True
    return images, conditions, mask1, ~mask1


def _assert_accs_close(got, want, n_epochs, n_folds):
    got, want = dict(got), dict(want)
    assert sorted(got) == sorted(want)
    g = np.array([got[k] for k in sorted(got)])
    w = np.array([want[k] for k in sorted(want)])
    assert np.mean(np.isclose(g, w, rtol=0, atol=1e-6)) >= 0.95
    assert np.max(np.abs(g - w)) <= n_folds / n_epochs + 1e-6


@pytest.mark.parametrize("two_masks", [False, True])
def test_prepare_fcma_data_matches_jax(two_masks):
    images, conds, mask1, mask2 = _synthetic(0)
    m2 = mask2 if two_masks else None
    want = jprep.prepare_fcma_data(images, conds, mask1, m2)
    got = tprep.prepare_fcma_data(images, conds, mask1, m2, device="cpu")
    assert got[2] == want[2] == [0, 0, 1, 1] * 3
    for g_list, w_list in zip(got[:2], want[:2]):
        if w_list is None:
            assert g_list is None
            continue
        assert len(g_list) == len(w_list) == 12
        for g, w in zip(g_list, w_list):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_whole_slice_matches_jax(use_pallas):
    """Synthetic images through prepare_fcma_data + VoxelSelector in
    both packages (JAX: XLA path, or the Pallas kernels in interpreter
    mode); the port's selector comes from convert.py."""
    images, conds, mask1, mask2 = _synthetic(1)
    raw1, raw2, labels = jprep.prepare_fcma_data(images, conds, mask1,
                                                 mask2)
    jvs = JaxSelector(labels, 4, 3, raw1, raw_data2=raw2, voxel_unit=4,
                      use_pallas=use_pallas)
    want = jvs.run('svm')
    tvs = voxel_selector_from_jax(jvs, device="cpu")
    assert tvs.voxel_unit == 4 and tvs.num_voxels2 == 38
    got = tvs.run('svm')
    _assert_accs_close(got, want, n_epochs=12, n_folds=3)
    t1, t2, tl = tprep.prepare_fcma_data(images, conds, mask1, mask2,
                                         device="cpu")
    own = VoxelSelector(tl, 4, 3, t1, raw_data2=t2, device="cpu").run('svm')
    _assert_accs_close(own, want, n_epochs=12, n_folds=3)


def test_one_mask_golden_band_and_host_cv_agree():
    """One mask: the self-correlations sit at the Fisher-z clamp, so the
    port holds the reference's own band (one epoch of the golden
    counts) and its on-device SVM equals its host SVC exactly."""
    prng = RandomState(1234567890)
    data = [create_epoch(prng) for _ in range(8)]
    labels = [0, 1, 0, 1, 0, 1, 0, 1]
    vs = VoxelSelector(labels, 4, 2, data, voxel_unit=1, device="cpu")
    dev = _counts(vs.run('svm'), 5)
    clf = svm.SVC(kernel='precomputed', shrinking=False, C=1, gamma='auto')
    assert dev == _counts(vs.run(clf), 5)
    assert np.allclose(dev, [7, 4, 6, 4, 4], atol=1)
    assert np.allclose(_counts(vs.run(LogisticRegression()), 5),
                       [6, 3, 6, 4, 4], atol=1)


def test_two_mask_golden_exact_vs_jax():
    """Two masks (no clamp): exact agreement with the JAX package on
    the reference golden counts, for the on-device SVM and both
    host-CV classifiers."""
    prng = RandomState(1234567890)
    d1 = [create_epoch(prng) for _ in range(8)]
    d2 = [create_epoch(prng) for _ in range(8)]
    labels = [0, 1, 0, 1, 0, 1, 0, 1]
    jvs = JaxSelector(labels, 4, 2, d1, raw_data2=d2, voxel_unit=1)
    tvs = voxel_selector_from_jax(jvs, device="cpu")
    clf = svm.SVC(kernel='precomputed', shrinking=False, C=1, gamma='auto')
    for c in ('svm', clf, LogisticRegression()):
        assert _counts(tvs.run(c), 5) == _counts(jvs.run(c), 5)
    assert _counts(tvs.run('svm'), 5) == [3, 3, 7, 5, 7]


def test_host_cv_matches_jax_host_cv():
    images, conds, mask1, mask2 = _synthetic(2)
    raw1, raw2, labels = jprep.prepare_fcma_data(images, conds, mask1,
                                                 mask2)
    jvs = JaxSelector(labels, 4, 3, raw1, raw_data2=raw2, voxel_unit=4)
    tvs = voxel_selector_from_jax(jvs, device="cpu")
    clf = svm.SVC(kernel='precomputed', shrinking=False, C=1)
    _assert_accs_close(tvs.run(clf), jvs.run(clf), n_epochs=12, n_folds=3)


def test_block_sizes_agree():
    prng = RandomState(1234567890)
    data = [create_epoch(prng, col=11) for _ in range(8)]
    data2 = [create_epoch(prng, col=7) for _ in range(8)]
    labels = [0, 1, 0, 1, 0, 1, 0, 1]
    runs = [sorted(VoxelSelector(labels, 4, 2, data, raw_data2=data2,
                                 voxel_unit=unit, device="cpu").run('svm'))
            for unit in (3, 11, 64)]
    for vid in range(11):
        assert runs[0][vid][1] == pytest.approx(runs[1][vid][1], abs=1e-6)
        assert runs[0][vid][1] == pytest.approx(runs[2][vid][1], abs=1e-6)


def test_multiclass_matches_jax():
    prng = RandomState(7)
    data = [create_epoch(prng, col=6) for _ in range(12)]
    data2 = [create_epoch(prng, col=9) for _ in range(12)]
    labels = [0, 1, 2] * 4
    jvs = JaxSelector(labels, 6, 3, data, raw_data2=data2, voxel_unit=3)
    got = voxel_selector_from_jax(jvs, device="cpu").run('svm')
    _assert_accs_close(got, jvs.run('svm'), n_epochs=12, n_folds=3)


def test_kkt_gap_warning(caplog):
    prng = RandomState(1234567890)
    data = [create_epoch(prng, col=8) for _ in range(8)]
    vs = VoxelSelector([0, 1] * 4, 4, 2, data, svm_iters=0, device="cpu")
    with caplog.at_level(logging.WARNING,
                         logger="brainiak_tpu_torch.fcma.voxelselector"):
        vs.run('svm')
    assert any("KKT" in r.message for r in caplog.records)


def test_selector_errors():
    prng = RandomState(0)
    data = [create_epoch(prng) for _ in range(4)]
    labels = [0, 1, 0, 1]
    with pytest.raises(ValueError):
        VoxelSelector(labels, 2, 2, data, raw_data2=data[:-1],
                      device="cpu")
    with pytest.raises(ValueError):
        VoxelSelector(labels, 2, 2, [d[:, :0] for d in data], device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        VoxelSelector(labels, 2, 2, data, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        VoxelSelector(labels, 2, 2, data, use_distla=True, device="cpu")
    with pytest.raises(ValueError, match="highest"):
        VoxelSelector(labels, 2, 2, data, precision="hihgest",
                      device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prng = RandomState(0)
    data = [create_epoch(prng) for _ in range(4)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VoxelSelector([0, 1, 0, 1], 2, 2, data)
    images, conds, mask1, _ = _synthetic(3, n_subj=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprep.prepare_fcma_data(images, conds, mask1)


def test_cuda_selector_refuses_subjects_over_one_epoch_tile(monkeypatch):
    """A subject longer than one 32-epoch kernel tile spans several:
    the selector takes such a design on CUDA, as on the CPU, and the
    kernels' tiling covers it.  (The name is the one this test had
    while such a design was refused; it is kept so that the test's id
    stays the same across that change.)"""
    from brainiak_tpu_torch.ops.fcma_kernels import epoch_tiles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    prng = RandomState(0)
    data = [create_epoch(prng) for _ in range(80)]
    labels = [0, 1] * 40
    vs = VoxelSelector(labels, 40, 2, data)
    assert vs.device == torch.device("cuda")
    assert epoch_tiles(len(labels), vs.epochs_per_subj) == (32, 32, 3)
    vs = VoxelSelector(labels, 40, 2, data, device="cpu")
    assert vs.device == torch.device("cpu")


def test_stack_lays_data2_out_once_with_aligned_rows(monkeypatch):
    """V = 37, not a multiple of 4, 4 epochs a subject: data2 is laid
    out once per selector, its rows 16-byte aligned, and every K3 call
    of run(clf), in every block and on every run, gets that one
    tensor, which K3's tensor-core route reads in place (no copy a
    call)."""
    from brainiak_tpu_torch.fcma import voxelselector as tvs
    from brainiak_tpu_torch.ops import fcma_kernels as tk

    prng = RandomState(5)
    d1 = [create_epoch(prng, col=10) for _ in range(8)]
    d2 = [create_epoch(prng, col=37) for _ in range(8)]
    layouts, seen = [], []
    layout, k3 = tvs.corr_layout, tvs.fcma_corr_normalize

    def counted_layout(shape, eps, device):
        layouts.append(tuple(shape))
        return layout(shape, eps, device)

    def recorded_k3(blk, data, eps, precision=None):
        seen.append(data)
        return k3(blk, data, eps, precision=precision)

    monkeypatch.setattr(tvs, "corr_layout", counted_layout)
    monkeypatch.setattr(tvs, "fcma_corr_normalize", recorded_k3)
    vs = VoxelSelector([0, 1] * 4, 4, 2, d1, raw_data2=d2, voxel_unit=3,
                       device="cpu")
    clf = svm.SVC(kernel='precomputed', shrinking=False, C=1)
    assert vs.run(clf) == vs.run(clf)
    _, data2 = vs._stack()
    assert layouts == [(8, 12, 10), (8, 12, 37)]
    assert data2.shape == (8, 12, 37) and data2.stride(1) % 4 == 0
    assert data2.data_ptr() % 16 == 0
    assert torch.equal(data2, torch.from_numpy(np.stack(d2)))
    assert len(seen) == 2 * 4  # 10 voxels in blocks of 3, two runs
    assert all(x is data2 for x in seen)
    assert tk.corr_route(8, 4) == "tc"
    assert tk._corr_operand(data2, "tc") is data2


def test_stack_keeps_data2_contiguous_for_the_fma_route(monkeypatch):
    """V = 37 and 8 epochs a subject, which K3 runs on its long-subject
    tensor-core kernel (csrc/fcma_corr_tcl.cu; fcma_corr.cu's FMA
    kernel, which reads a contiguous tensor, runs only when forced):
    data2 is stacked once, its rows 16-byte aligned, and every K3 call
    of run(clf) gets that tensor, which the kernel reads in place (no
    copy a block)."""
    from brainiak_tpu_torch.fcma import voxelselector as tvs
    from brainiak_tpu_torch.ops import fcma_kernels as tk

    prng = RandomState(7)
    d1 = [create_epoch(prng, col=10) for _ in range(16)]
    d2 = [create_epoch(prng, col=37) for _ in range(16)]
    seen = []
    k3 = tvs.fcma_corr_normalize

    def recorded_k3(blk, data, eps, precision=None):
        seen.append(data)
        return k3(blk, data, eps, precision=precision)

    monkeypatch.setattr(tvs, "fcma_corr_normalize", recorded_k3)
    vs = VoxelSelector([0, 1] * 8, 8, 2, d1, raw_data2=d2, voxel_unit=3,
                       device="cpu")
    clf = svm.SVC(kernel='precomputed', shrinking=False, C=1)
    assert vs.run(clf) == vs.run(clf)
    _, data2 = vs._stack()
    assert data2.shape == (16, 12, 37) and data2.stride(1) % 4 == 0
    assert data2.data_ptr() % 16 == 0
    assert torch.equal(data2, torch.from_numpy(np.stack(d2)))
    assert len(seen) == 2 * 4  # 10 voxels in blocks of 3, two runs
    assert all(x is data2 for x in seen)
    assert tk.corr_route(16, 8) == "tcl"
    assert tk._corr_operand(data2, "tcl") is data2


@pytest.mark.parametrize("one_mask", [False, True])
def test_run_clf_unchanged_by_the_aligned_layout(monkeypatch, one_mask):
    """run(clf) on the CPU gives the same accuracies with the aligned
    layout of _stack as with plain contiguous stacks."""
    from brainiak_tpu_torch.fcma import voxelselector as tvs

    prng = RandomState(6)
    d1 = [create_epoch(prng, col=9) for _ in range(8)]
    d2 = None if one_mask else [create_epoch(prng, col=37)
                                for _ in range(8)]
    labels = [0, 1] * 4
    for clf in (svm.SVC(kernel='precomputed', shrinking=False, C=1),
                LogisticRegression()):
        got = VoxelSelector(labels, 4, 2, d1, raw_data2=d2, voxel_unit=4,
                            device="cpu").run(clf)
        with monkeypatch.context() as m:
            m.setattr(tvs, "corr_layout",
                      lambda shape, eps, device: torch.empty(
                          tuple(shape), device=device))
            want = VoxelSelector(labels, 4, 2, d1, raw_data2=d2,
                                 voxel_unit=4, device="cpu").run(clf)
        assert got == want


def test_port_imports_no_jax_and_no_jax_package():
    """Importing every module of the port loads neither jax nor any
    module of brainiak_tpu."""
    code = (
        "import sys\n"
        "import brainiak_tpu_torch, brainiak_tpu_torch.convert\n"
        "import brainiak_tpu_torch.fcma.classifier\n"
        "import brainiak_tpu_torch.fcma.preprocessing\n"
        "import brainiak_tpu_torch.fcma.util\n"
        "import brainiak_tpu_torch.fcma.voxelselector\n"
        "import brainiak_tpu_torch.ops.fcma_kernels\n"
        "import brainiak_tpu_torch.ops.svm\n"
        "import brainiak_tpu_torch.ops.kernels.epoch_norm\n"
        "import brainiak_tpu_torch.image\n"
        "import brainiak_tpu_torch.isc\n"
        "import brainiak_tpu_torch.ops.distla\n"
        "import brainiak_tpu_torch.ops.ring\n"
        "import brainiak_tpu_torch.ops.kernels.ring\n"
        "import brainiak_tpu_torch.parallel.mesh\n"
        "import brainiak_tpu_torch.stats.pvalues\n"
        "import brainiak_tpu_torch.utils.utils\n"
        "bad = [m for m in sys.modules if m in ('jax', 'brainiak_tpu')\n"
        "       or m.startswith(('jax.', 'jaxlib', 'brainiak_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert 'sklearn' not in sys.modules\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_line_of_the_port_or_chip_smoke_imports_jax():
    """No import statement anywhere in the port's sources or in
    chip_smoke.py names jax or the JAX package, even in a function
    body that the subprocess test above does not run."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "brainiak_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for path in paths:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "brainiak_tpu"), (path, mod)
