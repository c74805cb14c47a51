"""brainiak_tpu_torch ops against the JAX package on the CPU.

Inputs are made with numpy from a seed and cast to float32 (the test
harness turns JAX's x64 mode on); the same arrays go through the JAX
function and the port's plain PyTorch version on ``device="cpu"``.
"""

import math
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.ops import correlation as jcorr
from brainiak_tpu.ops import fisherz as jfz
from brainiak_tpu.ops.kernels import epoch_norm as jnorm
from brainiak_tpu_torch import device as tdev
from brainiak_tpu_torch.ops import correlation as tcorr
from brainiak_tpu_torch.ops import fisherz as tfz
from brainiak_tpu_torch.ops.kernels import _build
from brainiak_tpu_torch.ops.kernels import epoch_norm as tnorm


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1])
def test_normalize_for_correlation_matches_jax(axis):
    rng = np.random.RandomState(0)
    x = _f32(rng, 12, 30)
    x[:, 3] = 1.5  # a zero-variance column
    x[4, :] = -2.0  # a zero-variance row
    want = np.asarray(jcorr.normalize_for_correlation(x, axis))
    got = tcorr.normalize_for_correlation(torch.from_numpy(x), axis,
                                          device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_compute_correlation_matches_jax_and_numpy():
    rng = np.random.RandomState(1)
    a, b = _f32(rng, 7, 40), _f32(rng, 9, 40)
    want = np.asarray(jcorr.compute_correlation(a, b))
    got = tcorr.compute_correlation(a, b, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.corrcoef(a, b)[:7, 7:], atol=1e-5)
    with pytest.raises(ValueError, match="Dimension"):
        tcorr.compute_correlation(a, b[:, :5], device="cpu")


def test_correlate_epochs_matches_jax():
    rng = np.random.RandomState(2)
    blk, data = _f32(rng, 6, 5, 20), _f32(rng, 6, 11, 20)
    want = np.asarray(jcorr.correlate_epochs(blk, data))
    got = tcorr.correlate_epochs(torch.from_numpy(blk),
                                 torch.from_numpy(data))
    assert got.shape == (5, 6, 11)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_fisher_z_matches_jax_away_from_clamp_and_clamps():
    rng = np.random.RandomState(3)
    r = rng.uniform(-0.99, 0.99, size=500).astype(np.float32)
    np.testing.assert_allclose(tfz.fisher_z(torch.from_numpy(r)).numpy(),
                               np.asarray(jfz.fisher_z(r)), rtol=1e-5)
    edge = np.array([1.0, -1.0, 1.5, -1.5], np.float32)
    z = tfz.fisher_z(torch.from_numpy(edge)).numpy()
    big = 0.5 * math.log(2.0 / 1e-4)
    np.testing.assert_allclose(z[:2], [big, -big], rtol=1e-5)
    np.testing.assert_allclose(z, np.asarray(jfz.fisher_z(edge)),
                               rtol=1e-5)


def test_within_subject_normalization_matches_jax():
    rng = np.random.RandomState(4)
    corr = rng.uniform(-0.9, 0.9, size=(5, 12, 17)).astype(np.float32)
    corr[2, 4:8, 3] = 0.25  # a constant subject group -> zeros
    want = np.asarray(jfz.within_subject_normalization(corr, 4))
    got = tfz.within_subject_normalization(torch.from_numpy(corr), 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert np.all(got.numpy()[2, 4:8, 3] == 0)
    with pytest.raises(ValueError, match="multiple"):
        tfz.within_subject_normalization(torch.from_numpy(corr), 5)


def test_within_subject_normalization_golden():
    """The JAX package's golden values (reference fixture)."""
    from numpy.random import RandomState

    prng = RandomState(1234567890)
    for _ in range(8):
        prng.rand(12, 5)
    fake_corr = prng.rand(1, 4, 5).astype(np.float32)
    out = tfz.within_subject_normalization(torch.from_numpy(fake_corr), 4)
    expected = np.asarray(jfz.within_subject_normalization(fake_corr, 4))
    np.testing.assert_allclose(out.numpy(), expected, atol=1e-4)
    np.testing.assert_allclose(out.numpy()[0, 0, 0], 1.06988919,
                               atol=1e-4)


def _epoch_batch(rng, n, t, v):
    x = (rng.randn(n, t, v) * 3 + 1).astype(np.float32)
    x[0, :, 5] = 2.5        # exactly constant column -> 0
    x[1, 3, 7] = np.nan     # non-finite -> 0
    x[2, :, 9] = 1e-3 * np.arange(t)  # tiny but varying
    return x


def test_batch_zscore_plain_matches_jax_pallas_interpret():
    """The K2 plain version against the Pallas kernel run in
    interpreter mode (tile_v=128, T a multiple of 8)."""
    rng = np.random.RandomState(5)
    x = _epoch_batch(rng, 3, 16, 256)
    want = np.asarray(jnorm._pallas_batch_zscore(jnp.asarray(x), 128,
                                                 True))
    got = tnorm.batch_zscore_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(got[0, :, 5] == 0) and np.all(got[1, :, 7] == 0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_normalize_epochs_matches_jax(dtype):
    """Shape-grouped batching, order and dtype preserved."""
    rng = np.random.RandomState(6)
    mats = [rng.randn(10, 33).astype(dtype) for _ in range(3)]
    mats.insert(1, rng.randn(7, 33).astype(dtype))
    mats[2][:, 4] = 0.5
    want = jnorm.normalize_epochs(mats)
    got = tnorm.normalize_epochs(mats, device="cpu")
    assert [g.shape for g in got] == [m.shape for m in mats]
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(g, w, atol=1e-5)
    one = tnorm.epoch_zscore(mats[0], device="cpu")
    np.testing.assert_allclose(one, got[0], atol=0)
    assert tnorm.normalize_epochs([], device="cpu") == []


def test_cpu_path_never_counts_a_launch():
    tnorm.reset_launches()
    tnorm.batch_zscore(torch.zeros(2, 4, 8))
    assert tnorm.launches() == 0


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdev.resolve_device()
    with pytest.raises(RuntimeError):
        tnorm.normalize_epochs([np.zeros((4, 4), np.float32)])
    assert tdev.resolve_device("cpu") == torch.device("cpu")


def test_correlation_ops_raise_without_cuda(monkeypatch):
    """The public correlation ops default to the card: without one
    they raise unless asked for the CPU, and never carry on there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.ones((3, 5), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcorr.normalize_for_correlation(a, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcorr.compute_correlation(a, a)
    got = tcorr.compute_correlation(torch.from_numpy(a), a, device="cpu")
    assert got.device == torch.device("cpu") and got.shape == (3, 3)


def test_precision_map_and_restore():
    assert tdev.resolve_precision(None) == "highest"
    assert tdev.resolve_precision("HIGH") == "high"

    class _Named:
        name = "DEFAULT"

    assert tdev.resolve_precision(_Named()) == "default"
    with pytest.raises(ValueError, match="highest"):
        tdev.resolve_precision("hihgest")
    prev = torch.backends.cuda.matmul.allow_tf32
    with tdev.matmul_precision("high") as dt:
        assert dt == torch.float32
        assert torch.backends.cuda.matmul.allow_tf32
    with tdev.matmul_precision("default") as dt:
        assert dt == torch.bfloat16
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == prev
    a = torch.randn(8, 16)
    full = tcorr.compute_correlation(a, a, precision="highest",
                                     device="cpu")
    low = tcorr.compute_correlation(a, a, precision="default",
                                    device="cpu")
    assert low.dtype == torch.float32
    np.testing.assert_allclose(low.numpy(), full.numpy(), atol=5e-2)


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(0o755)
    return str(path)


def test_kernel_build_renames_into_the_repo_build_dir(tmp_path,
                                                      monkeypatch):
    """A build writes a temporary file and renames it to the library
    named by the source's hash; the default build directory is
    <repo>/build/brainiak_tpu_torch, whatever the working directory."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _build.BUILD_DIR == Path(repo) / "build" / "brainiak_tpu_torch"
    # the fake compiler writes its "library" to the path after -o
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != -o ]; do shift; done\n'
                      'echo built > "$2"\n')
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    path, _ = _build.build(["epoch_norm"])["epoch_norm"]
    assert path == _build.library_path("epoch_norm")
    assert path.read_text() == "built\n"
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == \
        [path.name]


def test_kernel_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != -o ]; do shift; done\n'
                      'echo partial > "$2"\n'
                      'echo "fcma_corr.cu(3): error: boom"\n'
                      'exit 2\n')
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="error: boom"):
        _build.load("fcma_corr")
    assert _build._loaded == {}
    assert list((tmp_path / "build").iterdir()) == []
