"""brainiak_tpu_torch's CUDA kernels against their plain versions on
the card.

Marked ``gpu``: they need an NVIDIA Hopper card and nvcc, and skip
elsewhere (the ``cuda`` fixture decides at run time, so every worker
collects the same tests).  On such a machine:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from brainiak_tpu_torch.ops import fcma_kernels as fk
from brainiak_tpu_torch.ops.correlation import correlate_epochs
from brainiak_tpu_torch.ops.fisherz import fisher_z
from brainiak_tpu_torch.ops.kernels import epoch_norm as en

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    from brainiak_tpu_torch import set_fp32_defaults
    set_fp32_defaults()
    return torch.device("cuda")


def _normalized(seed, e, t, v, dev):
    x = torch.from_numpy(np.random.RandomState(seed).randn(e, t, v)
                         .astype(np.float32)).to(dev)
    x -= x.mean(dim=1, keepdim=True)
    x /= x.std(dim=1, keepdim=True, correction=0) * t ** 0.5
    return x.contiguous()


def _group_sigma(blk, data, eps):
    """Std of each subject group's Fisher-z values, per element."""
    z = fisher_z(correlate_epochs(blk.transpose(1, 2),
                                  data.transpose(1, 2)))
    b, e, v = z.shape
    zr = z.reshape(b, e // eps, eps, v)
    var = (zr * zr).mean(dim=2, keepdim=True) - \
        zr.mean(dim=2, keepdim=True) ** 2
    return var.clamp(min=0).sqrt().expand_as(zr).reshape(b, e, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(3, 17, 300), (5, 150, 1031)])
def test_epoch_zscore_kernel(cuda, dtype, shape):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*shape) * 2 + 1).to(cuda, dtype)
    x[0, :, 5] = 2.0
    x[1, 3, 7] = float("nan")
    en.reset_launches()
    got = en.batch_zscore(x)
    assert en.launches() == 1 and got.dtype == dtype
    want = en.batch_zscore_plain(x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.all(got[0, :, 5] == 0) and torch.all(got[1, :, 7] == 0)
    with pytest.raises(TypeError):
        en.batch_zscore(x.half())


@pytest.mark.parametrize("e,t,b,v,eps", [
    (8, 40, 13, 37, 4), (16, 150, 40, 1000, 4), (32, 150, 130, 3000, 4),
    (12, 20, 9, 70, 6), (40, 12, 10, 100, 10), (48, 9, 17, 65, 4)])
def test_fcma_kernels(cuda, e, t, b, v, eps):
    """Two-mask inputs (no |r| near 1); ragged B and V; one and several
    epoch tiles."""
    d = _normalized(e + b, e, t, v + b, cuda)
    blk, data = d[:, :, v:].contiguous(), d[:, :, :v].contiguous()
    fk.reset_launches()
    gram = fk.fcma_gram(blk, data, eps)
    corr = fk.fcma_corr_normalize(blk, data, eps)
    assert fk.launches() == {"fcma_gram": 1, "fcma_corr_normalize": 1}
    want = fk.fcma_gram_plain(blk, data, eps)
    scale = want[:, :1, :1].abs()
    assert torch.all((gram - want).abs() <= 1e-4 * scale)
    want = fk.fcma_corr_normalize_plain(blk, data, eps)
    sigma = _group_sigma(blk, data, eps)
    assert ((corr - want).abs() * sigma).max().item() <= 1e-5


def test_fcma_kernels_refuse_bad_inputs(cuda):
    x = torch.zeros(4, 6, 8, device=cuda)
    with pytest.raises(TypeError):
        fk.fcma_gram(x.double(), x.double(), 2)
    with pytest.raises(ValueError):
        fk.fcma_gram(x, x[:, :5], 2)
    with pytest.raises(ValueError):
        fk.fcma_corr_normalize(x, x, 3)


def test_fcma_gram_both_tilings_at_sixteen_epochs(cuda):
    """At E <= 16 the 16-epoch tiling runs; the 32-epoch one, forced,
    gives the same Gram."""
    d = _normalized(3, 16, 150, 600, cuda)
    blk, data = d[:, :, 500:].contiguous(), d[:, :, :500].contiguous()
    want = fk.fcma_gram_plain(blk, data, 4)
    scale = want[:, :1, :1].abs()
    for ept in (16, 32):
        got = fk._kernel_gram(blk, data, 4, ept=ept)
        assert torch.all((got - want).abs() <= 1e-4 * scale), ept


def test_more_than_32_epochs_per_subject_is_refused_on_cuda(cuda):
    """A known gap of the kernels: a subject's epochs must fit one
    32-epoch tile.  The CPU path takes any number."""
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector

    x = torch.zeros(80, 6, 8, device=cuda)
    with pytest.raises(ValueError, match="at most 32 epochs per subject"):
        fk.fcma_gram(x, x, 40)
    with pytest.raises(ValueError, match="at most 32 epochs per subject"):
        fk.fcma_corr_normalize(x, x, 40)
    raw = [np.zeros((6, 8), np.float32)] * 80
    with pytest.raises(ValueError, match="at most 32 epochs per subject"):
        VoxelSelector([0, 1] * 40, 40, 2, raw)


def test_voxel_selector_cuda_matches_cpu(cuda):
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector

    d = _normalized(1, 8, 20, 57, torch.device("cpu")).numpy()
    d1, d2 = list(d[:, :, :7]), list(d[:, :, 7:])
    labels = [0, 1] * 4
    got = dict(VoxelSelector(labels, 4, 2, d1, raw_data2=d2).run('svm'))
    want = dict(VoxelSelector(labels, 4, 2, d1, raw_data2=d2,
                              device="cpu").run('svm'))
    g = np.array([got[k] for k in range(7)])
    w = np.array([want[k] for k in range(7)])
    assert np.max(np.abs(g - w)) <= 2 / 8 + 1e-6
