"""Kernels K1 (fcma_gram), K3 (fcma_corr_normalize) and K4
(fcma_sample_gram) of brainiak_tpu_torch against the JAX package's
Pallas kernels, run in interpreter mode on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).  K1's tensor-core route
(csrc/fcma_gram_tc.cu) forms the correlation in 3xTF32; its products
are emulated here in plain PyTorch and held against the Pallas kernel
too.  Tolerances:

* normalized correlation: atol 1e-4 outside the (voxel-pair, subject)
  groups that hold an |r| > 0.999, where the Fisher-z derivative
  diverges and last-ulp differences of the two matmuls legally explode
  (the JAX package's own clamp-confinement rule);
* Gram: 1e-4 of each voxel's K[0, 0] (fp32 accumulation order); the
  sample Gram: 1e-4 of its K[0, 0], on two-region inputs (disjoint
  voxels, so no r is 1 and no Fisher-z sits at the clamp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.ops.correlation import normalize_for_correlation
from brainiak_tpu.ops.pallas_kernels import fcma_corr_normalize as jk3
from brainiak_tpu.ops.pallas_kernels import fcma_gram as jk1
from brainiak_tpu.ops.pallas_kernels import fcma_sample_gram as jk4
from brainiak_tpu_torch.ops import fcma_kernels as tk
from brainiak_tpu_torch.ops.fisherz import within_subject_normalization


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _normalized(rng, e, t, v):
    """[E, T, V] float32 epoch data, z-scored over T and scaled."""
    data = rng.randn(e, t, v).astype(np.float32)
    return np.asarray(normalize_for_correlation(
        jnp.asarray(data).transpose(0, 2, 1), 2)).transpose(0, 2, 1)


def _two_mask(seed, e, t, b, v):
    """Disjoint block / all-voxel sets: no |r| near 1."""
    norm = _normalized(np.random.RandomState(seed), e, t, v + b)
    return (np.ascontiguousarray(norm[:, :, v:]),
            np.ascontiguousarray(norm[:, :, :v]))


def _pad(x, n):
    return np.concatenate(
        [x, np.zeros(x.shape[:2] + (n - x.shape[2],), x.dtype)], axis=2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_gram_close(got, want):
    scale = np.abs(want[:, 0, 0])[:, None, None]
    assert np.all(np.abs(got - want) <= 1e-4 * scale)


def test_k3_plain_matches_pallas_interpret_ragged():
    """B=13, V=37: the JAX kernel takes zero-padded inputs (tiles 8 x
    16), the port the ragged ones."""
    e, t, b, v, eps = 8, 40, 13, 37, 4
    blk, data = _two_mask(0, e, t, b, v)
    want = np.asarray(jk3(jnp.asarray(_pad(blk, 16)),
                          jnp.asarray(_pad(data, 48)), eps, tile_b=8,
                          tile_v=16, interpret=True))[:b, :, :v]
    got = tk.fcma_corr_normalize(_t(blk), _t(data), eps).numpy()
    assert got.shape == (b, e, v)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_k1_plain_matches_pallas_interpret_ragged():
    e, t, b, v, eps = 8, 40, 13, 37, 4
    blk, data = _two_mask(1, e, t, b, v)
    want = np.asarray(jk1(jnp.asarray(_pad(blk, 16)),
                          jnp.asarray(_pad(data, 48)), eps, tile_b=8,
                          tile_v=16, interpret=True))[:b]
    got = tk.fcma_gram(_t(blk), _t(data), eps).numpy()
    assert got.shape == (b, e, e)
    _assert_gram_close(got, want)
    corr = tk.fcma_corr_normalize(_t(blk), _t(data), eps)
    _assert_gram_close(got, torch.einsum('bev,bfv->bef', corr,
                                         corr).numpy())


def test_zero_padded_voxels_contribute_exactly_zero():
    e, t, b, v, eps = 8, 24, 6, 20, 2
    blk, data = _two_mask(2, e, t, b, v)
    g = tk.fcma_gram(_t(blk), _t(data), eps)
    g_pad = tk.fcma_gram(_t(blk), _t(_pad(data, v + 12)), eps)
    assert torch.equal(g, g_pad)
    c_pad = tk.fcma_corr_normalize(_t(blk), _t(_pad(data, v + 12)), eps)
    assert torch.all(c_pad[:, :, v:] == 0)


def test_k3_plain_clamp_confinement():
    """One-mask input with planted r = +-1 pairs: outside the poisoned
    subject groups the plain version agrees with the Pallas kernel."""
    e, t, b, v, eps = 8, 20, 16, 32, 4
    rng = np.random.RandomState(3)
    data = rng.randn(e, t, v).astype(np.float32)
    data[:, :, 21] = data[:, :, 5]
    data[:, :, 27] = -data[:, :, 11]
    norm = np.asarray(normalize_for_correlation(
        jnp.asarray(data).transpose(0, 2, 1), 2)).transpose(0, 2, 1)
    blk = np.ascontiguousarray(norm[:, :, :b])
    want = np.asarray(jk3(jnp.asarray(blk), jnp.asarray(norm), eps,
                          tile_b=8, tile_v=16, interpret=True))
    got = tk.fcma_corr_normalize(_t(blk), _t(norm), eps).numpy()
    corr = np.einsum('etb,etv->bev', blk.astype(np.float64),
                     norm.astype(np.float64))
    near = (np.abs(corr) > 0.999).reshape(b, e // eps, eps, v)
    poisoned = np.broadcast_to(near.any(axis=2, keepdims=True),
                               near.shape).reshape(b, e, v)
    assert poisoned[5, :, 21].all() and poisoned[11, :, 27].all()
    assert (~poisoned).mean() > 0.9
    np.testing.assert_allclose(got[~poisoned], want[~poisoned],
                               atol=1e-4)


@pytest.mark.parametrize("n_epochs,eps,expect", [
    (8, 4, (16, 16, 1)),
    (12, 6, (16, 12, 1)),
    (16, 4, (16, 16, 1)),
    (32, 4, (32, 32, 1)),
    (40, 10, (32, 30, 2)),
    (216, 12, (32, 24, 9)),
    (40, 1, (32, 32, 2)),
    (80, 40, (32, 32, 3)),
    (96, 48, (32, 32, 3)),
    (64, 64, (32, 32, 2)),
])
def test_epoch_tiles(n_epochs, eps, expect):
    assert tk.epoch_tiles(n_epochs, eps) == expect


def test_epoch_tiles_forced_capacity():
    assert tk.epoch_tiles(16, 4, ept=32) == (32, 32, 1)
    assert tk.epoch_tiles(40, 10, ept=16) == (16, 10, 4)
    assert tk.epoch_tiles(40, 20, ept=16) == (16, 16, 3)
    with pytest.raises(ValueError, match="16 or 32"):
        tk.epoch_tiles(16, 4, ept=8)


def test_epoch_tiles_refuses():
    """Only designs that cut a subject are refused: a subject longer
    than one tile spans several."""
    with pytest.raises(ValueError, match="multiple"):
        tk.epoch_tiles(10, 4)
    with pytest.raises(ValueError, match="multiple"):
        tk.epoch_tiles(66, 44)
    assert tk.epoch_tiles(66, 33) == (32, 32, 3)


@pytest.mark.parametrize("n_epochs,eps,expect", [
    (16, 4, ("tc", 16, 16, 1)),
    (32, 4, ("tc", 32, 32, 1)),
    (12, 6, ("tc", 16, 12, 1)),
    (8, 4, ("tc", 16, 16, 1)),
    (24, 12, ("tc", 32, 24, 1)),
    (40, 10, ("ffma", 32, 30, 2)),
    (48, 4, ("ffma", 32, 32, 2)),
    (80, 40, ("ffma", 32, 32, 3)),
    (96, 48, ("ffma", 32, 32, 3)),
    (64, 64, ("ffma", 32, 32, 2)),
])
def test_gram_route(n_epochs, eps, expect):
    """One epoch tile of whole subjects takes the tensor-core kernel;
    more tiles, or subjects longer than a tile, the FMA one."""
    assert tk.gram_route(n_epochs, eps) == expect
    assert tk.gram_route(n_epochs, eps)[1:] == tk.epoch_tiles(n_epochs,
                                                              eps)


def test_gram_route_forced():
    assert tk.gram_route(16, 4, ept=32) == ("tc", 32, 32, 1)
    assert tk.gram_route(32, 4, route="ffma") == ("ffma", 32, 32, 1)
    assert tk.gram_route(12, 6, route="tc") == ("tc", 16, 12, 1)
    with pytest.raises(ValueError, match="one epoch tile"):
        tk.gram_route(48, 4, route="tc")
    with pytest.raises(ValueError, match="one epoch tile"):
        tk.gram_route(40, 10, ept=16, route="tc")
    with pytest.raises(ValueError, match="'tc' or 'ffma'"):
        tk.gram_route(16, 4, route="wgmma")


def test_aligned_rows_pads_with_zero_voxels():
    """The tensor-core route's operands: rows padded with zero voxels to
    16-byte alignment, aligned ones passed through as they are."""
    x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    assert tk._aligned_rows(x) is x
    y = tk._aligned_rows(x[:, :, :5].contiguous())
    assert y.shape == (2, 3, 8) and y.data_ptr() % 16 == 0
    assert torch.equal(y[:, :, :5], x[:, :, :5])
    assert not y[:, :, 5:].any()
    store = torch.zeros(2 * 3 * 8 + 1)
    store[1:] = x.reshape(-1)
    shifted = store[1:].view(2, 3, 8)
    assert shifted.data_ptr() % 16
    z = tk._aligned_rows(shifted)
    assert z.data_ptr() % 16 == 0 and torch.equal(z, x)


def _tf32_rna(x):
    """float32 -> TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    rounds: to nearest, ties away from zero, on the int32 view (the
    magnitude sits below the sign bit, so adding half an ulp and
    clearing the 13 low bits rounds it away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _corr_3xtf32(blk, data, terms=3):
    """r[b, e, v] as csrc/fcma_gram_tc.cu forms it: each operand split
    into hi = tf32(x) and lo = tf32(x - hi), the product lo*hi + hi*lo
    + hi*hi in fp32 (``terms=1``: hi*hi alone, plain TF32)."""
    bh, dh = _tf32_rna(blk), _tf32_rna(data)
    bl, dl = _tf32_rna(blk - bh), _tf32_rna(data - dh)

    def mm(a, b):
        return torch.einsum('etb,etv->bev', a, b)

    if terms == 1:
        return mm(bh, dh)
    return mm(bl, dh) + mm(bh, dl) + mm(bh, dh)


def _gram_3xtf32(blk, data, eps):
    z = within_subject_normalization(_corr_3xtf32(blk, data), eps)
    return torch.einsum('bev,bfv->bef', z, z)


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2.01,
                      1 + 3 * ulp / 2, 0.1, -0.0])
    got = _tf32_rna(x).tolist()
    assert got[:5] == [1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp]
    assert got[6] == 0.0
    # 10 mantissa bits left, the nearest of the two neighbours
    m, ex = np.frexp(got[5])
    assert float(m * 2 ** 11) == int(m * 2 ** 11)
    assert abs(got[5] - 0.1) <= 2.0 ** (ex - 12)


def test_k1_3xtf32_matches_pallas_interpret_ragged():
    """The tensor-core route's products (emulated) at a ragged
    one-tile shape, T=150 not a multiple of the 8-row k-step: the Gram
    within 1e-4 of each voxel's K[0, 0] of the Pallas kernel's, and r
    within fp32 rounding of float64 (plain TF32 is not)."""
    e, t, b, v, eps = 12, 150, 13, 70, 4
    assert tk.gram_route(e, eps)[0] == "tc"
    blk, data = _two_mask(6, e, t, b, v)
    want = np.asarray(jk1(jnp.asarray(_pad(blk, 16)),
                          jnp.asarray(_pad(data, 80)), eps, tile_b=8,
                          tile_v=16, interpret=True))[:b]
    got = _gram_3xtf32(_t(blk), _t(data), eps).numpy()
    _assert_gram_close(got, want)
    _assert_gram_close(got, tk.fcma_gram_plain(_t(blk), _t(data),
                                               eps).numpy())
    r64 = np.einsum('etb,etv->bev', blk.astype(np.float64),
                    data.astype(np.float64))
    err3 = np.abs(_corr_3xtf32(_t(blk), _t(data)).numpy() - r64).max()
    err1 = np.abs(_corr_3xtf32(_t(blk), _t(data), 1).numpy() - r64).max()
    assert err3 <= 1e-6 < 1e-5 <= err1


def test_k1_3xtf32_clamp_confinement():
    """One-mask input with self pairs (r = 1) and planted r = +-1
    pairs: outside the poisoned subject groups the emulated
    tensor-core route's normalized correlation agrees with the Pallas
    kernel's."""
    e, t, b, v, eps = 12, 20, 16, 32, 4
    rng = np.random.RandomState(7)
    data = rng.randn(e, t, v).astype(np.float32)
    data[:, :, 21] = data[:, :, 5]
    data[:, :, 27] = -data[:, :, 11]
    norm = np.asarray(normalize_for_correlation(
        jnp.asarray(data).transpose(0, 2, 1), 2)).transpose(0, 2, 1)
    blk = np.ascontiguousarray(norm[:, :, :b])
    want = np.asarray(jk3(jnp.asarray(blk), jnp.asarray(norm), eps,
                          tile_b=8, tile_v=16, interpret=True))
    got = within_subject_normalization(_corr_3xtf32(_t(blk), _t(norm)),
                                       eps).numpy()
    corr = np.einsum('etb,etv->bev', blk.astype(np.float64),
                     norm.astype(np.float64))
    near = (np.abs(corr) > 0.999).reshape(b, e // eps, eps, v)
    poisoned = np.broadcast_to(near.any(axis=2, keepdims=True),
                               near.shape).reshape(b, e, v)
    assert poisoned[5, :, 21].all() and poisoned[11, :, 27].all()
    assert poisoned[np.arange(b), :, np.arange(b)].all()
    assert (~poisoned).mean() > 0.9
    np.testing.assert_allclose(got[~poisoned], want[~poisoned],
                               atol=1e-4)


def _tiled_gram(blk, data, eps):
    """The kernel's epoch-tile decomposition in plain PyTorch: each
    pair of tiles (A <= C) gives the Gram's A x C block, mirrored into
    C x A.  A tile of whole subjects normalizes only its own epochs; a
    subject longer than a tile is normalized with statistics over all
    its epochs (the kernels' first pass)."""
    n_e = blk.shape[0]
    _, tile_len, n_tiles = tk.epoch_tiles(n_e, eps)
    whole = tk.fcma_corr_normalize_plain(blk, data, eps)

    def tile(e0, e1):
        if eps > tile_len:
            return whole[:, e0:e1]
        return tk.fcma_corr_normalize_plain(blk[e0:e1], data[e0:e1], eps)

    out = torch.full((blk.shape[2], n_e, n_e), float("nan"))
    spans = [(k * tile_len, min(n_e, (k + 1) * tile_len))
             for k in range(n_tiles)]
    for i, (a0, a1) in enumerate(spans):
        za = tile(a0, a1)
        for c0, c1 in spans[i:]:
            zc = tile(c0, c1)
            g = torch.einsum('bev,bfv->bef', za, zc)
            out[:, a0:a1, c0:c1] = g
            out[:, c0:c1, a0:a1] = g.transpose(1, 2)
    return out


@pytest.mark.parametrize("n_epochs,eps", [(40, 10), (48, 4), (80, 40),
                                          (64, 64)])
def test_epoch_tile_pairs_cover_the_gram(n_epochs, eps):
    blk, data = _two_mask(4, n_epochs, 12, 5, 9)
    got = _tiled_gram(_t(blk), _t(data), eps)
    want = tk.fcma_gram_plain(_t(blk), _t(data), eps)
    assert not torch.isnan(got).any()
    _assert_gram_close(got.numpy(), want.numpy())


def test_kernel_entry_checks_refuse_cpu_tensors():
    blk = torch.zeros(4, 6, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tk._check_inputs(blk, blk)
    with pytest.raises(ValueError, match="CUDA"):
        tk._check_inputs(blk, blk, ("x1", "x2"))
    tk.reset_launches()
    tk.fcma_gram(blk, blk, 2)
    tk.fcma_corr_normalize(blk, blk, 2)
    tk.fcma_sample_gram(blk, blk, 2)
    assert tk.launches() == {"fcma_gram": 0, "fcma_gram_tc": 0,
                             "fcma_corr_normalize": 0,
                             "fcma_sample_gram": 0}


def _jax_feature_gram(x1, x2, norm_unit):
    """The JAX classifier's XLA features (one portion), then
    features @ features.T in float64."""
    from brainiak_tpu.fcma.classifier import _chunk_features

    corr = np.asarray(_chunk_features(jnp.asarray(x1), jnp.asarray(x2), 0,
                                      x1.shape[2], norm_unit))
    feats = corr.reshape(corr.shape[0], -1).astype(np.float64)
    return feats @ feats.T


@pytest.mark.parametrize("n", [8, 12])
@pytest.mark.parametrize("norm_unit", [0, 4])
def test_k4_plain_matches_pallas_interpret_ragged(n, norm_unit):
    """x1 13 voxels, x2 37: the JAX kernel takes zero-padded inputs
    (tiles 16 x 16), the port the ragged ones; both against the JAX
    package's XLA feature Gram too."""
    t, v1, v2 = 30, 13, 37
    x1, x2 = _two_mask(n + norm_unit, n, t, v1, v2)
    want = np.asarray(jk4(jnp.asarray(_pad(x1, 16)),
                          jnp.asarray(_pad(x2, 48)), norm_unit, tile_1=16,
                          tile_2=16, interpret=True))
    got = tk.fcma_sample_gram(_t(x1), _t(x2), norm_unit).numpy()
    xla = _jax_feature_gram(x1, x2, norm_unit)
    assert got.shape == (n, n)
    for ref in (want, xla):
        assert np.all(np.abs(got - ref) <= 1e-4 * abs(ref[0, 0]))


def test_k4_plain_is_k1_summed_over_block_voxels():
    """K4(x1, x2, u) = sum_b K1(x1, x2, u)[b], whichever region is the
    block operand."""
    x1, x2 = _two_mask(5, 12, 20, 150, 9)
    g1 = tk.fcma_gram_plain(_t(x1), _t(x2), 4).sum(dim=0)
    for a, b in ((x1, x2), (x2, x1)):
        got = tk.fcma_sample_gram(_t(a), _t(b), 4)
        assert torch.all((got - g1).abs() <= 1e-4 * g1[0, 0].abs())


def test_k4_refuses_samples_that_cut_a_group():
    x = torch.zeros(10, 6, 3)
    with pytest.raises(ValueError, match="multiple"):
        tk.fcma_sample_gram(x, x, 4)
    assert tk.fcma_sample_gram(x, x, 0).shape == (10, 10)
