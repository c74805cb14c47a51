"""Kernels K1 (fcma_gram), K3 (fcma_corr_normalize) and K4
(fcma_sample_gram) of brainiak_tpu_torch against the JAX package's
Pallas kernels, run in interpreter mode on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).  K1's tensor-core route
(csrc/fcma_gram_tc.cu) and K3's (csrc/fcma_corr_tc.cu,
csrc/fcma_corr_tcl.cu) form the correlation in 3xTF32; their products
(and the long-subject K3's chunked z-score) are emulated here in plain
PyTorch and held against the Pallas kernel too.  Tolerances:

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
from brainiak_tpu_torch.ops.fisherz import (fisher_z,
                                            within_subject_normalization)


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
    (40, 10, ("tcm", 32, 30, 2)),
    (48, 4, ("tcm", 32, 32, 2)),
    (80, 40, ("tcm", 32, 32, 3)),
    (96, 48, ("tcm", 32, 32, 3)),
    (64, 64, ("tcm", 32, 32, 2)),
    (96, 12, ("tcm", 32, 24, 4)),
    (104, 52, ("tcm", 32, 32, 4)),
    (108, 4, ("tcs", 32, 32, 4)),
    (112, 56, ("tcs", 32, 32, 4)),
    (216, 12, ("tcs", 32, 24, 9)),
    (216, 108, ("tcs", 32, 32, 7)),
    (800, 4, ("tcs", 32, 32, 25)),
    (801, 3, ("ffma", 32, 30, 27)),
])
def test_gram_route(n_epochs, eps, expect):
    """One epoch tile of whole subjects takes the one-tile tensor-core
    kernel; more tiles, or subjects longer than a tile, the multi-tile
    one up to TCM_MAX_EPOCHS = 104 epochs, the slab route beyond, up to
    TCS_MAX_EPOCHS = 800 (216 epochs of 12 a subject, the face-scene
    design, and a subject of 108), and the FMA one beyond that."""
    assert tk.gram_route(n_epochs, eps) == expect
    assert tk.gram_route(n_epochs, eps)[1:] == tk.epoch_tiles(n_epochs,
                                                              eps)


def test_gram_route_forced():
    """Forced: the FMA kernel takes every design; the slab route only
    more than 104 and at most 800 epochs."""
    assert tk.TCM_MAX_EPOCHS == 104 and tk.TCS_MAX_EPOCHS == 800
    assert tk.gram_route(16, 4, ept=32) == ("tc", 32, 32, 1)
    assert tk.gram_route(32, 4, route="ffma") == ("ffma", 32, 32, 1)
    assert tk.gram_route(12, 6, route="tc") == ("tc", 16, 12, 1)
    assert tk.gram_route(80, 40, route="ffma") == ("ffma", 32, 32, 3)
    assert tk.gram_route(48, 4, route="tcm") == ("tcm", 32, 32, 2)
    assert tk.gram_route(24, 4, ept=16, route="tcm") == ("tcm", 16, 16, 2)
    assert tk.gram_route(40, 10, ept=16) == ("tcm", 16, 10, 4)
    with pytest.raises(ValueError, match="one epoch tile"):
        tk.gram_route(48, 4, route="tc")
    with pytest.raises(ValueError, match="one epoch tile"):
        tk.gram_route(40, 10, ept=16, route="tc")
    with pytest.raises(ValueError, match="more than one epoch tile"):
        tk.gram_route(32, 4, route="tcm")
    with pytest.raises(ValueError, match="at most 104 epochs"):
        tk.gram_route(108, 4, route="tcm")
    assert tk.gram_route(216, 12, route="ffma") == ("ffma", 32, 24, 9)
    assert tk.gram_route(108, 4, route="tcs") == ("tcs", 32, 32, 4)
    for n_e, eps in ((104, 52), (48, 4), (16, 4), (801, 3)):
        with pytest.raises(ValueError, match="route 'tcs' takes more than "
                           "104 and at most 800 epochs"):
            tk.gram_route(n_e, eps, route="tcs")
    with pytest.raises(ValueError, match="'tc', 'tcm', 'tcs' or 'ffma'"):
        tk.gram_route(16, 4, route="wgmma")


def test_aligned_rows_pads_with_zero_voxels():
    """The tensor-core routes' operands (K1's and K3's): aligned ones
    passed through as they are; others copied once into rows padded
    with zero voxels to 16-byte alignment, of which the kernels see
    only the caller's width."""
    x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    assert tk._tma_operand(x) is x
    y = tk._tma_operand(x[:, :, :5].contiguous())
    assert y.shape == (2, 3, 5) and y.data_ptr() % 16 == 0
    assert y.stride() == (24, 8, 1)
    assert torch.equal(y, x[:, :, :5])
    wide = y.as_strided((2, 3, 8), (24, 8, 1))
    assert not wide[:, :, 5:].any()
    store = torch.zeros(2 * 3 * 8 + 1)
    store[1:] = x.reshape(-1)
    shifted = store[1:].view(2, 3, 8)
    assert shifted.data_ptr() % 16
    z = tk._tma_operand(shifted)
    assert z.data_ptr() % 16 == 0 and torch.equal(z, x)


def _tf32_rna(x):
    """float32 -> TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    rounds: to nearest, ties away from zero, on the int32 view (the
    magnitude sits below the sign bit, so adding half an ulp and
    clearing the 13 low bits rounds it away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """float32 -> TF32 as the tensor core reads an operand whose 13 low
    bits are not cleared: toward zero (those bits ignored)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _corr_3xtf32(blk, data, terms=3, lo=_tf32_rna):
    """r[b, e, v] as csrc/fcma_gram_tc.cu forms it: each operand split
    into hi = tf32(x) and lo = tf32(x - hi), the product lo*hi + hi*lo
    + hi*hi in fp32 (``terms=1``: hi*hi alone, plain TF32).  ``lo``
    rounds the small part: to nearest (K1), or ``_tf32_trunc`` where
    csrc/fcma_corr_tc.cu passes x - hi unrounded (K3)."""
    bh, dh = _tf32_rna(blk), _tf32_rna(data)
    bl, dl = lo(blk - bh), lo(data - dh)

    def mm(a, b):
        return torch.einsum('etb,etv->bev', a, b)

    if terms == 1:
        return mm(bh, dh)
    return mm(bl, dh) + mm(bh, dl) + mm(bh, dh)


def _gram_3xtf32(blk, data, eps):
    z = within_subject_normalization(_corr_3xtf32(blk, data), eps)
    return torch.einsum('bev,bfv->bef', z, z)


def test_tf32_trunc_drops_the_low_bits():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp * 0.99, -(1 + ulp * 0.99), 1 + ulp * 1.5,
                      3.0])
    assert _tf32_trunc(x).tolist() == [1.0, -1.0, 1 + ulp, 3.0]


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


def _near_one_fp32(blk, data, r):
    """The near-one rule of K1's multi-tile route (csrc/fcma_gram_tcm.cu,
    K4's rule): each r[b, e, v] with |r| >= 1 - 2^-10 formed again in
    fp32, t ascending, each step an FMA (the product exact in float64,
    one rounding to float32)."""
    out = r.clone()
    for b, e, v in (r.abs() >= 1 - 2.0 ** -10).nonzero().tolist():
        x = blk[e, :, b].double().tolist()
        y = data[e, :, v].double().tolist()
        acc = np.float32(0)
        for xt, yt in zip(x, y):
            acc = np.float32(xt * yt + float(acc))
        out[b, e, v] = float(acc)
    return out


def _corr_tcm(blk, data):
    """r as csrc/fcma_gram_tcm.cu forms it: 3xTF32 with the small part
    passed unrounded (read toward zero), as csrc/fcma_corr_tc.cu, and
    the near-one r formed again in fp32."""
    return _near_one_fp32(blk, data,
                          _corr_3xtf32(blk, data, lo=_tf32_trunc))


@pytest.mark.parametrize("e,eps", [(48, 4), (36, 12), (80, 40)])
def test_k1_tcm_3xtf32_matches_pallas_interpret_ragged(e, eps):
    """K1's multi-tile tensor-core route (csrc/fcma_gram_tcm.cu), its
    arithmetic emulated: every correlation of all E epochs formed once
    in 3xTF32, the Fisher-z, the z-score over each whole subject, the
    Gram.  Ragged B=13, V=37 and T=37 (not whole 16-row stages); 48
    epochs of 4 a subject (two epoch tiles), 36 of 12 (tiles of 24),
    80 of 40 (a subject longer than a tile).  Two-region inputs: the
    Gram within 1e-4 of each voxel's K[0, 0] of the Pallas kernel in
    interpret mode and of the plain version."""
    t, b, v = 37, 13, 37
    assert tk.gram_route(e, eps)[0] == "tcm"
    blk, data = _two_mask(40 + e, e, t, b, v)
    want = np.asarray(jk1(jnp.asarray(_pad(blk, 16)),
                          jnp.asarray(_pad(data, 48)), eps, tile_b=8,
                          tile_v=16, interpret=True))[:b]
    z = within_subject_normalization(_corr_tcm(_t(blk), _t(data)), eps)
    got = torch.einsum('bev,bfv->bef', z, z).numpy()
    assert got.shape == (b, e, e)
    _assert_gram_close(got, want)
    _assert_gram_close(got, tk.fcma_gram_plain(_t(blk), _t(data),
                                               eps).numpy())


def test_k1_tcm_3xtf32_clamp_confinement():
    """One-mask input at 80 epochs of 40 a subject, with self pairs
    (r = 1) and planted r = +-1 pairs: the emulated multi-tile route's
    normalized correlation, near-one r formed again in fp32, agrees
    with the Pallas kernel's outside the poisoned subject groups, and
    is finite everywhere."""
    e, t, b, v, eps = 80, 20, 16, 32, 40
    rng = np.random.RandomState(17)
    data = rng.randn(e, t, v).astype(np.float32)
    data[:, :, 21] = data[:, :, 5]
    data[:, :, 27] = -data[:, :, 11]
    norm = np.asarray(normalize_for_correlation(
        jnp.asarray(data).transpose(0, 2, 1), 2)).transpose(0, 2, 1)
    blk = np.ascontiguousarray(norm[:, :, :b])
    want = np.asarray(jk3(jnp.asarray(blk), jnp.asarray(norm), eps,
                          tile_b=8, tile_v=16, interpret=True))
    r = _corr_tcm(_t(blk), _t(norm))
    near = r.abs() >= 1 - 2.0 ** -10
    assert near[np.arange(b), :, np.arange(b)].all()
    got = within_subject_normalization(r, eps).numpy()
    poisoned = _poisoned_groups(blk, norm, eps)
    assert poisoned[5, :, 21].all() and poisoned[11, :, 27].all()
    assert poisoned[np.arange(b), :, np.arange(b)].all()
    assert (~poisoned).mean() > 0.9
    np.testing.assert_allclose(got[~poisoned], want[~poisoned],
                               atol=1e-4)
    assert np.isfinite(got).all()


def _poisoned_groups(blk, data, eps):
    """(block voxel, subject, voxel) groups holding an |r| > 0.999,
    broadcast over the subject's epochs."""
    b, e, v = blk.shape[2], blk.shape[0], data.shape[2]
    corr = np.einsum('etb,etv->bev', blk.astype(np.float64),
                     data.astype(np.float64))
    near = (np.abs(corr) > 0.999).reshape(b, e // eps, eps, v)
    return np.broadcast_to(near.any(axis=2, keepdims=True),
                           near.shape).reshape(b, e, v)


def _assert_k3_close(got, want, blk, data, eps, keep=None):
    """The K3 rule (chip_smoke.py's K3_ZTOL): |got - want| times the std
    of each subject group's Fisher-z values at most 1e-5.  The z-score
    divides by that std, so fp32 rounding of r shows amplified by its
    inverse where a group's values nearly coincide (more often the
    fewer epochs a subject has); scaled back, the difference is in
    Fisher-z units.  ``keep``: the elements held."""
    b, e, v = got.shape
    corr = np.einsum('etb,etv->bev', blk.astype(np.float64),
                     data.astype(np.float64))
    z = np.arctanh(np.clip(corr, -1 + 1e-7, 1 - 1e-7))
    sigma = np.broadcast_to(z.reshape(b, e // eps, eps, v).std(
        axis=2, keepdims=True), (b, e // eps, eps, v)).reshape(b, e, v)
    err = np.abs(got - want) * sigma
    assert (err if keep is None else err[keep]).max() <= 1e-5


@pytest.mark.parametrize("e,t,b,v,eps", [(12, 150, 13, 37, 4),
                                         (48, 20, 13, 37, 4),
                                         (9, 150, 9, 70, 3)])
def test_k3_3xtf32_matches_pallas_interpret_ragged(e, t, b, v, eps):
    """K3's tensor-core route (csrc/fcma_corr_tc.cu), its products
    emulated: 3xTF32 correlation (the small part unrounded, so read
    toward zero), then the Fisher-z and z-score, at
    ragged shapes (B and V not multiples of 4, T not a multiple of the
    8-row stages; E=48 with 4 epochs per subject, more than one epoch
    tile of K1).  Two-region inputs (no |r| near 1): within the K3 rule
    of the Pallas kernel in interpret mode and of the plain version."""
    assert tk.corr_route(e, eps) == "tc"
    blk, data = _two_mask(20 + e, e, t, b, v)
    want = np.asarray(jk3(jnp.asarray(_pad(blk, 16)),
                          jnp.asarray(_pad(data, 80)), eps, tile_b=8,
                          tile_v=16, interpret=True))[:b, :, :v]
    got = within_subject_normalization(
        _corr_3xtf32(_t(blk), _t(data), lo=_tf32_trunc), eps).numpy()
    assert got.shape == (b, e, v)
    plain = tk.fcma_corr_normalize_plain(_t(blk), _t(data), eps).numpy()
    for ref in (want, plain):
        _assert_k3_close(got, ref, blk, data, eps)
    # the unrounded small part keeps r within fp32 rounding of float64
    r64 = np.einsum('etb,etv->bev', blk.astype(np.float64),
                    data.astype(np.float64))
    r = _corr_3xtf32(_t(blk), _t(data), lo=_tf32_trunc).numpy()
    assert np.abs(r - r64).max() <= 1e-6


@pytest.mark.parametrize("e,eps", [(12, 3), (16, 4)])
def test_k3_3xtf32_clamp_confinement(e, eps):
    """Self-correlation, as VoxelSelector runs K3 without raw_data2
    (the block's voxels are in data, r = 1 with themselves), with
    planted r = +-1 pairs: the emulated tensor-core route may round
    r >= 1 otherwise than fp32, but only inside the poisoned subject
    groups; outside them it agrees with the Pallas kernel and the
    plain version under the K3 rule."""
    t, b, v = 24, 16, 40
    rng = np.random.RandomState(11 + eps)
    data = rng.randn(e, t, v).astype(np.float32)
    data[:, :, 30] = data[:, :, 3]
    data[:, :, 35] = -data[:, :, 9]
    norm = np.asarray(normalize_for_correlation(
        jnp.asarray(data).transpose(0, 2, 1), 2)).transpose(0, 2, 1)
    blk = np.ascontiguousarray(norm[:, :, :b])
    want = np.asarray(jk3(jnp.asarray(blk), jnp.asarray(norm), eps,
                          tile_b=8, tile_v=8, interpret=True))
    got = within_subject_normalization(
        _corr_3xtf32(_t(blk), _t(norm), lo=_tf32_trunc), eps).numpy()
    plain = tk.fcma_corr_normalize_plain(_t(blk), _t(norm), eps).numpy()
    poisoned = _poisoned_groups(blk, norm, eps)
    assert poisoned[3, :, 30].all() and poisoned[9, :, 35].all()
    assert poisoned[np.arange(b), :, np.arange(b)].all()
    assert (~poisoned).mean() > 0.9
    for ref in (want, plain):
        _assert_k3_close(got, ref, blk, norm, eps, keep=~poisoned)
    assert np.isfinite(got).all()


def _chunked_corr_normalize(blk, data, eps):
    """K3's long-subject route (csrc/fcma_corr_tcl.cu) in plain
    PyTorch: r as its products form it (3xTF32, the near-one r again in
    fp32), then, per subject, boxes of 4 epochs (the last one running
    past the subject, its extra epochs dropped), each epoch's clamped
    Fisher-z stored raw; after the subject's last chunk the raw z read
    back for sums of z and z^2 (fmaf: the square exact in float64, one
    rounding) in epoch order, and z-scored with them (var = E[z^2] -
    mean^2, the inverse std 0 where var <= 0)."""
    r = _corr_tcm(blk, data)
    num = torch.where(1 + r <= 0, torch.tensor(1e-4), 1 + r)
    den = torch.where(1 - r <= 0, torch.tensor(1e-4), 1 - r)
    z = 0.5 * torch.log(num / den)
    n_b, n_e, n_v = z.shape
    out = torch.full_like(z, float("nan"))
    inv_n = torch.tensor(1.0, dtype=torch.float32) / eps
    for s0 in range(0, n_e, eps):
        for c0 in range(s0, s0 + eps, 4):
            box = z[:, c0:c0 + 4]  # may hold the next subject's epochs
            n_in = min(4, s0 + eps - c0)
            out[:, c0:c0 + n_in] = box[:, :n_in]
        total = torch.zeros(n_b, n_v)
        sq = torch.zeros(n_b, n_v)
        for e in range(s0, s0 + eps):
            ze = out[:, e]
            total = total + ze
            sq = (ze.double() * ze.double() + sq.double()).float()
        mean = total * inv_n
        var = sq * inv_n - mean * mean
        inv = torch.where(var <= 0, torch.tensor(0.0),
                          1 / torch.sqrt(var.clamp(min=0)))
        raw = out[:, s0:s0 + eps]
        out[:, s0:s0 + eps] = (raw - mean[:, None]) * inv[:, None]
    return out


@pytest.mark.parametrize("e,eps", [(15, 5), (12, 6), (36, 12), (80, 40)])
def test_k3_tcl_chunked_matches_pallas_interpret_ragged(e, eps):
    """K3's route for subjects of more than 4 epochs, its arithmetic
    emulated (_chunked_corr_normalize): 5 and 6 epochs a subject end on
    a partial chunk, 12 and 40 on whole ones; ragged B=13, V=37 and
    T=37 (not whole 8-row k-steps).  Two-region inputs (no |r| near 1):
    within the K3 rule (1e-5 in Fisher-z units) of the Pallas kernel in
    interpret mode and of the plain version, and within 1e-5 of the
    same r z-scored in one pass over each subject."""
    t, b, v = 37, 13, 37
    assert tk.corr_route(e, eps) == "tcl"
    blk, data = _two_mask(60 + e, e, t, b, v)
    want = np.asarray(jk3(jnp.asarray(_pad(blk, 16)),
                          jnp.asarray(_pad(data, 48)), eps, tile_b=8,
                          tile_v=16, interpret=True))[:b, :, :v]
    got = _chunked_corr_normalize(_t(blk), _t(data), eps)
    assert got.shape == (b, e, v) and not torch.isnan(got).any()
    got = got.numpy()
    plain = tk.fcma_corr_normalize_plain(_t(blk), _t(data), eps).numpy()
    for ref in (want, plain):
        _assert_k3_close(got, ref, blk, data, eps)
    one_pass = within_subject_normalization(
        _corr_tcm(_t(blk), _t(data)), eps).numpy()
    np.testing.assert_allclose(got, one_pass, rtol=0, atol=1e-5)


@pytest.mark.parametrize("e,eps", [(24, 12), (80, 40)])
def test_k3_tcl_chunked_clamp_confinement(e, eps):
    """Self-correlation, as VoxelSelector.run(clf) runs K3 without
    raw_data2, with planted r = +-1 pairs, through the emulated
    long-subject route: the near-one r formed again in fp32 keep every
    value finite, and outside the poisoned subject groups it agrees
    with the Pallas kernel and the plain version under the K3 rule."""
    t, b, v = 24, 16, 40
    rng = np.random.RandomState(23 + eps)
    data = rng.randn(e, t, v).astype(np.float32)
    data[:, :, 30] = data[:, :, 3]
    data[:, :, 35] = -data[:, :, 9]
    norm = np.asarray(normalize_for_correlation(
        jnp.asarray(data).transpose(0, 2, 1), 2)).transpose(0, 2, 1)
    blk = np.ascontiguousarray(norm[:, :, :b])
    want = np.asarray(jk3(jnp.asarray(blk), jnp.asarray(norm), eps,
                          tile_b=8, tile_v=8, interpret=True))
    got = _chunked_corr_normalize(_t(blk), _t(norm), eps).numpy()
    plain = tk.fcma_corr_normalize_plain(_t(blk), _t(norm), eps).numpy()
    poisoned = _poisoned_groups(blk, norm, eps)
    assert poisoned[3, :, 30].all() and poisoned[9, :, 35].all()
    assert poisoned[np.arange(b), :, np.arange(b)].all()
    assert (~poisoned).mean() > 0.9
    for ref in (want, plain):
        _assert_k3_close(got, ref, blk, norm, eps, keep=~poisoned)
    assert np.isfinite(got).all()


def _tcs_slab(blk, data, eps):
    """(slab, raw) as K1's slab route (route "tcs") writes its slab:
    subjects of at most 4 epochs through K3's short-subject body (r in
    3xTF32, the small part read toward zero; the Fisher-z and z-score),
    z-scored; longer ones through the raw mode of its long-subject body
    (csrc/fcma_corr_tcl.cu): r as _corr_tcm forms it, the near-one r
    again in fp32, and its clamped Fisher-z, raw."""
    if eps <= 4:
        return within_subject_normalization(
            _corr_3xtf32(blk, data, lo=_tf32_trunc), eps), False
    return fisher_z(_corr_tcm(blk, data)), True


def _zscore_as_loaded(z, eps):
    """csrc/fcma_gram_tcs.cu's z-score of a raw slab: per (block voxel,
    subject, voxel), sums of z and z^2 (fmaf: the square exact in
    float64, one rounding) in epoch order, var = E[z^2] - mean^2, the
    inverse std 0 where var <= 0."""
    n_b, n_e, n_v = z.shape
    zr = z.reshape(n_b, n_e // eps, eps, n_v)
    total = torch.zeros(n_b, n_e // eps, n_v)
    sq = torch.zeros(n_b, n_e // eps, n_v)
    for k in range(eps):
        x = zr[:, :, k]
        total = total + x
        sq = (x.double() * x.double() + sq.double()).float()
    inv_n = torch.tensor(1.0, dtype=torch.float32) / eps
    mean = total * inv_n
    var = sq * inv_n - mean * mean
    inv = torch.where(var <= 0, torch.tensor(0.0),
                      1 / torch.sqrt(var.clamp(min=0)))
    return ((zr - mean[:, :, None]) * inv[:, :, None]).reshape(z.shape)


def _gram_tcs(z):
    """The Gram of csrc/fcma_gram_tcs.cu on a normalized slab: each value
    split into hi = tf32(x) to nearest and lo = x - hi read toward zero;
    per stage of 32 voxels the products lo*hi + hi*lo + hi*hi summed
    from 0, then added in fp32 to the running sum, stages in order."""
    hi = _tf32_rna(z)
    lo = _tf32_trunc(z - hi)
    acc = torch.zeros(z.shape[0], z.shape[1], z.shape[1])
    for k0 in range(0, z.shape[2], 32):
        h, w = hi[:, :, k0:k0 + 32], lo[:, :, k0:k0 + 32]
        acc = acc + (torch.einsum('bev,bfv->bef', w, h)
                     + torch.einsum('bev,bfv->bef', h, w)
                     + torch.einsum('bev,bfv->bef', h, h))
    return acc


@pytest.mark.parametrize("e,eps", [(108, 4), (120, 12), (216, 108)])
def test_k1_tcs_3xtf32_matches_pallas_interpret_ragged(e, eps):
    """K1's slab route beyond 104 epochs, its arithmetic emulated: the
    slab's correlation formed once in 3xTF32 (K3's short-subject body
    at 4 epochs a subject, z-scored; the raw Fisher-z of its
    long-subject body, near-one r again in fp32, at 12 and at 108, a
    subject longer than 104 epochs), z-scored as the Gram loads it, and
    the Gram in 3xTF32 with hi / lo splits.  Ragged B=13, V=37 and
    T=9 (below the 16-row stage).  Two-region inputs: within 1e-4 of
    each voxel's K[0, 0] of the Pallas kernel in interpret mode and of
    the plain version."""
    t, b, v = 9, 13, 37
    assert tk.gram_route(e, eps)[0] == "tcs"
    blk, data = _two_mask(80 + e, e, t, b, v)
    want = np.asarray(jk1(jnp.asarray(_pad(blk, 16)),
                          jnp.asarray(_pad(data, 48)), eps, tile_b=8,
                          tile_v=16, interpret=True))[:b]
    slab, raw = _tcs_slab(_t(blk), _t(data), eps)
    assert raw == (eps > 4)
    z = _zscore_as_loaded(slab, eps) if raw else slab
    got = _gram_tcs(z).numpy()
    assert got.shape == (b, e, e) and np.array_equal(got, got.transpose(
        0, 2, 1))
    _assert_gram_close(got, want)
    _assert_gram_close(got, tk.fcma_gram_plain(_t(blk), _t(data),
                                               eps).numpy())


@pytest.mark.parametrize("e,eps", [(108, 4), (120, 12)])
def test_k1_tcs_3xtf32_clamp_confinement(e, eps):
    """One-mask input beyond 104 epochs, with self pairs (r = 1) and
    planted r = +-1 pairs, through the emulated slab route: its
    normalized correlation (the raw mode's near-one r formed again in
    fp32 at 12 epochs a subject; K3's short-subject body as it is at 4)
    agrees with the Pallas kernel's outside the poisoned subject groups
    and is finite everywhere; so is its Gram."""
    t, b, v = 20, 16, 32
    rng = np.random.RandomState(31 + eps)
    data = rng.randn(e, t, v).astype(np.float32)
    data[:, :, 21] = data[:, :, 5]
    data[:, :, 27] = -data[:, :, 11]
    norm = np.asarray(normalize_for_correlation(
        jnp.asarray(data).transpose(0, 2, 1), 2)).transpose(0, 2, 1)
    blk = np.ascontiguousarray(norm[:, :, :b])
    want = np.asarray(jk3(jnp.asarray(blk), jnp.asarray(norm), eps,
                          tile_b=8, tile_v=16, interpret=True))
    slab, raw = _tcs_slab(_t(blk), _t(norm), eps)
    z = _zscore_as_loaded(slab, eps) if raw else slab
    poisoned = _poisoned_groups(blk, norm, eps)
    assert poisoned[5, :, 21].all() and poisoned[11, :, 27].all()
    assert poisoned[np.arange(b), :, np.arange(b)].all()
    assert (~poisoned).mean() > 0.9
    np.testing.assert_allclose(z.numpy()[~poisoned], want[~poisoned],
                               atol=1e-4)
    assert torch.isfinite(z).all() and torch.isfinite(_gram_tcs(z)).all()


def test_tcs_slabs():
    """K1's slab route's planner: block voxels a slab from the 8 GiB
    budget (151 fit at E=216, V=65536), in whole items of 128 of K3's
    bodies where 128 fit, else in multiples of 4 (a slab's first block
    voxel starts a 16-byte aligned column); at least 4 whatever the
    budget; the slabs as even as that allows.  The Gram's V split
    depends on V alone, so a block voxel's Gram does not depend on
    the slab."""
    assert tk._TCS_BUDGET == 8 * 2 ** 30
    assert tk._TCS_BUDGET // (4 * 216 * 65536) == 151
    assert tk.tcs_slabs(1024, 216, 65536) == (128, 8)
    assert tk.tcs_slabs(1000, 216, 65536) == (128, 8)
    assert tk.tcs_slabs(512, 128, 4096) == (512, 1)
    per = 4 * 216 * 100
    assert tk.tcs_slabs(100, 216, 100, budget=50 * per) == (36, 3)
    assert tk.tcs_slabs(10, 216, 100, budget=per) == (4, 3)
    assert tk.tcs_slabs(3, 216, 100) == (3, 1)
    assert tk.tcs_slabs(1, 216, 100, budget=1) == (1, 1)
    assert tk.tcs_slabs(0, 216, 100)[1] == 0
    rng = np.random.RandomState(3)
    for _ in range(200):
        n_b = int(rng.randint(1, 3000))
        n_e = int(rng.randint(105, 801))
        n_v = int(rng.randint(1, 70000))
        budget = int(rng.randint(1, 2 ** 34))
        bc, n_slabs = tk.tcs_slabs(n_b, n_e, n_v, budget)
        assert n_slabs == -(-n_b // bc) and 1 <= bc <= n_b
        assert bc == n_b or bc % 4 == 0
        assert bc <= max(4, budget // (4 * n_e * n_v))
        if budget // (4 * n_e * n_v) >= 128 and bc < n_b:
            assert bc % 128 == 0
    assert tk._tcs_split(65536) == 8 and tk._tcs_split(4096) == 2
    assert tk._tcs_split(1000) == 1 and tk._tcs_split(10 ** 6) == 8


@pytest.mark.parametrize("n_epochs,eps,expect", [
    (32, 4, "tc"), (16, 4, "tc"), (48, 4, "tc"), (8, 2, "tc"),
    (3, 1, "tc"), (12, 3, "tc"), (12, 6, "tcl"), (24, 12, "tcl"),
    (40, 10, "tcl"), (80, 40, "tcl"), (96, 48, "tcl"),
    (64, 64, "tcl"), (96, 12, "tcl"), (30, 5, "tcl")])
def test_corr_route(n_epochs, eps, expect):
    """Subjects of at most 4 epochs take K3's tensor-core kernel
    csrc/fcma_corr_tc.cu, longer subjects csrc/fcma_corr_tcl.cu,
    whatever the number of epochs."""
    assert tk.corr_route(n_epochs, eps) == expect


def test_corr_route_forced():
    assert tk.corr_route(32, 4, route="ffma") == "ffma"
    assert tk.corr_route(48, 4, route="tc") == "tc"
    assert tk.corr_route(80, 40, route="ffma") == "ffma"
    assert tk.corr_route(30, 5, route="tcl") == "tcl"
    with pytest.raises(ValueError, match="at most 4 epochs"):
        tk.corr_route(80, 40, route="tc")
    with pytest.raises(ValueError, match="at most 4 epochs"):
        tk.corr_route(12, 6, route="tc")
    for n_epochs, eps in ((32, 4), (12, 3), (3, 1)):
        with pytest.raises(ValueError, match="more than 4 epochs"):
            tk.corr_route(n_epochs, eps, route="tcl")
    with pytest.raises(ValueError, match="'tc', 'tcl' or 'ffma'"):
        tk.corr_route(16, 4, route="wgmma")
    with pytest.raises(ValueError, match="multiple"):
        tk.corr_route(10, 4)


@pytest.mark.parametrize("n,norm_unit,expect", [
    (32, 4, ("tc", 32, 32, 1)),
    (32, 0, ("tc", 32, 32, 1)),
    (24, 8, ("tc", 32, 32, 1)),
    (24, 1, ("tc", 32, 32, 1)),
    (30, 10, ("tc", 32, 30, 1)),
    (16, 2, ("tc", 16, 16, 1)),
    (12, 12, ("tc", 16, 12, 1)),
    (8, 0, ("tc", 16, 16, 1)),
    (33, 0, ("tcm", 32, 32, 2)),
    (40, 4, ("tcm", 32, 32, 2)),
    (96, 12, ("tcm", 32, 24, 4)),
    (40, 40, ("tcm", 32, 32, 2)),
    (80, 40, ("tcm", 32, 32, 3)),
    (104, 52, ("tcm", 32, 32, 4)),
    (108, 4, ("tcs", 32, 32, 4)),
    (105, 0, ("tcs", 32, 32, 4)),
    (112, 0, ("tcs", 32, 32, 4)),
    (120, 12, ("tcs", 32, 24, 5)),
    (216, 12, ("tcs", 32, 24, 9)),
    (216, 0, ("tcs", 32, 32, 7)),
    (216, 108, ("tcs", 32, 32, 7)),
    (800, 4, ("tcs", 32, 32, 25)),
    (800, 0, ("tcs", 32, 32, 25)),
    (792, 12, ("tcs", 32, 24, 33)),
    (801, 0, ("ffma", 32, 32, 26)),
    (804, 4, ("ffma", 32, 32, 26)),
    (804, 12, ("ffma", 32, 24, 34)),
])
def test_sample_gram_route(n, norm_unit, expect):
    """One sample tile of whole groups (raw features: groups of one)
    takes K4's one-tile tensor-core kernel; more tiles, or groups longer
    than a tile, the multi-tile one up to 104 samples, the slab route
    beyond up to 800 samples, whatever the group length, and the FMA
    one beyond that."""
    assert tk.sample_gram_route(n, norm_unit) == expect
    assert tk.sample_gram_route(n, norm_unit)[1:] == tk.epoch_tiles(
        n, max(norm_unit, 1))


def test_sample_gram_route_forced():
    assert tk.sample_gram_route(32, 4, route="ffma") == ("ffma", 32, 32, 1)
    assert tk.sample_gram_route(12, 0, route="tc") == ("tc", 16, 16, 1)
    with pytest.raises(ValueError, match="one sample tile"):
        tk.sample_gram_route(96, 12, route="tc")
    with pytest.raises(ValueError, match="one sample tile"):
        tk.sample_gram_route(40, 40, route="tc")
    with pytest.raises(ValueError, match="one sample tile"):
        tk.sample_gram_route(33, 1, route="tc")
    assert tk.sample_gram_route(48, 4, route="tcm") == ("tcm", 32, 32, 2)
    assert tk.sample_gram_route(108, 4, route="ffma") == \
        ("ffma", 32, 32, 4)
    for n, norm_unit in ((32, 4), (12, 0), (108, 4), (112, 56)):
        with pytest.raises(ValueError, match="route 'tcm'"):
            tk.sample_gram_route(n, norm_unit, route="tcm")
    assert tk.sample_gram_route(216, 12, route="tcs") == \
        ("tcs", 32, 24, 9)
    assert tk.sample_gram_route(105, 0, route="tcs")[0] == "tcs"
    assert tk.sample_gram_route(800, 4, route="tcs")[0] == "tcs"
    for n, norm_unit in ((32, 4), (12, 0), (104, 52), (104, 0), (801, 0),
                         (804, 4)):
        with pytest.raises(ValueError, match="route 'tcs'"):
            tk.sample_gram_route(n, norm_unit, route="tcs")
    with pytest.raises(ValueError, match="'tc', 'tcm', 'tcs' or 'ffma'"):
        tk.sample_gram_route(32, 4, route="wgmma")
    with pytest.raises(ValueError, match="multiple"):
        tk.sample_gram_route(30, 4)


def test_tma_operand_reads_aligned_views_in_place():
    """K3's tensor-core operands: a column slice of a wider tensor whose
    rows are 16-byte aligned passes as it is (no copy), whatever its
    width; anything else is copied once into that layout, values and
    width kept."""
    x = torch.arange(2 * 3 * 37, dtype=torch.float32).reshape(2, 3, 37)
    lay = tk.aligned_rows_layout(x.shape, "cpu")
    assert lay.shape == (2, 3, 37) and lay.stride() == (120, 40, 1)
    assert not lay.any()
    lay.copy_(x)
    assert tk._tma_operand(lay) is lay
    full = torch.zeros(2, 3, 40)
    assert tk._tma_operand(full) is full
    for bad in (x, x[:, :, 1:], x.transpose(1, 2).contiguous()
                .transpose(1, 2)):
        got = tk._tma_operand(bad)
        assert got is not bad and torch.equal(got, bad)
        assert got.stride(2) == 1 and got.stride(1) % 4 == 0
        assert got.stride(0) % 4 == 0 and got.data_ptr() % 16 == 0
    store = torch.zeros(2 * 3 * 40 + 1)
    shifted = store[1:].view(2, 3, 40)
    assert shifted.data_ptr() % 16
    assert tk._tma_operand(shifted).data_ptr() % 16 == 0


@pytest.mark.parametrize("eps", [1, 4, 5, 40])
def test_corr_layout_is_what_the_route_reads_in_place(eps):
    """corr_layout gives the layout of K3's route for these subjects:
    16-byte aligned rows for either tensor-core kernel ("tc" up to 4
    epochs a subject, "tcl" beyond), which _corr_operand passes as it
    is; the FMA kernel, forced, gets a contiguous copy."""
    n_e = 2 * eps
    lay = tk.corr_layout((n_e, 3, 37), eps, "cpu")
    route = tk.corr_route(n_e, eps)
    assert route == ("tc" if eps <= 4 else "tcl")
    assert lay.shape == (n_e, 3, 37) and not lay.is_contiguous()
    assert lay.stride() == (120, 40, 1)
    assert tk._corr_operand(lay, route) is lay
    copy = tk._corr_operand(lay, "ffma")
    assert copy.is_contiguous() and torch.equal(copy, lay)


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
                             "fcma_gram_tcm": 0, "fcma_gram_tcs": 0,
                             "fcma_gram_tcs_tc": 0, "fcma_gram_tcs_tcl": 0,
                             "fcma_gram_tcs_gram": 0,
                             "fcma_corr_normalize": 0,
                             "fcma_corr_normalize_tc": 0,
                             "fcma_corr_normalize_tcl": 0,
                             "fcma_sample_gram": 0,
                             "fcma_sample_gram_tc": 0,
                             "fcma_sample_gram_tcm": 0,
                             "fcma_sample_gram_tcs": 0,
                             "fcma_sample_gram_tcs_tcl": 0,
                             "fcma_sample_gram_tcs_r": 0,
                             "fcma_sample_gram_tcs_gram": 0,
                             "fcma_sample_gram_tcs_sum": 0}


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


def _sample_gram_3xtf32(x1, x2, norm_unit):
    """K4's tensor-core route (csrc/fcma_sample_gram_tc.cu), its
    products emulated: the narrower region as the block operand, r in
    3xTF32 as K1's route forms it, Fisher-z'd and z-scored per group of
    norm_unit samples (raw r when norm_unit <= 1), then the Gram."""
    blk, data = (x2, x1) if x2.shape[2] < x1.shape[2] else (x1, x2)
    corr = _corr_3xtf32(blk, data)
    if norm_unit > 1:
        corr = within_subject_normalization(corr, norm_unit)
    feats = corr.transpose(0, 1).reshape(corr.shape[1], -1)
    return feats @ feats.T


@pytest.mark.parametrize("n,norm_unit", [(12, 4), (12, 0), (32, 8)])
def test_k4_3xtf32_matches_pallas_interpret_ragged(n, norm_unit):
    """The tensor-core route's arithmetic at a ragged one-tile shape (13
    block voxels, 37 voxels, T=37 not a multiple of the 8-row stage)
    within 1e-4 of K[0, 0] of the Pallas kernel's Gram and of the
    plain version's."""
    assert tk.sample_gram_route(n, norm_unit)[0] == "tc"
    x1, x2 = _two_mask(n * 7 + norm_unit, n, 37, 37, 13)
    want = np.asarray(jk4(jnp.asarray(_pad(x1, 48)),
                          jnp.asarray(_pad(x2, 16)), norm_unit, tile_1=16,
                          tile_2=16, interpret=True))
    got = _sample_gram_3xtf32(_t(x1), _t(x2), norm_unit).numpy()
    plain = tk.fcma_sample_gram_plain(_t(x1), _t(x2), norm_unit).numpy()
    for ref in (want, plain):
        assert np.all(np.abs(got - ref) <= 1e-4 * abs(ref[0, 0]))


def _sample_gram_tcm(x1, x2, norm_unit):
    """K4's multi-tile tensor-core route (csrc/fcma_sample_gram_tcm.cu),
    its arithmetic emulated: the narrower region as the block operand,
    every correlation of all N samples formed once as K1's multi-tile
    route forms it (_corr_tcm: 3xTF32 with the small part unrounded,
    near-one r formed again in fp32), Fisher-z'd and z-scored over each
    whole group of norm_unit samples, then summed over the block voxels
    into the Gram; raw r, with no near-one step, when norm_unit <= 1."""
    blk, data = (x2, x1) if x2.shape[2] < x1.shape[2] else (x1, x2)
    if norm_unit > 1:
        corr = within_subject_normalization(_corr_tcm(blk, data),
                                            norm_unit)
    else:
        corr = _corr_3xtf32(blk, data, lo=_tf32_trunc)
    return torch.einsum('bnv,bmv->nm', corr, corr)


@pytest.mark.parametrize("n,norm_unit", [(48, 4), (40, 40), (36, 0)])
def test_k4_tcm_3xtf32_matches_pallas_interpret_ragged(n, norm_unit):
    """The multi-tile route's arithmetic at a ragged shape (13 block
    voxels, 37 voxels, T=37 not a multiple of the 16-row stage): 48
    samples of 4 a group (two sample tiles), 40 in one group (a group
    longer than a tile) and 36 raw.  Two-region inputs (no |r| near 1,
    so no group at the Fisher-z clamp): within 1e-4 of K[0, 0] of the
    Pallas kernel's Gram in interpret mode and of the plain version's."""
    assert tk.sample_gram_route(n, norm_unit)[0] == "tcm"
    x1, x2 = _two_mask(n * 5 + norm_unit, n, 37, 37, 13)
    want = np.asarray(jk4(jnp.asarray(_pad(x1, 48)),
                          jnp.asarray(_pad(x2, 16)), norm_unit, tile_1=16,
                          tile_2=16, interpret=True))
    got = _sample_gram_tcm(_t(x1), _t(x2), norm_unit).numpy()
    plain = tk.fcma_sample_gram_plain(_t(x1), _t(x2), norm_unit).numpy()
    assert got.shape == (n, n)
    for ref in (want, plain):
        assert np.all(np.abs(got - ref) <= 1e-4 * abs(ref[0, 0]))


def _sample_gram_tcs(x1, x2, norm_unit):
    """K4's slab route beyond 104 samples (route "tcs"), its arithmetic
    emulated: the narrower region as the block operand; the slab as
    csrc/fcma_corr_tcl.cu writes it (r as _corr_tcm forms it, the
    near-one r formed again in fp32; its raw mode stores the clamped
    Fisher-z for groups of norm_unit > 1, its r mode r itself), z-scored
    over each group as csrc/fcma_gram_tcs.cu loads it, each block
    voxel's Gram in 3xTF32 (_gram_tcs), and those Grams added in fp32,
    block voxels ascending, from 0, as csrc/fcma_sample_gram_tcs.cu adds
    them."""
    blk, data = (x2, x1) if x2.shape[2] < x1.shape[2] else (x1, x2)
    r = _corr_tcm(blk, data)
    z = _zscore_as_loaded(fisher_z(r), norm_unit) if norm_unit > 1 else r
    out = torch.zeros(r.shape[1], r.shape[1])
    for gram in _gram_tcs(z):
        out = out + gram
    return out


@pytest.mark.parametrize("n,norm_unit", [(108, 4), (120, 12), (112, 0)])
def test_k4_tcs_3xtf32_matches_pallas_interpret_ragged(n, norm_unit):
    """The slab route's arithmetic at a ragged shape (13 block voxels,
    37 voxels, T=9 below the 16-row stage): 108 samples in groups of 4
    (the group length that K3's short-subject body would take, here the
    raw mode all the same), 120 in groups of 12, and 112 raw (the r
    mode).  Two-region inputs (no |r| near 1): within 1e-4 of K[0, 0]
    of the Pallas kernel's Gram in interpret mode and of the plain
    version's; symmetric bit for bit."""
    assert tk.sample_gram_route(n, norm_unit)[0] == "tcs"
    x1, x2 = _two_mask(n * 3 + norm_unit, n, 9, 37, 13)
    want = np.asarray(jk4(jnp.asarray(_pad(x1, 48)),
                          jnp.asarray(_pad(x2, 16)), norm_unit, tile_1=16,
                          tile_2=16, interpret=True))
    got = _sample_gram_tcs(_t(x1), _t(x2), norm_unit).numpy()
    plain = tk.fcma_sample_gram_plain(_t(x1), _t(x2), norm_unit).numpy()
    assert got.shape == (n, n) and np.array_equal(got, got.T)
    for ref in (want, plain):
        assert np.all(np.abs(got - ref) <= 1e-4 * abs(ref[0, 0]))


@pytest.mark.parametrize("n,norm_unit", [(108, 4), (120, 12), (112, 0)])
def test_k4_tcs_3xtf32_clamp_confinement(n, norm_unit):
    """Self pairs (region 2 holds region 1, as the study's stage 2 fit
    of mask1 x the whole volume) and planted r = +-1 pairs beyond 104
    samples, through the emulated slab route.  Groups of norm_unit: its
    features (the raw mode's near-one r formed again in fp32, Fisher-z'd
    and z-scored as the Gram loads them) agree with the Pallas K3's
    outside the poisoned groups and are finite everywhere, and so is
    the Gram.  Raw features (the r mode): no clamp, so the Gram is the
    Pallas kernel's within 1e-4 of K[0, 0], and each self-pair r is
    within 1e-6 of 1."""
    t, b, v = 20, 16, 32
    rng = np.random.RandomState(43 + norm_unit)
    data = rng.randn(n, t, v).astype(np.float32)
    data[:, :, 21] = data[:, :, 5]
    data[:, :, 27] = -data[:, :, 11]
    norm = np.asarray(normalize_for_correlation(
        jnp.asarray(data).transpose(0, 2, 1), 2)).transpose(0, 2, 1)
    blk = np.ascontiguousarray(norm[:, :, :b])
    r = _corr_tcm(_t(blk), _t(norm))
    if norm_unit <= 1:
        self_r = r[np.arange(b), :, np.arange(b)]
        assert torch.all((self_r - 1).abs() <= 1e-6)
        want = np.asarray(jk4(jnp.asarray(blk), jnp.asarray(norm), 0,
                              tile_1=16, tile_2=16, interpret=True))
        got = _sample_gram_tcs(_t(blk), _t(norm), 0).numpy()
        assert np.all(np.abs(got - want) <= 1e-4 * abs(want[0, 0]))
        return
    want = np.asarray(jk3(jnp.asarray(blk), jnp.asarray(norm), norm_unit,
                          tile_b=8, tile_v=16, interpret=True))
    z = _zscore_as_loaded(fisher_z(r), norm_unit)
    poisoned = _poisoned_groups(blk, norm, norm_unit)
    assert poisoned[5, :, 21].all() and poisoned[11, :, 27].all()
    assert poisoned[np.arange(b), :, np.arange(b)].all()
    assert (~poisoned).mean() > 0.9
    np.testing.assert_allclose(z.numpy()[~poisoned], want[~poisoned],
                               atol=1e-4)
    gram = _sample_gram_tcs(_t(blk), _t(norm), norm_unit)
    assert torch.isfinite(z).all() and torch.isfinite(gram).all()


@pytest.mark.parametrize("norm_unit", [0, 4])
@pytest.mark.parametrize("widths", [(9, 4), (3, 7)])
def test_classifier_cpu_matches_pallas_sample_gram(norm_unit, widths):
    """The port's portioned Classifier on the CPU (K4's plain version)
    at the sizes of tests/test_torch_classifier.py (20 samples of 12
    TRs, regions of 3-9 voxels, 12 of them for training): its test
    similarities are the JAX package's fcma_sample_gram (Pallas,
    interpret mode) under the same digit shrink, within 1e-4 of the
    shrunk K[0, 0]."""
    from sklearn import svm

    from brainiak_tpu_torch.fcma import Classifier

    r1, r2 = _two_mask(31 + norm_unit, 20, 12, widths[0], widths[1])
    wide, narrow = (r1, r2) if widths[0] > widths[1] else (r2, r1)
    gram = np.asarray(jk4(jnp.asarray(_pad(wide, 16)),
                          jnp.asarray(_pad(narrow, 16)), norm_unit,
                          tile_1=16, tile_2=16, interpret=True))
    digits = len(str(int(gram[0, 0])))
    scale = 10.0 ** (2 - digits) if digits > 2 else 1.0
    clf = Classifier(svm.SVC(kernel="precomputed"), num_processed_voxels=2,
                     epochs_per_subj=norm_unit, device="cpu")
    clf.fit(list(zip(r1, r2)), [0, 1] * 10, num_training_samples=12)
    assert clf.num_digits_ == digits
    assert clf.test_data_.shape == (8, 12)
    assert np.all(np.abs(clf.test_data_ - gram[12:, :12] * scale)
                  <= 1e-4 * abs(gram[0, 0]) * scale)


@pytest.mark.parametrize("norm_unit", [0, 4])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_classifier_cpu_matches_jax_beyond_104_samples(norm_unit,
                                                       use_pallas):
    """The slice beyond 104 samples (K4's route "tcs" on the card): 27
    subjects x 4 samples of 12 TRs, regions of 9 and 4 voxels, the last
    subject held out.  The port's portioned Classifier on the CPU (K4's
    plain version) against the JAX package's on the same inputs, its
    portioned XLA Gram or its Pallas kernel in interpret mode: the same
    digit shrink, test similarities within 1e-4 of the shrunk K[0, 0],
    the same predictions and decision values within 5e-3."""
    from sklearn import svm

    from brainiak_tpu.fcma.classifier import Classifier as JaxClassifier
    from brainiak_tpu_torch.fcma import Classifier

    n, n_train = 108, 104
    assert tk.sample_gram_route(n, norm_unit)[0] == "tcs"
    r1, r2 = _two_mask(61 + norm_unit, n, 12, 9, 4)
    pairs = list(zip(r1, r2))
    labels = [0, 1] * (n // 2)

    def make():
        return svm.SVC(kernel="precomputed", shrinking=False, C=1)

    port = Classifier(make(), num_processed_voxels=2,
                      epochs_per_subj=norm_unit, device="cpu")
    ref = JaxClassifier(make(), num_processed_voxels=2,
                        epochs_per_subj=norm_unit, use_pallas=use_pallas)
    for clf in (port, ref):
        clf.fit(pairs, labels, num_training_samples=n_train)
    gram = tk.fcma_sample_gram(_t(r1), _t(r2), norm_unit)
    k00 = abs(float(gram[0, 0])) * 10.0 ** min(0, 2 - port.num_digits_)
    assert port.num_digits_ == ref.num_digits_
    assert port.test_data_.shape == (n - n_train, n_train)
    assert np.all(np.abs(port.test_data_ - ref.test_data_) <= 1e-4 * k00)
    np.testing.assert_array_equal(port.predict(), ref.predict())
    np.testing.assert_allclose(port.decision_function(),
                               ref.decision_function(), atol=5e-3, rtol=0)


def test_k4_plain_groups_of_two_miss_float64():
    """Why tests/test_torch_gpu.py holds K4 at norm_unit=2 to float64
    and not to the plain version: with two samples a group the one-pass
    variance E[z^2] - mean^2 cancels where the group's two Fisher-z
    values nearly coincide, and the plain fp32 version itself lands
    more than 1e-4 of K[0, 0] from the same formula in float64 (at the
    GPU test's N=32, 37 x 203 voxels, T=37); with four samples a group
    it stays within 1e-6."""
    x1, x2 = _two_mask(11, 32, 37, 37, 203)
    for norm_unit, low, high in ((2, 1e-4, 1e-2), (4, 0, 1e-6)):
        plain = tk.fcma_sample_gram_plain(_t(x1), _t(x2), norm_unit)
        corr = torch.einsum('ntb,ntv->bnv', _t(x1).double(),
                            _t(x2).double())
        feats = within_subject_normalization(corr, norm_unit)
        feats = feats.transpose(0, 1).reshape(32, -1)
        exact = feats @ feats.T
        err = ((plain.double() - exact).abs().max() / exact[0, 0]).item()
        assert low < err <= high, (norm_unit, err)


def test_k4_plain_is_k1_summed_over_block_voxels():
    """K4(x1, x2, u) = sum_b K1(x1, x2, u)[b], whichever region is the
    block operand."""
    x1, x2 = _two_mask(5, 12, 20, 150, 9)
    g1 = tk.fcma_gram_plain(_t(x1), _t(x2), 4).sum(dim=0)
    for a, b in ((x1, x2), (x2, x1)):
        got = tk.fcma_sample_gram(_t(a), _t(b), 4)
        assert torch.all((got - g1).abs() <= 1e-4 * g1[0, 0].abs())


@pytest.mark.parametrize("norm_unit", [0, 4])
def test_k4_plain_blocks_the_wider_region(norm_unit):
    """The plain K4 blocks the wider region, whichever argument it is,
    so both orders give the same Gram bit for bit, and that Gram is
    the one blocked over the wider region by hand."""
    x1, x2 = _two_mask(9 + norm_unit, 12, 20, 5, 300)
    a = tk.fcma_sample_gram_plain(_t(x1), _t(x2), norm_unit)
    b = tk.fcma_sample_gram_plain(_t(x2), _t(x1), norm_unit)
    assert torch.equal(a, b)
    want = torch.zeros(12, 12)
    for s in range(0, 300, 128):
        blk = _t(x2)[:, :, s:s + 128]
        feats = (tk.fcma_corr_normalize_plain(blk, _t(x1), norm_unit)
                 if norm_unit > 1 else
                 torch.einsum('ntb,ntv->bnv', blk, _t(x1)))
        feats = feats.transpose(0, 1).reshape(12, -1)
        want += feats @ feats.T
    assert torch.allclose(a, want, rtol=1e-6, atol=0)


def test_k4_refuses_samples_that_cut_a_group():
    x = torch.zeros(10, 6, 3)
    with pytest.raises(ValueError, match="multiple"):
        tk.fcma_sample_gram(x, x, 4)
    assert tk.fcma_sample_gram(x, x, 0).shape == (10, 10)
