"""K5's tensor-core route (``csrc/ring_mma_tc.cu``) on the CPU: its
pre-pass's plain version, and a model of its 3xTF32 arithmetic against
the JAX Pallas ring step and against float64.

The kernel itself runs only on the card: ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` hold it to the plain product, and on raw inputs
to float64.  What runs here of the port is :func:`split_kmajor` and
:func:`t_padded`; the rest is a model of the route, not evidence about
the kernel.  The model: each operand split by :func:`split_kmajor` into
``hi`` (TF32, to nearest) and ``lo`` (read by the tensor core with its
13 low bits dropped); per 32-row stage, the products lo.hi, hi.lo,
hi.hi of each k8 step summed exactly and added to the stage's partial,
rounded toward zero to fp32; each stage's partial added to the sum in
fp32.  The rounding toward zero is a hypothesis fitted to one reading
on the card (summed over all of T in one accumulator, raw products came
out 20 times further from float64 than an fp32 product), and it is why
the kernel keeps a partial a stage.  The tests show that, under that
model, the route can meet K5's gates: ``K5_ATOL`` (1e-5 on Pearson r,
``chip_smoke.py``) on z-scored inputs, and four times the fp32 plain
version's own error against float64 on raw ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.ops.kernels import ring as jkring
from brainiak_tpu_torch.ops.kernels import ring as kring

K5_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _tf32_trunc(x):
    """float32 -> TF32 as the tensor core reads an operand whose 13 low
    bits are not cleared: toward zero."""
    return (_bits(x) & -0x2000).view(torch.float32)


def _round_toward_zero(x):
    """float64 -> float32, rounded toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _block_3xtf32(z, rot, stage=32):
    """z.T @ rot as the model of the tensor-core route forms it (module
    docstring): ``stage`` T rows a partial, None for one partial over
    all of T."""
    t_pad = kring.t_padded(z.shape[0])
    a_hi, a_lo = (x.numpy() for x in kring.split_kmajor(z, t_pad))
    b_hi, b_lo = (x.numpy() for x in kring.split_kmajor(rot, t_pad))
    a_lo = _tf32_trunc(torch.from_numpy(a_lo)).numpy()
    b_lo = _tf32_trunc(torch.from_numpy(b_lo)).numpy()
    total = np.zeros((z.shape[1], rot.shape[1]), np.float32)
    part = np.zeros_like(total)
    for t0 in range(0, t_pad, 8):
        k8 = slice(t0, t0 + 8)
        for a, b in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            exact = a[:, k8].astype(np.float64) @ b[:, k8].T.astype(
                np.float64)
            part = _round_toward_zero(part.astype(np.float64) + exact)
        if stage and (t0 + 8) % stage == 0:
            total += part
            part[:] = 0
    return torch.from_numpy(total + part)


def _zscored(rng, t, v):
    """[T, V] float32 columns z-scored with 1/sqrt(T) (a product of two
    columns is their Pearson r), a constant column as 0."""
    x = rng.randn(t, v).astype(np.float32)
    x[:, 1] = 2.5
    x -= x.mean(axis=0)
    sd = x.std(axis=0) * np.sqrt(t)
    return np.where(sd > 0, x / np.where(sd > 0, sd, 1), 0).astype(
        np.float32)


def test_t_padded():
    assert [kring.t_padded(t) for t in (0, 1, 32, 33, 600)] == \
        [32, 32, 32, 64, 608]


def test_split_kmajor_splits_exactly():
    """hi has its 13 low bits zero, hi + lo == x exactly on finite
    inputs of any magnitude, the pad t >= T is zero, a NaN column stays
    NaN, and a strided operand splits as its contiguous copy."""
    rng = np.random.RandomState(0)
    x = rng.randn(37, 50).astype(np.float32)
    x *= np.float32(10.0) ** rng.randint(-30, 30, size=x.shape)
    x[:, 4] = 0.0
    x[5, 9] = np.nan
    xt = torch.from_numpy(x)
    hi, lo = kring.split_kmajor(xt, 64)
    assert hi.shape == lo.shape == (50, 64)
    assert hi.dtype == lo.dtype == torch.float32
    assert not bool((_bits(hi) & 0x1FFF).any())
    finite = torch.ones(50, dtype=torch.bool)
    finite[9] = False
    assert torch.equal((hi + lo)[finite, :37], xt.T[finite])
    assert torch.equal(hi[finite, :37], xt.T[finite] - lo[finite, :37])
    assert not bool(hi[:, 37:].any()) and not bool(lo[:, 37:].any())
    assert bool(torch.isnan(hi[9, 5] + lo[9, 5]))
    assert not bool(torch.isnan(hi[9, :5] + lo[9, :5]).any())
    assert torch.equal(_bits(hi[4]), torch.zeros(64, dtype=torch.int32))
    wide = torch.zeros(37, 100)
    wide[:, ::2] = xt
    hs, ls = kring.split_kmajor(wide[:, ::2], 64)
    assert torch.equal(_bits(hs), _bits(hi)) and \
        torch.equal(_bits(ls), _bits(lo))


def test_split_kmajor_rounds_to_nearest_ties_away():
    """hi rounds as cvt.rna.tf32.f32: to nearest, ties away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([[1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                       1 + 3 * ulp / 4, 3.0]], dtype=torch.float32)
    hi, lo = kring.split_kmajor(x, 32)
    assert hi[:, 0].tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0]
    assert lo[:, 0].tolist() == [-ulp / 2, ulp / 2, ulp / 4, -ulp / 4, 0.0]


def test_3xtf32_ring_step_matches_jax_on_zscored_inputs():
    """The model of the route at T=600, n_local=384, B=256, owner 2 of
    4, against the JAX Pallas step (interpreter mode): within K5_ATOL,
    the NaN column's row and column NaN, the constant column's exactly
    0, the other blocks the sentinel."""
    rng = np.random.RandomState(5)
    z = _zscored(rng, 600, 384)
    rot = _zscored(rng, 600, 256)
    z[:, 7] = np.nan
    rot[:, 100] = np.nan
    out0 = np.full((384, 4 * 256), -7.0, np.float32)
    want = np.asarray(jkring.ring_mma(jnp.asarray(out0), jnp.asarray(z),
                                      jnp.asarray(rot), 2, n_shards=4,
                                      interpret=True))
    got = out0.copy()
    block = _block_3xtf32(torch.from_numpy(z), torch.from_numpy(rot))
    got[:, 512:768] = block.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert int(np.isnan(got).sum()) == 384 + 256 - 1
    np.testing.assert_allclose(got, want, atol=K5_ATOL, rtol=0)
    assert np.all(got[1, 512:768][~np.isnan(got[1, 512:768])] == 0)
    assert np.all(got[:, 513][~np.isnan(got[:, 513])] == 0)
    others = np.ones(1024, bool)
    others[512:768] = False
    assert np.array_equal(got[:, others], out0[:, others])


@pytest.mark.parametrize("scale_z,scale_rot", [(1e3, 1e3), (1e-3, 1e-3),
                                               (1e3, 1e-3)])
def test_3xtf32_ring_step_error_on_raw_inputs(scale_z, scale_rot):
    """Unnormalized inputs: the model's error against the float64
    product within four times the fp32 plain version's (mma_update),
    and the JAX Pallas step within the same.  Under the model, one
    partial over all of T instead of one a stage misses that rule by
    more than twice: the model's reason for the kernel's partials."""
    rng = np.random.RandomState(11)
    z = (rng.randn(600, 384) * scale_z).astype(np.float32)
    rot = (rng.randn(600, 256) * scale_rot).astype(np.float32)
    exact = z.astype(np.float64).T @ rot.astype(np.float64)
    got = _block_3xtf32(torch.from_numpy(z), torch.from_numpy(rot))
    plain = kring.mma_update(torch.zeros(384, 256), torch.from_numpy(z),
                             torch.from_numpy(rot), 0)
    jax_out = np.asarray(jkring.ring_mma(
        jnp.zeros((384, 256), jnp.float32), jnp.asarray(z),
        jnp.asarray(rot), 0, n_shards=1, interpret=True))
    err = np.abs(got.numpy() - exact).max()
    err_plain = np.abs(plain.numpy() - exact).max()
    assert err <= 4 * err_plain, (err, err_plain)
    assert np.abs(jax_out - exact).max() <= 4 * err_plain
    one_partial = _block_3xtf32(torch.from_numpy(z), torch.from_numpy(rot),
                                stage=None)
    assert np.abs(one_partial.numpy() - exact).max() > 8 * err_plain


def test_route_names():
    """The launcher and the launch counts know the routes "tc" and
    "ffma" (and "split", the pre-pass's count) and refuse others."""
    z, rot = torch.randn(6, 8), torch.randn(6, 4)
    with pytest.raises(ValueError, match="route"):
        kring.launches("mma")
    with pytest.raises(ValueError, match="route"):
        kring._kernel_ring_mma(torch.zeros(8, 8), z, rot, 1, n_shards=2,
                               route="mma")
    kring.reset_launches()
    assert [kring.launches(r) for r in (None, "tc", "ffma", "split")] == \
        [0, 0, 0, 0]


def test_split_stands_in_for_its_operand():
    """A Split has its operand's shape, dtype and device, passes the
    step's checks in the operand's place, and moves as a tensor does
    (itself on its own device)."""
    x = torch.randn(37, 50)
    s = kring.Split(*kring.split_kmajor(x, kring.t_padded(37)), 37)
    assert s.shape == (37, 50) and s.dtype == torch.float32
    assert s.device == x.device and s.dim() == 2
    assert s.to("cpu").hi is s.hi and s.to("cpu").lo is s.lo
    kring._check(torch.zeros(50, 3 * 40), s, torch.zeros(37, 40), 2, 3)
    with pytest.raises(ValueError, match="differ in T"):
        kring._check(torch.zeros(50, 40), s, torch.zeros(36, 40), 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kring.split(x)


def test_kernel_launcher_refuses_cpu_tensors():
    """The kernels take CUDA tensors only: on the CPU the public step
    runs its plain version, and the launcher raises instead of
    computing."""
    z, rot = torch.randn(6, 8), torch.randn(6, 4)
    kring.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kring._kernel_ring_mma(torch.zeros(8, 8), z, rot, 1, n_shards=2)
    out = kring.ring_mma(torch.zeros(8, 8), z, rot, 1, n_shards=2)
    torch.testing.assert_close(out[:, 4:], z.T @ rot)
    assert kring.launches() == 0 and kring.launches("tc") == 0 and \
        kring.launches("split") == 0
