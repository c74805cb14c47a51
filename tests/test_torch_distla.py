"""The port's mesh, SUMMA ring step (K5's plain route) and ring Gram
against the JAX package on the CPU.

The JAX side runs on the 8-device CPU mesh of ``tests/conftest.py``;
the port on meshes of repeated ``"cpu"`` devices.  Inputs are float32
arrays made with numpy from a seed; the JAX package computes in
float64 here (the harness turns x64 on), the port in float32.
Tolerance: 1e-5 absolute on correlations (entries are Pearson r in
[-1, 1]; float32 sums over T in another order), 1e-5 relative on raw
products.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.ops import distla as jdistla
from brainiak_tpu.ops import ring as jring
from brainiak_tpu.ops.kernels import ring as jkring
from brainiak_tpu.parallel import compat as jcompat
from brainiak_tpu.parallel import make_mesh as jmake_mesh
from brainiak_tpu_torch.ops import distla
from brainiak_tpu_torch.ops import ring as tring
from brainiak_tpu_torch.ops.kernels import ring as kring
from brainiak_tpu_torch.parallel import mesh as tmesh

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_ring(monkeypatch):
    """The JAX package's SUMMA ring, the reference.  jax releases that
    type-check shard_map's varying manual axes reject the reference
    ring's scan carry (``tests/ops/test_distla.py`` fails there); that
    check is a type check only, so the reference program is built with
    it off.  Its program cache is cleared before and after, so no other
    test gets that build."""
    monkeypatch.setattr(jdistla, "shard_map", functools.partial(
        jcompat.shard_map, check_vma=False))
    jdistla._summa_program.cache_clear()
    yield jdistla
    jdistla._summa_program.cache_clear()


def _cpu_mesh(names=("voxel",), sizes=(4,)):
    return tmesh.make_mesh(names, sizes,
                           devices=["cpu"] * int(np.prod(sizes)))


def _data(seed, t, v):
    return np.random.RandomState(seed).randn(t, v).astype(np.float32)


# -- the ring step ----------------------------------------------------

@pytest.mark.parametrize("t,vl,b", [(16, 32, 8), (7, 48, 5)])
def test_ring_step_matches_jax(t, vl, b):
    """mma_update and ring_mma (CPU route) against the JAX Pallas step
    (interpreter mode) and its XLA twin, at owner 2 of 4 shards; the
    other blocks stay bit-identical to the sentinel."""
    rng = np.random.RandomState(t)
    z = rng.randn(t, vl).astype(np.float32)
    rot = rng.randn(t, b).astype(np.float32)
    out0 = np.full((vl, 4 * b), -1.0, np.float32)
    want = np.asarray(jkring.ring_mma(jnp.asarray(out0), jnp.asarray(z),
                                      jnp.asarray(rot), 2, n_shards=4,
                                      tile_r=16, interpret=True))
    want_xla = np.asarray(jkring.mma_update(jnp.asarray(out0),
                                            jnp.asarray(z),
                                            jnp.asarray(rot), 2 * b))
    kring.reset_launches()
    for fn in (lambda o: kring.mma_update(o, torch.from_numpy(z),
                                          torch.from_numpy(rot), 2 * b),
               lambda o: kring.ring_mma(o, torch.from_numpy(z),
                                        torch.from_numpy(rot), 2,
                                        n_shards=4)):
        out = torch.from_numpy(out0.copy())
        got = fn(out)
        assert got is out
        got = got.numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, want_xla, atol=ATOL, rtol=0)
        others = np.ones(4 * b, bool)
        others[2 * b:3 * b] = False
        assert np.array_equal(got[:, others], out0[:, others])
    assert kring.launches() == 0


def test_ring_step_writes_into_a_row_slab():
    """A row slab of a wider buffer (the one-device ring's output) is
    written in place; the rows outside the slab are untouched."""
    z, rot = torch.randn(6, 4), torch.randn(6, 4)
    full = torch.full((12, 12), -1.0)
    kring.ring_mma(full[4:8], z, rot, 1, n_shards=3)
    np.testing.assert_allclose(full[4:8, 4:8].numpy(), (z.T @ rot).numpy(),
                               atol=ATOL)
    mask = torch.ones(12, 12, dtype=torch.bool)
    mask[4:8, 4:8] = False
    assert torch.all(full[mask] == -1.0)


def test_ring_step_refuses_bad_inputs():
    z, rot = torch.zeros(5, 8), torch.zeros(5, 4)
    out = torch.zeros(8, 12)
    with pytest.raises(ValueError, match="owner"):
        kring.ring_mma(out, z, rot, 3, n_shards=3)
    with pytest.raises(ValueError, match="out"):
        kring.ring_mma(out, z, rot, 0, n_shards=4)
    with pytest.raises(ValueError, match="T"):
        kring.ring_mma(out, z, rot[:4], 0, n_shards=3)
    with pytest.raises(TypeError):
        kring.ring_mma(out.double(), z.double(), rot.double(), 0,
                       n_shards=3)
    with pytest.raises(ValueError, match="stride"):
        kring.ring_mma(torch.zeros(12, 8).T, z, rot, 0, n_shards=3)


def test_ring_hands_panels_on_in_order(monkeypatch):
    """Each of the n steps runs one ring step per position, with the
    reference's owner (position - step) mod n; the panel is the owner's
    own tensor, handed on with no copy on one device; every position
    writes a row slab of one [V, V] buffer."""
    calls = []
    real = distla.ring_mma

    def spy(out, z_local, rotating, owner, *, n_shards, precision=None):
        calls.append((out, z_local, rotating, owner))
        return real(out, z_local, rotating, owner, n_shards=n_shards,
                    precision=precision)

    monkeypatch.setattr(distla, "ring_mma", spy)
    data = _data(0, 12, 20)
    mesh = _cpu_mesh()
    got = distla.summa_gram(data, mesh)
    assert len(calls) == 16
    resident = [calls[i][1] for i in range(4)]
    panels = [calls[i][2] for i in range(4)]
    base = calls[0][0].untyped_storage().data_ptr()
    for k, (out, z_local, rotating, owner) in enumerate(calls):
        s, i = divmod(k, 4)
        assert owner == (i - s) % 4
        assert z_local is resident[i]
        assert rotating is panels[owner]
        assert out.untyped_storage().data_ptr() == base
    assert got.untyped_storage().data_ptr() == base


# -- summa_gram / summa_matmul / ring_correlation ---------------------

@pytest.mark.parametrize("v,cross,normalize,step", [
    (64, False, True, "fused"), (61, False, True, "fused"),
    (61, True, True, "fused"), (64, True, False, "fused"),
    (61, False, False, "unfused"), (61, True, True, "unfused")])
def test_summa_gram_matches_jax(jax_ring, v, cross, normalize, step):
    """An even and an uneven (61 on 4 positions) split, the cross Gram
    and normalize=False, both ring steps, against the JAX ring on 4
    devices."""
    data = _data(v, 20, v)
    other = _data(v + 1, 20, v) if cross else None
    want = np.asarray(jax_ring.summa_gram(
        data, jmake_mesh(("voxel",), (4,)), data_b=other,
        normalize=normalize, ring_step=step))
    got = distla.summa_gram(data, _cpu_mesh(), data_b=other,
                            normalize=normalize, ring_step=step)
    assert got.dtype == torch.float32 and got.shape == (v, v)
    if normalize:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_summa_gram_nan_and_constant_columns(jax_ring):
    """A NaN column gives the JAX ring's NaN mask, 2V - 1 entries; a
    constant column gives exact zeros."""
    v = 32
    data = _data(3, 16, v)
    data[3, 5] = np.nan
    data[:, 9] = 2.0
    want = np.asarray(jax_ring.summa_gram(data,
                                          jmake_mesh(("voxel",), (4,))))
    got = distla.summa_gram(data, _cpu_mesh()).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() == 2 * v - 1
    keep = np.arange(v) != 5
    assert np.all(got[9, keep] == 0) and np.all(got[keep, 9] == 0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                               equal_nan=True)


def test_summa_gram_two_dimensional_mesh(jax_ring):
    """A 2-D ('subject', 'voxel') (2, 2) mesh flattens into one ring of
    4; the voxel axis alone is a ring of 2 with the same numbers."""
    data = _data(2, 12, 48)
    want = np.asarray(jax_ring.summa_gram(
        data, jmake_mesh(("subject", "voxel"), (2, 2))))
    mesh2d = _cpu_mesh(("subject", "voxel"), (2, 2))
    got = distla.summa_gram(data, mesh2d).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    sub = distla.summa_gram(data, mesh2d, axis_names=("voxel",)).numpy()
    np.testing.assert_allclose(sub, got, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="ring axes"):
        distla.summa_gram(data, mesh2d, axis_names=("nope",))


def test_ring_steps_agree_and_names_are_checked():
    """'unfused' equals 'fused'; 'pallas' names the CUDA kernel and
    raises on a CPU mesh; a typo raises."""
    data = _data(4, 10, 37)
    mesh = _cpu_mesh()
    fused = distla.summa_gram(data, mesh, ring_step="fused")
    unfused = distla.summa_gram(data, mesh, ring_step="unfused")
    auto = distla.summa_gram(data, mesh)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), atol=1e-6,
                               rtol=0)
    assert torch.equal(auto, fused)
    with pytest.raises(ValueError, match="K5"):
        distla.summa_gram(data, mesh, ring_step="pallas")
    with pytest.raises(ValueError, match="ring_step"):
        distla.summa_gram(data, mesh, ring_step="fuesd")
    with pytest.raises(ValueError, match="shape"):
        distla.summa_gram(data, mesh, data_b=data[:, :20])


@pytest.mark.parametrize("cross", [False, True])
def test_summa_matmul_matches_jax(jax_ring, cross):
    a = _data(5, 9, 30)
    b = _data(6, 9, 30) if cross else None
    want = np.asarray(jax_ring.summa_matmul(
        a, jmake_mesh(("voxel",), (4,)), b=b))
    got = distla.summa_matmul(a, _cpu_mesh(), b=b).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="differ"):
        distla.summa_matmul(a, _cpu_mesh(), b=a[:, :10])


@pytest.mark.parametrize("cross", [False, True])
def test_ring_correlation_matches_jax(jax_ring, cross):
    data = _data(7, 15, 32)
    other = _data(8, 15, 32) if cross else None
    want = np.asarray(jring.ring_correlation(
        data, jmake_mesh(("voxel",), (4,)), data_b=other))
    got = tring.ring_correlation(data, _cpu_mesh(), data_b=other).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        tring.ring_correlation(data[:, :30], _cpu_mesh())
    with pytest.raises(ValueError, match="same shape"):
        tring.ring_correlation(data, _cpu_mesh(), data_b=data[:, :16])


# -- the gram dispatcher ----------------------------------------------

def _spy_ring(monkeypatch):
    calls = []
    real = distla.summa_gram

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(distla, "summa_gram", spy)
    return calls


@pytest.mark.parametrize("normalize", [True, False])
def test_gram_dispatch_matches_jax(monkeypatch, normalize):
    """Under the budget the replicated product (no ring), over it the
    ring; both equal the JAX package's replicated gram."""
    data = _data(9, 16, 40)
    want = np.asarray(jdistla.gram(data, normalize=normalize))
    tol = dict(atol=ATOL, rtol=0) if normalize else \
        dict(rtol=1e-5, atol=1e-5 * np.abs(want).max())
    calls = _spy_ring(monkeypatch)
    small = distla.gram(data, mesh=_cpu_mesh(), normalize=normalize,
                        device="cpu")
    assert calls == []
    np.testing.assert_allclose(small.numpy(), want, **tol)
    big = distla.gram(data, mesh=_cpu_mesh(), budget_bytes=1024,
                      normalize=normalize, device="cpu")
    assert len(calls) == 1
    np.testing.assert_allclose(big.numpy(), want, **tol)


def test_gram_dispatch_errors():
    data = _data(10, 16, 32)
    other = _data(11, 16, 20)
    mesh = _cpu_mesh()
    with pytest.raises(ValueError, match="budget"):
        distla.gram(data, mesh=mesh, budget_bytes=1024,
                    force="replicated", device="cpu")
    with pytest.raises(ValueError, match="force"):
        distla.gram(data, force="both", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        distla.gram(data, force="summa", device="cpu")
    for kw in (dict(), dict(mesh=mesh, budget_bytes=1024),
               dict(mesh=mesh, force="summa"), dict(force="replicated")):
        with pytest.raises(ValueError, match="shape"):
            distla.gram(data, data_b=other, device="cpu", **kw)


def test_gram_over_budget_without_mesh_warns(caplog):
    data = _data(12, 8, 16)
    with caplog.at_level("WARNING"):
        got = distla.gram(data, budget_bytes=16, device="cpu")
    assert "exceeds" in caplog.text
    np.testing.assert_allclose(got.numpy(), np.asarray(jdistla.gram(data)),
                               atol=ATOL, rtol=0)


def test_budget_env(monkeypatch, caplog):
    monkeypatch.setenv(distla.BUDGET_ENV, "2e6")
    assert distla.replicated_budget_bytes() == 2_000_000
    assert distla.BUDGET_ENV == jdistla.BUDGET_ENV
    monkeypatch.setenv(distla.BUDGET_ENV, "lots")
    with caplog.at_level("WARNING"):
        assert distla.replicated_budget_bytes() == \
            distla.DEFAULT_REPLICATED_BUDGET == 8 << 30
    assert "unparseable" in caplog.text


def test_zscore_cols_matches_jax():
    data = _data(13, 11, 9)
    data[:, 2] = 0.0
    data[:, 4] = -3.0
    data[5, 7] = np.nan
    want = np.asarray(jdistla._zscore_cols(jnp.asarray(data)))
    got = distla._zscore_cols(torch.from_numpy(data)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                               equal_nan=True)
    assert np.all(got[:, [2, 4]] == 0) and np.all(np.isnan(got[:, 7]))


def test_gram_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distla.gram(_data(14, 6, 8))


# -- mesh helpers -----------------------------------------------------

def test_make_mesh_fills_and_repeats_devices():
    mesh = tmesh.make_mesh(("subject", "voxel"), (2, -1),
                           devices=["cpu"] * 8)
    assert mesh.shape == {"subject": 2, "voxel": 4}
    assert mesh.axis_names == ("subject", "voxel")
    assert mesh.devices.shape == (2, 4) and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    jmesh = jmake_mesh(("subject", "voxel"), (2, -1))
    assert dict(jmesh.shape) == mesh.shape
    sv = tmesh.subject_voxel_mesh(-1, 2, devices=["cpu"] * 6)
    assert sv.shape == {"subject": 3, "voxel": 2}
    with pytest.raises(ValueError, match="infer"):
        tmesh.make_mesh(("a", "b"), (3, -1), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs"):
        tmesh.make_mesh(("a",), (9,), devices=["cpu"] * 8)
    assert tmesh.max_divisible_shards(6, devices=["cpu"] * 8) == 6
    assert tmesh.max_divisible_shards(7, devices=["cpu"] * 4) == 1


def test_make_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        tmesh.make_mesh(("voxel",), (-1,))
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh(("voxel",), (2,), devices=["cuda"] * 2)
    with pytest.raises(RuntimeError):
        tmesh.max_divisible_shards(8)


def test_shard_along_and_fetch_round_trip():
    mesh = _cpu_mesh(("subject", "voxel"), (2, 2))
    arr = np.arange(24, dtype=np.float32).reshape(3, 8)
    placed = tmesh.shard_along(arr, mesh, "voxel", 1)
    assert len(placed.chunks) == 2
    assert [tuple(c.shape) for c in placed.chunks] == [(3, 4), (3, 4)]
    assert all(c.is_contiguous() for c in placed.chunks)
    np.testing.assert_array_equal(tmesh.fetch_replicated(placed), arr)
    flat = tmesh.shard_along(arr, mesh, ("subject", "voxel"), 1)
    assert len(flat.chunks) == 4
    np.testing.assert_array_equal(flat.chunks[1].numpy(), arr[:, 2:4])
    np.testing.assert_array_equal(
        tmesh.fetch_replicated(tmesh.replicated(arr, mesh)), arr)
    np.testing.assert_array_equal(
        tmesh.fetch_replicated(torch.from_numpy(arr)), arr)
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_along(arr[:, :7], mesh, "voxel", 1)
    with pytest.raises(ValueError, match="not in mesh"):
        tmesh.axis_devices(mesh, ("row",))
