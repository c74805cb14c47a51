"""K2, the ingest epoch z-score: its routes and tile widths as pure
Python, and its plain version against the JAX package on the CPU.

The kernels themselves (``csrc/epoch_norm_tile.cu``, the tile route,
and ``csrc/epoch_norm.cu``, the simple one) run only on the card:
``tests/test_torch_gpu.py`` holds them to each other bit for bit and
to the plain version there.  Inputs are made with numpy from a seed.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.fcma import preprocessing as jprep
from brainiak_tpu.obs import sink as jsink
from brainiak_tpu.ops.kernels import epoch_norm as jnorm
from brainiak_tpu_torch.fcma import preprocessing as tprep
from brainiak_tpu_torch.obs import sink as tsink
from brainiak_tpu_torch.obs import spans as tspans
from brainiak_tpu_torch.ops.kernels import epoch_norm as tnorm
from torch_obs_state import clean_obs, span_tree  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("dtype,t_max", [(F32, 1814), (F64, 906)])
def test_zscore_route_choices(dtype, t_max):
    """The tile route wherever a 32-voxel tile and its statistics fit a
    block's 232,448 bytes of shared memory, the simple kernel beyond;
    either forced where it applies."""
    assert tnorm.tile_max_t(dtype) == t_max
    itemsize = torch.finfo(dtype).bits // 8
    assert (t_max + 2) * 32 * itemsize <= tnorm.SMEM_MAX
    assert (t_max + 3) * 32 * itemsize > tnorm.SMEM_MAX
    for t in (1, 12, 150, t_max):
        assert tnorm.zscore_route(t, dtype) == "tile"
        assert tnorm.zscore_route(t, dtype, "tile") == "tile"
        assert tnorm.zscore_route(t, dtype, "simple") == "simple"
    assert tnorm.zscore_route(t_max + 1, dtype) == "simple"
    assert tnorm.zscore_route(t_max + 1, dtype, "simple") == "simple"


def test_zscore_route_refusals():
    with pytest.raises(ValueError, match="at most 1814 rows"):
        tnorm.zscore_route(1815, F32, "tile")
    with pytest.raises(ValueError, match="at most 906 rows"):
        tnorm.zscore_route(907, F64, "tile")
    with pytest.raises(ValueError, match="'tile' or 'simple'"):
        tnorm.zscore_route(150, F32, "ffma")
    with pytest.raises(TypeError, match="float32 or float64"):
        tnorm.zscore_route(150, torch.float16)
    with pytest.raises(TypeError):
        tnorm.tile_width(150, torch.int32)


@pytest.mark.parametrize("dtype,t,w", [
    (F32, 1, 1024), (F32, 10, 1024), (F32, 12, 512), (F32, 40, 256),
    (F32, 150, 64), (F32, 600, 32), (F32, 1814, 32),
    (F64, 1, 1024), (F64, 12, 256), (F64, 150, 32), (F64, 906, 32)])
def test_tile_width(dtype, t, w):
    """The widest power of two from 32 to 1024 whose tile and
    statistics stay within 48 KB, else 32."""
    assert tnorm.tile_width(t, dtype) == w
    itemsize = torch.finfo(dtype).bits // 8
    assert (t + 2) * w * itemsize <= max(tnorm.TILE_BYTES,
                                         (t + 2) * 32 * itemsize)
    assert w == 1024 or (t + 2) * 2 * w * itemsize > tnorm.TILE_BYTES


def test_tile_width_shrinks_with_t():
    for dtype in (F32, F64):
        widths = [tnorm.tile_width(t, dtype)
                  for t in range(1, tnorm.tile_max_t(dtype) + 1)]
        assert widths == sorted(widths, reverse=True)
        assert set(widths) <= {32, 64, 128, 256, 512, 1024}


def test_launch_counts_by_route():
    tnorm.reset_launches()
    assert [tnorm.launches(r) for r in (None, "tile", "simple")] == [0] * 3
    with pytest.raises(ValueError, match="no K2 route"):
        tnorm.launches("ffma")
    # a CPU tensor runs the plain version and launches nothing
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 5, 7))
    assert torch.equal(tnorm.batch_zscore(x), tnorm.batch_zscore_plain(x))
    assert [tnorm.launches(r) for r in (None, "tile", "simple")] == [0] * 3


def _batch(seed, n, t, v):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, t, v) * 3 + 1).astype(np.float32)
    x[0, :, 5] = 2.5           # exactly constant column -> 0
    x[1, t // 2, 7] = np.nan   # non-finite -> 0
    x[2, 0, 9] = np.inf
    x[n - 1, :, v - 1] = 1e-3 * np.arange(t)  # tiny but varying
    return x


@pytest.mark.parametrize("shape", [(4, 12, 300), (3, 12, 1031),
                                   (3, 150, 1031), (3, 1, 40)])
def test_batch_zscore_plain_matches_jax_block(shape):
    """T=12 (the face-scene study's epochs), ragged V and T=1 against
    the Pallas kernel's body ``_zscore_block`` (no Pallas tiling takes
    T % 8 != 0 or V % 128 != 0): within 1e-5, the same zeros."""
    x = _batch(7, *shape)
    want = np.asarray(jnorm._zscore_block(jnp.asarray(x)))
    got = tnorm.batch_zscore_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for e, c in ((0, 5), (1, 7), (2, 9)):
        assert np.all(got[e, :, c] == 0) and np.all(want[e, :, c] == 0)


@pytest.mark.parametrize("t,tile_v", [(24, 128), (16, 256)])
def test_batch_zscore_plain_matches_jax_pallas_tiles(t, tile_v):
    """Against the Pallas kernel in interpret mode where it tiles (T a
    multiple of 8, V of 128): within 1e-5."""
    x = _batch(8, 3, t, 512)
    want = np.asarray(jnorm._pallas_batch_zscore(jnp.asarray(x), tile_v,
                                                 True))
    got = tnorm.batch_zscore_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _study_images(seed, n_subj=3, shape=(5, 5, 3), n_trs=60):
    """Images and conditions of epochs of 12 TRs (2 conditions x 2
    epochs a subject), and masks of 11 and 64 voxels."""
    rng = np.random.RandomState(seed)
    n_vox = int(np.prod(shape))
    images, conditions = [], []
    for _ in range(n_subj):
        images.append(rng.randn(*shape, n_trs).astype(np.float32))
        cond = np.zeros((2, 2, n_trs), dtype=np.int64)
        cond[0, 0, 0:12] = cond[0, 1, 30:42] = 1
        cond[1, 0, 15:27] = cond[1, 1, 45:57] = 1
        conditions.append(cond)
    mask1 = np.zeros(shape, dtype=bool)
    mask1.flat[rng.permutation(n_vox)[:11]] = True
    return images, conditions, mask1, ~mask1


@pytest.mark.parametrize("two_masks", [False, True])
def test_prepare_fcma_data_epochs_of_12_match_jax(two_masks):
    """``prepare_fcma_data(device="cpu")`` at epochs of 12 TRs and
    masks of ragged widths against the JAX package: within 1e-5."""
    images, conds, mask1, mask2 = _study_images(9)
    m2 = mask2 if two_masks else None
    want = jprep.prepare_fcma_data(images, conds, mask1, m2)
    got = tprep.prepare_fcma_data(images, conds, mask1, m2, device="cpu")
    assert got[2] == want[2]
    for g_list, w_list in zip(got[:2], want[:2]):
        if w_list is None:
            assert g_list is None
            continue
        assert len(g_list) == len(w_list) == 12
        for g, w in zip(g_list, w_list):
            assert g.dtype == np.float32 and g.shape == w.shape
            assert g.shape[0] == 12
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_ptxas_summary_names_the_tile_kernels():
    """chip_smoke.py names each instantiation of the tile kernel (a
    dtype and a bool) as it names the others (integers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    spill = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    out = "\n".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        f"    {spill}\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers"
        for name, regs in (
            ("_ZN12_GLOBAL__N_124epoch_zscore_tile_kernelIfLb1EEEvPKT_"
             "PS1_ixiiS1_", 30),
            ("_ZN12_GLOBAL__N_124epoch_zscore_tile_kernelIdLb0EEEvPKT_"
             "PS1_ixiiS1_", 40),
            ("_ZN12_GLOBAL__N_119epoch_zscore_kernelIfEEvPKT_PS1_xixS1_",
             20),
            ("_Z19fcma_gram_tc_kernelILi16ELi32EEvPKfS1_Pf", 128)))
    assert smoke.ptxas_summary(out) == [
        f"epoch_zscore_tile_kernel<float,1>: 30 registers; {spill}",
        f"epoch_zscore_tile_kernel<double,0>: 40 registers; {spill}",
        f"epoch_zscore_kernel<float>: 20 registers; {spill}",
        f"fcma_gram_tc_kernel<16,32>: 128 registers; {spill}"]


def test_normalize_epochs_spans_match_jax(clean_obs, monkeypatch):  # noqa: F811
    """One ``fcma.epoch_norm`` span a shape group, with the JAX
    package's attributes (its device path forced, as on the TPU),
    the groups in the same order; none while obs is disabled, and no
    synchronize either way."""
    monkeypatch.setenv(jnorm.EPOCH_NORM_ENV, "device")
    rng = np.random.RandomState(3)
    mats = [rng.randn(12, 40).astype(np.float32) for _ in range(3)] + \
        [rng.randn(8, 40).astype(np.float32)] + \
        [rng.randn(12, 40).astype(np.float32)]
    syncs = []
    monkeypatch.setattr(tspans, "_block_until_ready", syncs.append)
    tnorm.normalize_epochs(mats, device="cpu")
    trees = {}
    for name, snk, fn in (
            ("jax", jsink, jnorm.normalize_epochs),
            ("torch", tsink, lambda m: tnorm.normalize_epochs(
                m, device="cpu"))):
        mem = snk.add_sink(snk.MemorySink())
        out = fn(mats)
        snk.remove_sink(mem)
        assert len(out) == 5
        trees[name] = span_tree(mem.records)
    assert trees["torch"] == trees["jax"] == [
        ("fcma.epoch_norm", "", {"n_epochs": 4, "n_trs": 12,
                                 "n_voxels": 40}),
        ("fcma.epoch_norm", "", {"n_epochs": 1, "n_trs": 8,
                                 "n_voxels": 40})]
    assert syncs == []
