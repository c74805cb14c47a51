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
from brainiak_tpu_torch.ops.fisherz import (fisher_z,
                                            within_subject_normalization)
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


def _zscore_routes(x):
    """K2's tile route and its forced simple route on x, each counted
    once on its own route."""
    en.reset_launches()
    tile = en.batch_zscore(x)
    simple = en._kernel_zscore(x, "simple")
    assert en.launches() == 2
    assert en.launches("tile") == 1 and en.launches("simple") == 1
    return tile, simple


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(3, 17, 300), (5, 150, 1031),
                                   (4, 1, 300), (6, 12, 4100), "w+1"])
def test_epoch_zscore_tile_route(cuda, dtype, shape):
    """The tile route gives the simple kernel's bits (the same
    expressions, rows in the same order) and is within 1e-5 of plain;
    constant, NaN and inf columns come out 0.  "w+1": a V one past the
    tile width, so the last tile holds one voxel."""
    if shape == "w+1":
        shape = (3, 150, en.tile_width(150, dtype) + 1)
    n, t, v = shape
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(*shape) * 3 + 1).to(cuda, dtype)
    x[0, :, 0] = 2.0
    x[n - 1, :, v - 1] = -0.5
    x[1 % n, t // 2, v // 2] = float("nan")
    x[2 % n, t - 1, 1] = float("inf")
    assert en.zscore_route(t, dtype) == "tile"
    tile, simple = _zscore_routes(x)
    assert tile.dtype == dtype and torch.equal(tile, simple)
    torch.testing.assert_close(tile, en.batch_zscore_plain(x), atol=1e-5,
                               rtol=0)
    for e, c in ((0, 0), (n - 1, v - 1), (1 % n, v // 2), (2 % n, 1)):
        assert torch.all(tile[e, :, c] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_epoch_zscore_tile_misaligned(cuda, dtype):
    """A view one element into its storage (not 16-byte aligned) takes
    the kernel's element copies and gives the same bits."""
    n, t, v = 3, 40, 1000
    flat = torch.from_numpy(np.random.RandomState(2).randn(n * t * v + 1)
                            ).to(cuda, dtype)
    x = flat[1:].view(n, t, v)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    tile, simple = _zscore_routes(x)
    assert torch.equal(tile, simple)
    torch.testing.assert_close(tile, en.batch_zscore_plain(x), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("t,w", [(1, 1024), (12, 512), (40, 256),
                                 (80, 128), (150, 64), (600, 32)])
def test_epoch_zscore_tile_widths(cuda, t, w):
    """Every tile width the kernel takes, reached through the T that
    tile_width maps to it, gives the same bits."""
    assert en.tile_width(t, torch.float32) == w
    x = torch.from_numpy(np.random.RandomState(w).randn(3, t, 3000)
                         .astype(np.float32)).to(cuda)
    tile, simple = _zscore_routes(x)
    assert torch.equal(tile, simple)


def test_epoch_zscore_beyond_the_tile(cuda):
    """Beyond tile_max_t the route is the simple kernel, and a forced
    tile route raises."""
    t = en.tile_max_t(torch.float64) + 1
    x = torch.from_numpy(np.random.RandomState(3).randn(2, t, 40)).to(cuda)
    assert en.zscore_route(t, torch.float64) == "simple"
    en.reset_launches()
    got = en.batch_zscore(x)
    assert en.launches("simple") == 1 and en.launches("tile") == 0
    torch.testing.assert_close(got, en.batch_zscore_plain(x), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="route 'tile'"):
        en._kernel_zscore(x, "tile")


@pytest.mark.parametrize("e,t,b,v,eps", [
    (8, 40, 13, 37, 4), (16, 150, 40, 1000, 4), (32, 150, 130, 3000, 4),
    (12, 20, 9, 70, 6), (16, 9, 21, 77, 4), (32, 12, 33, 130, 8),
    (24, 20, 17, 45, 12), (40, 12, 10, 100, 10), (48, 9, 17, 65, 4),
    (80, 12, 10, 100, 40), (96, 9, 17, 65, 48), (64, 20, 33, 300, 64)])
def test_fcma_kernels(cuda, e, t, b, v, eps):
    """Two-mask inputs (no |r| near 1); ragged B, V and T (9, 12, 20:
    not whole 8-row k-steps); one epoch tile (E <= 32: K1's one-tile
    tensor-core kernel) and several (K1's multi-tile one); subjects of
    more than 32 epochs, which span several tiles (40 and 48 epochs
    per subject, and one subject of 64)."""
    d = _normalized(e + b, e, t, v + b, cuda)
    blk, data = d[:, :, v:].contiguous(), d[:, :, :v].contiguous()
    route = fk.gram_route(e, eps)[0]
    fk.reset_launches()
    gram = fk.fcma_gram(blk, data, eps)
    corr = fk.fcma_corr_normalize(blk, data, eps)
    assert fk.launches() == {"fcma_gram": 1,
                             "fcma_gram_tc": int(route == "tc"),
                             "fcma_gram_tcm": int(route == "tcm"),
                             "fcma_gram_tcs": 0, "fcma_gram_tcs_tc": 0,
                             "fcma_gram_tcs_tcl": 0,
                             "fcma_gram_tcs_gram": 0,
                             "fcma_corr_normalize": 1,
                             "fcma_corr_normalize_tc": int(eps <= 4),
                             "fcma_corr_normalize_tcl": int(eps > 4),
                             "fcma_sample_gram": 0,
                             "fcma_sample_gram_tc": 0,
                             "fcma_sample_gram_tcm": 0,
                             "fcma_sample_gram_tcs": 0,
                             "fcma_sample_gram_tcs_tcl": 0,
                             "fcma_sample_gram_tcs_r": 0,
                             "fcma_sample_gram_tcs_gram": 0,
                             "fcma_sample_gram_tcs_sum": 0}
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
    x = torch.zeros(48, 6, 8, device=cuda)
    with pytest.raises(ValueError, match="one epoch tile"):
        fk._kernel_gram(x, x, 4, route="tc")
    for n_e in (32, 108):
        x = torch.zeros(n_e, 6, 8, device=cuda)
        with pytest.raises(ValueError, match="route 'tcm'"):
            fk._kernel_gram(x, x, 4, route="tcm")


def test_fcma_gram_both_tilings_at_sixteen_epochs(cuda):
    """At E <= 16 the 16-epoch tiling runs; the 32-epoch one, forced,
    gives the same Gram, through either kernel."""
    d = _normalized(3, 16, 150, 600, cuda)
    blk, data = d[:, :, 500:].contiguous(), d[:, :, :500].contiguous()
    want = fk.fcma_gram_plain(blk, data, 4)
    scale = want[:, :1, :1].abs()
    for ept in (16, 32):
        for route in ("tc", "ffma"):
            got = fk._kernel_gram(blk, data, 4, ept=ept, route=route)
            assert torch.all((got - want).abs() <= 1e-4 * scale), \
                (ept, route)


@pytest.mark.parametrize("e,t,b,v,eps", [
    (32, 150, 70, 2000, 4), (16, 20, 40, 333, 4), (12, 9, 9, 70, 6),
    (32, 150, 1024, 4096, 4)])
def test_fcma_gram_routes_agree(cuda, e, t, b, v, eps):
    """K1's tensor-core kernel and fcma_corr.cu's FMA kernel on the
    same one-tile inputs: each launched as asked, both within 1e-4 of
    each voxel's K[0, 0] of the plain version."""
    d = _normalized(e * t + b, e, t, v + b, cuda)
    blk, data = d[:, :, v:].contiguous(), d[:, :, :v].contiguous()
    want = fk.fcma_gram_plain(blk, data, eps)
    scale = want[:, :1, :1].abs()
    for route in ("tc", "ffma"):
        fk.reset_launches()
        got = fk._kernel_gram(blk, data, eps, route=route)
        assert fk.launches()["fcma_gram"] == 1
        assert fk.launches()["fcma_gram_tc"] == int(route == "tc")
        assert torch.all((got - want).abs() <= 1e-4 * scale), route


def test_fcma_gram_tc_misaligned_rows(cuda):
    """Operands whose rows do not start 16-byte aligned (a view one
    float into its storage) and whose widths are not multiples of 4
    reach the tensor-core kernel zero-padded, with the plain version's
    Gram.  Two-region inputs (no |r| near 1)."""
    d = _normalized(11, 16, 30, 203 + 21, cuda)
    blk = d[:, :, 203:].contiguous()
    store = torch.empty(16 * 30 * 203 + 1, device=cuda)
    store[1:] = d[:, :, :203].reshape(-1)
    data = store[1:].view(16, 30, 203)
    assert data.is_contiguous() and data.data_ptr() % 16
    want = fk.fcma_gram_plain(blk, data, 4)
    fk.reset_launches()
    got = fk.fcma_gram(blk, data, 4)
    assert fk.launches()["fcma_gram_tc"] == 1 and got.shape == (21, 16, 16)
    assert torch.all((got - want).abs() <= 1e-4 * want[:, :1, :1].abs())


def _gram_routes(blk, data, eps, routes):
    """{route: K1 forced onto it}, each launched once as asked."""
    got = {}
    for route in routes:
        fk.reset_launches()
        got[route] = fk._kernel_gram(blk, data, eps, route=route)
        counts = fk.launches()
        assert counts["fcma_gram"] == 1
        for name in ("tc", "tcm"):
            assert counts[f"fcma_gram_{name}"] == int(route == name)
        assert torch.isfinite(got[route]).all(), route
    return got


@pytest.mark.parametrize("e,t,b,v,eps", [
    (48, 37, 13, 333, 4), (80, 150, 70, 1001, 40), (96, 20, 21, 203, 4),
    (104, 9, 9, 77, 52), (36, 150, 130, 2000, 12), (48, 20, 45, 30, 4)])
def test_fcma_gram_tcm_routes_agree(cuda, e, t, b, v, eps):
    """K1's multi-tile tensor-core kernel (every correlation formed
    once, all epochs in shared memory) and fcma_corr.cu's FMA kernel
    forced on the same inputs: at 48 epochs of 4, 80 of 40 (subjects
    longer than an epoch tile), 96, and 104 = TCM_MAX_EPOCHS; ragged B,
    V and T; V=30, one voxel tile, so one V split written straight into
    the output.  Both within 1e-4 of each voxel's K[0, 0] of the plain
    version.  Two-region inputs (no |r| near 1)."""
    assert fk.gram_route(e, eps)[0] == "tcm"
    d = _normalized(e * t + b, e, t, v + b, cuda)
    blk, data = d[:, :, v:].contiguous(), d[:, :, :v].contiguous()
    want = fk.fcma_gram_plain(blk, data, eps)
    scale = want[:, :1, :1].abs()
    for route, got in _gram_routes(blk, data, eps,
                                   ("tcm", "ffma")).items():
        assert torch.all((got - want).abs() <= 1e-4 * scale), route


def test_fcma_gram_tcm_misaligned_rows(cuda):
    """Operands whose rows do not start 16-byte aligned (a view one
    float into its storage) and whose widths are not multiples of 4
    reach the multi-tile tensor-core kernel zero-padded, with the plain
    version's Gram.  Two-region inputs (no |r| near 1)."""
    d = _normalized(13, 48, 30, 203 + 21, cuda)
    blk = d[:, :, 203:].contiguous()
    store = torch.empty(48 * 30 * 203 + 1, device=cuda)
    store[1:] = d[:, :, :203].reshape(-1)
    data = store[1:].view(48, 30, 203)
    assert data.is_contiguous() and data.data_ptr() % 16
    want = fk.fcma_gram_plain(blk, data, 4)
    fk.reset_launches()
    got = fk.fcma_gram(blk, data, 4)
    assert fk.launches()["fcma_gram_tcm"] == 1
    assert got.shape == (21, 48, 48)
    assert torch.all((got - want).abs() <= 1e-4 * want[:, :1, :1].abs())


@pytest.mark.parametrize("e,eps", [(48, 4), (80, 40)])
def test_fcma_gram_tcm_self_pairs(cuda, e, eps):
    """One mask (VoxelSelector without raw_data2): every block voxel
    meets itself at r = 1 up to rounding, where the clamped Fisher-z
    turns the last ulp of r into 4.95 against 8.66 and the z-score
    carries it into the whole subject.  The multi-tile kernel forms
    those r again in fp32 FMA, t ascending, as the FMA kernel forms
    them, so the two Grams agree within 1e-4 of each voxel's K[0, 0]."""
    d = _normalized(5 * e + eps, e, 30, 203, cuda)
    blk = d[:, :, 40:77].contiguous()
    got = _gram_routes(blk, d, eps, ("tcm", "ffma"))
    scale = got["ffma"][:, :1, :1].abs()
    assert torch.all((got["tcm"] - got["ffma"]).abs() <= 1e-4 * scale)


def test_fcma_gram_tcm_takes_no_statistics_scratch(cuda, monkeypatch):
    """Subjects of 40 epochs span two epoch tiles: the FMA route
    allocates its statistics pass's scratch, the multi-tile route
    none, and it allocates no more than its Gram and one [B, E, E]
    partial a V split."""
    d = _normalized(9, 80, 20, 500, cuda)
    blk, data = d[:, :, 400:].contiguous(), d[:, :, :400].contiguous()
    calls = []
    stats = fk._stats

    def counted(*args):
        calls.append(stats(*args))
        return calls[-1]

    monkeypatch.setattr(fk, "_stats", counted)
    fk._kernel_gram(blk, data, 40, route="ffma")
    assert len(calls) == 1 and calls[0] is not None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fk.reset_launches()
    fk.fcma_gram(blk, data, 40)
    torch.cuda.synchronize()
    assert len(calls) == 1 and fk.launches()["fcma_gram_tcm"] == 1
    n_split = fk._tcm_split(cuda, 100, 400)
    gram_bytes = 4 * 100 * 80 * 80
    assert torch.cuda.max_memory_allocated() - base <= \
        (1 + n_split) * gram_bytes + 2 ** 20


def _slab_launches(route, eps, n_slabs=1):
    """K1's launch counts of one call forced onto ``route``: for the
    slab route, one correlation launch (K3's body "tc" up to 4 epochs a
    subject, else "tcl"'s raw mode) and one Gram launch a slab."""
    body = "tc" if eps <= 4 else "tcl"
    slab = route == "tcs"
    return {"fcma_gram": 1, "fcma_gram_tc": 0, "fcma_gram_tcm": 0,
            "fcma_gram_tcs": int(slab),
            "fcma_gram_tcs_tc": n_slabs * int(slab and body == "tc"),
            "fcma_gram_tcs_tcl": n_slabs * int(slab and body == "tcl"),
            "fcma_gram_tcs_gram": n_slabs * int(slab)}


def _k1_launches():
    return {k: n for k, n in fk.launches().items()
            if k.startswith("fcma_gram")}


@pytest.mark.parametrize("e,t,b,v,eps", [
    (108, 37, 13, 333, 4), (120, 9, 21, 77, 12), (216, 12, 9, 203, 108),
    (216, 12, 37, 1001, 12), (112, 20, 45, 30, 56), (300, 12, 10, 2100, 12),
    (216, 12, 20, 4099, 6), (128, 150, 64, 4096, 4), (600, 12, 6, 101, 4),
    (800, 9, 5, 64, 8)])
def test_fcma_gram_tcs_routes_agree(cuda, e, t, b, v, eps):
    """K1's slab route beyond 104 epochs and fcma_corr.cu's FMA kernel
    forced on the same inputs: both correlation bodies (4 epochs a
    subject through K3's "tc", z-scored; longer through "tcl"'s raw
    mode, z-scored as the Gram loads it: 6, 8, 12, 56, and 108, a
    subject longer than 104 epochs); ragged B, V and T (9 and 12 below
    the 16-row stage); one V split and several (V=4096, 4099); more than
    128 output blocks (300, 600 and 800 epochs: several groups, two
    stages at 800).  Each launched as asked; both within 1e-4 of each
    voxel's K[0, 0] of the plain version; the route's Gram symmetric
    bit for bit."""
    assert fk.gram_route(e, eps)[0] == "tcs"
    d = _normalized(e * t + b, e, t, v + b, cuda)
    blk, data = d[:, :, v:].contiguous(), d[:, :, :v].contiguous()
    want = fk.fcma_gram_plain(blk, data, eps)
    scale = want[:, :1, :1].abs()
    for route in ("tcs", "ffma"):
        fk.reset_launches()
        got = fk._kernel_gram(blk, data, eps, route=route)
        assert _k1_launches() == _slab_launches(route, eps), route
        assert torch.all((got - want).abs() <= 1e-4 * scale), route
        if route == "tcs":
            assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.parametrize("e,eps", [(120, 12), (216, 108), (112, 56),
                                   (216, 6)])
def test_fcma_gram_tcs_self_pairs(cuda, e, eps):
    """One mask: every block voxel meets itself at r = 1 up to
    rounding.  The raw mode of the long-subject body forms those r
    again in fp32 FMA, t ascending, as the FMA kernel forms them, so
    the two Grams agree within 1e-4 of each voxel's K[0, 0].  (Subjects
    of at most 4 epochs take K3's short-subject body, which has no
    near-one rule, as K1's one-tile route has none.)"""
    d = _normalized(5 * e + eps, e, 12, 203, cuda)
    blk = d[:, :, 40:77].contiguous()
    got = {}
    for route in ("tcs", "ffma"):
        fk.reset_launches()
        got[route] = fk._kernel_gram(blk, d, eps, route=route)
        assert _k1_launches() == _slab_launches(route, eps)
        assert torch.isfinite(got[route]).all(), route
    scale = got["ffma"][:, :1, :1].abs()
    assert torch.all((got["tcs"] - got["ffma"]).abs() <= 1e-4 * scale)


@pytest.mark.parametrize("eps", [4, 12])
def test_fcma_gram_tcs_misaligned_rows(cuda, eps):
    """Operands whose rows do not start 16-byte aligned (a view one
    float into its storage) and whose widths are not multiples of 4
    reach the slab route zero-padded, with the plain version's Gram.
    Two-region inputs (no |r| near 1)."""
    e, t = 120, 12
    d = _normalized(17 + eps, e, t, 203 + 21, cuda)
    blk = d[:, :, 203:].contiguous()
    store = torch.empty(e * t * 203 + 1, device=cuda)
    store[1:] = d[:, :, :203].reshape(-1)
    data = store[1:].view(e, t, 203)
    assert data.is_contiguous() and data.data_ptr() % 16
    want = fk.fcma_gram_plain(blk, data, eps)
    fk.reset_launches()
    got = fk.fcma_gram(blk, data, eps)
    assert _k1_launches() == _slab_launches("tcs", eps)
    assert got.shape == (21, e, e)
    assert torch.all((got - want).abs() <= 1e-4 * want[:, :1, :1].abs())


@pytest.mark.parametrize("e,t,b,v,eps", [(216, 12, 37, 1001, 12),
                                         (120, 20, 300, 4099, 4)])
def test_fcma_gram_tcs_slabs_are_bit_for_bit(cuda, e, t, b, v, eps):
    """A small forced slab budget (slabs of 4 or 8 block voxels, the last
    one shorter) gives the default's Gram bit for bit: a block voxel's
    Gram does not depend on the slab."""
    d = _normalized(e + v, e, t, v + b, cuda)
    blk, data = d[:, :, v:].contiguous(), d[:, :, :v].contiguous()
    whole = fk._kernel_gram(blk, data, eps)
    for per in (4, 8):
        budget = 4 * e * v * per + 3
        bc, n_slabs = fk.tcs_slabs(b, e, v, budget)
        assert bc == per and n_slabs == -(-b // per) > 1
        fk.reset_launches()
        got = fk._kernel_gram(blk, data, eps, budget=budget)
        assert _k1_launches() == _slab_launches("tcs", eps, n_slabs)
        assert torch.equal(got, whole), per


def _tcl_mode(name, blk, data):
    """[B, E, V] of fcma_corr_tcl.cu's raw mode (``"fisher"``) or r mode
    (``"r"``) on blk [E, T, B] and data [E, T, V]."""
    e, t, b = blk.shape
    v = data.shape[2]
    out = torch.empty(b, e, v, device=blk.device)
    x, y = fk._tma_operand(blk), fk._tma_operand(data)
    err = fk._fn("fcma_corr_tcl", f"fcma_corr_{name}_tcl_f32")(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), e, t, b, v,
        x.stride(1), x.stride(0), y.stride(1), y.stride(0),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out


@pytest.mark.parametrize("e,eps", [(15, 5), (36, 12), (80, 40)])
def test_fcma_corr_normalize_tcl_is_unchanged_by_its_raw_mode(cuda, e,
                                                               eps):
    """K3's long-subject kernel gained a raw mode (the slab routes of K1
    and K4) and an r mode (K4's slab route on raw features): its own
    output and the raw mode's, run before and after the other modes on
    the same inputs, are the same bit for bit, and on inputs whose
    correlations are exact its output is still the FMA kernel's z-score
    bit for bit; the raw mode stores the clamped Fisher-z of those r
    (near torch's, whose log may round otherwise) and leaves it not
    z-scored; the r mode stores those exact r themselves."""
    t, b, v = 16, 45, 203
    blk, data = _dyadic(e, e, t, b, cuda), _dyadic(e + 1, e, t, v, cuda)
    before = fk._kernel_corr_normalize(blk, data, eps, route="tcl")
    raw = _tcl_mode("fisher", blk, data)
    r_mode = _tcl_mode("r", blk, data)
    after = fk._kernel_corr_normalize(blk, data, eps, route="tcl")
    want = fk._kernel_corr_normalize(blk, data, eps, route="ffma")
    assert torch.equal(before, after) and torch.equal(after, want)
    assert torch.equal(_tcl_mode("fisher", blk, data), raw)
    r = torch.einsum('etb,etv->bev', blk.double(), data.double())
    assert torch.equal(r_mode.double(), r)
    assert torch.allclose(raw.double(), fisher_z(r.float()).double(),
                          rtol=0, atol=1e-6)
    assert not torch.allclose(raw, after, atol=1e-2)


def test_fcma_gram_tcs_refuses(cuda):
    """The slab route refuses designs of at most 104 or more than 800
    epochs, and the new C entry points refuse what they do not take:
    more than 800 epochs, a subject length that does not divide E, a V
    split without partials, a misaligned operand of the raw mode."""
    x = torch.zeros(104, 6, 8, device=cuda)
    with pytest.raises(ValueError, match="route 'tcs'"):
        fk._kernel_gram(x, x, 52, route="tcs")
    x = torch.zeros(804, 6, 8, device=cuda)
    with pytest.raises(ValueError, match="route 'tcs'"):
        fk._kernel_gram(x, x, 4, route="tcs")
    gram = fk._fn("fcma_gram_tcs", "fcma_gram_tcs_f32")
    z = torch.zeros(2, 120, 64, device=cuda)
    out = torch.empty(2, 120, 120, device=cuda)
    part = torch.empty(2, 2, 120, 120, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (z.data_ptr(), part.data_ptr(), out.data_ptr())
    assert gram(*ptrs, 120, 2, 64, 12, 2, stream) == 0
    assert gram(*ptrs, 120, 2, 64, 0, 1, stream) == 0
    for args in ((801, 2, 64, 0, 1), (0, 2, 64, 0, 1), (120, 2, 64, 7, 1),
                 (120, 2, 64, -1, 1), (120, 2, 64, 12, 0),
                 (120, -1, 64, 12, 1)):
        assert gram(*ptrs, *args, stream) != 0, args
    assert gram(z.data_ptr(), None, out.data_ptr(), 120, 2, 64, 12, 2,
                stream) != 0
    corr = fk._fn("fcma_corr_tcl", "fcma_corr_fisher_tcl_f32")
    d = torch.zeros(120, 6, 9, device=cuda)
    assert corr(d.data_ptr(), d.data_ptr(), z.data_ptr(), 120, 6, 2, 9,
                9, 54, 9, 54, stream) != 0
    assert corr(d.data_ptr() + 4, d.data_ptr(), z.data_ptr(), 120, 6, 2, 8,
                12, 72, 12, 72, stream) != 0
    torch.cuda.synchronize()


def test_voxel_selector_takes_the_slab_route_at_216_epochs(cuda):
    """run('svm') on the face-scene design's epochs (18 subjects x 12
    epochs of 12 TRs, one subject a fold) launches K1 through the slab
    route alone: no FMA kernel (fcma_gram_f32) and no other K1 kernel;
    its accuracies are the CPU path's within one test sample a fold."""
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector

    d = _normalized(6, 216, 12, 70, torch.device("cpu")).numpy()
    d1, d2 = list(d[:, :, :9]), list(d[:, :, 9:])
    labels = [0, 1] * 108
    fk.reset_launches()
    got = dict(VoxelSelector(labels, 12, 18, d1,
                             raw_data2=d2).run('svm'))
    assert _k1_launches() == _slab_launches("tcs", 12)
    want = dict(VoxelSelector(labels, 12, 18, d1, raw_data2=d2,
                              device="cpu").run('svm'))
    g = np.array([got[k] for k in range(9)])
    w = np.array([want[k] for k in range(9)])
    assert np.max(np.abs(g - w)) <= 18 / 216 + 1e-6


def _assert_k3(got, blk, data, eps):
    """The K3 rule: |got - plain| times the group's Fisher-z std at
    most 1e-5 (chip_smoke.py's K3_ZTOL).  With two epochs a subject
    the z-score is +-1 up to the rounding of the one-pass variance
    E[z^2] - mean^2, which the kernels and the plain version round
    differently (the kernels contract into FMAs); its relative error
    grows as mean^2 / var.  Only where a float64 witness shows that
    the plain fp32 version itself misses the rule is the difference
    divided by 1 + mean^2 / var; everywhere else the rule holds as it
    is."""
    want = fk.fcma_corr_normalize_plain(blk, data, eps)
    assert got.shape == want.shape
    sigma = _group_sigma(blk, data, eps)
    err = (got - want).abs() * sigma
    if eps == 2:
        r = torch.einsum('etb,etv->bev', blk.double(), data.double())
        z = 0.5 * torch.log((1 + r) / (1 - r))
        b, e, v = z.shape
        zr = z.reshape(b, e // eps, eps, v)
        mean = zr.mean(dim=2, keepdim=True)
        var = ((zr - mean) ** 2).mean(dim=2, keepdim=True)
        exact = ((zr - mean) / var.sqrt()).reshape(b, e, v)
        cond = (1 + mean ** 2 / var).expand_as(zr).reshape(b, e, v)
        misses = (want.double() - exact).abs() * sigma > 1e-5
        err = torch.where(misses, err / cond.float(), err)
    assert err.max().item() <= 1e-5


@pytest.mark.parametrize("e,t,b,v,eps", [
    (32, 150, 128, 4096, 4), (48, 150, 130, 1001, 4), (16, 9, 21, 77, 4),
    (12, 20, 9, 70, 3), (8, 40, 13, 37, 2), (4, 33, 64, 250, 1),
    (15, 37, 13, 203, 5), (12, 9, 21, 77, 6), (48, 150, 130, 1001, 12),
    (80, 150, 140, 4099, 40)])
def test_fcma_corr_normalize_routes_agree(cuda, e, t, b, v, eps):
    """K3's tensor-core kernel of the route (fcma_corr_tc.cu up to 4
    epochs a subject, fcma_corr_tcl.cu beyond: 5 and 6 end on a partial
    chunk of 4 epochs, 12 and 40 on whole ones) and fcma_corr.cu's FMA
    kernel on the same inputs (ragged B, V and T; E=48 with 4 epochs per
    subject; at E=80, 260 items, so a block of the persistent grid runs
    more than one): each launched as asked, both within the K3 rule of
    the plain version.  Two-region inputs (no |r| near 1)."""
    d = _normalized(e * t + v, e, t, v + b, cuda)
    blk, data = d[:, :, v:].contiguous(), d[:, :, :v].contiguous()
    route = fk.corr_route(e, eps)
    assert route == ("tc" if eps <= 4 else "tcl")
    for name in (route, "ffma"):
        fk.reset_launches()
        got = fk._kernel_corr_normalize(blk, data, eps, route=name)
        counts = fk.launches()
        assert counts["fcma_corr_normalize"] == 1
        for kernel in ("tc", "tcl"):
            assert counts[f"fcma_corr_normalize_{kernel}"] == int(
                name == kernel)
        _assert_k3(got, blk, data, eps)


def _dyadic(seed, e, t, n, dev):
    """[E, T, n] float32 of k / 64, k in -4..4: every product and every
    sum over 16 rows is exact in fp32 and in TF32, so the tensor-core
    and FMA kernels form the same r bit for bit."""
    k = np.random.RandomState(seed).randint(-4, 5, size=(e, t, n))
    return torch.from_numpy((k / 64).astype(np.float32)).to(dev)


@pytest.mark.parametrize("e,eps", [(15, 5), (36, 12), (80, 40)])
def test_fcma_corr_normalize_tcl_is_the_fma_z_score_bit_for_bit(cuda, e,
                                                                eps):
    """Inputs whose correlations are exact (|r| <= 1/16), so both
    kernels form the same r and the same Fisher-z: the long-subject
    kernel's chunked z-score (running sums, the raw z read back) is
    then the FMA kernel's one-tile or statistics-pass z-score bit for
    bit, over ragged B and V."""
    t, b, v = 16, 45, 203
    blk, data = _dyadic(e, e, t, b, cuda), _dyadic(e + 1, e, t, v, cuda)
    got = fk._kernel_corr_normalize(blk, data, eps, route="tcl")
    want = fk._kernel_corr_normalize(blk, data, eps, route="ffma")
    assert torch.isfinite(want).all() and want.abs().max() > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("e,eps", [(24, 12), (80, 40)])
def test_fcma_corr_normalize_tcl_self_pairs(cuda, e, eps):
    """One mask (run(clf) without raw_data2): each block voxel meets
    itself at r = 1 up to rounding in every epoch, where the clamped
    Fisher-z turns the last ulp of r into 4.95 against 8.66.  The
    long-subject kernel forms those r again in fp32 FMA, t ascending,
    as the FMA kernel forms them, so at the self pairs the two routes'
    output is equal bit for bit; elsewhere, outside the subject groups
    that hold an |r| > 0.999, both meet the K3 rule of the plain
    version."""
    d = _normalized(5 * e + eps, e, 30, 203, cuda)
    blk = d[:, :, 40:77].contiguous()
    got = {}
    for route in ("tcl", "ffma"):
        fk.reset_launches()
        got[route] = fk._kernel_corr_normalize(blk, d, eps, route=route)
        assert fk.launches()["fcma_corr_normalize_tcl"] == int(
            route == "tcl")
        assert torch.isfinite(got[route]).all(), route
    n_b = blk.shape[2]
    idx = torch.arange(n_b, device=cuda)
    assert torch.equal(got["tcl"][idx, :, 40 + idx],
                       got["ffma"][idx, :, 40 + idx])
    want = fk.fcma_corr_normalize_plain(blk, d, eps)
    r = torch.einsum('etb,etv->bev', blk.double(), d.double())
    near = (r.abs() > 0.999).reshape(n_b, e // eps, eps, -1).any(
        dim=2, keepdim=True).expand(n_b, e // eps, eps, -1).reshape(
        r.shape)
    assert near[idx, :, 40 + idx].all() and (~near).float().mean() > 0.9
    sigma = _group_sigma(blk, d, eps)
    for route, out in got.items():
        assert ((out - want).abs() * sigma)[~near].max().item() <= 1e-5, \
            route


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_fcma_corr_normalize_tc_views(cuda, offset):
    """Operands that are views: data a column slice of a wider tensor
    (offset 0: 16-byte aligned rows, read in place; 1 and 3: rows off
    16 bytes, copied once), blk a column slice too.  Both routes within
    the K3 rule of the plain version; the output is the caller's
    [B, E, V], contiguous, no padded columns."""
    e, t, b, v, eps = 16, 30, 19, 203, 4
    d = _normalized(40 + offset, e, t, 260, cuda)
    data = d[:, :, offset:offset + v]
    blk = d[:, :, 230:230 + b]
    assert not data.is_contiguous() and not blk.is_contiguous()
    for route in ("tc", "ffma"):
        got = fk._kernel_corr_normalize(blk, data, eps, route=route)
        assert got.shape == (b, e, v) and got.is_contiguous()
        _assert_k3(got, blk, data, eps)
    lay = fk.aligned_rows_layout((e, t, v), cuda)
    lay.copy_(data)
    assert fk._tma_operand(lay) is lay
    fk.reset_launches()
    got = fk.fcma_corr_normalize(blk, lay, eps)
    assert fk.launches()["fcma_corr_normalize_tc"] == 1
    _assert_k3(got, blk, lay, eps)


def test_fcma_corr_normalize_output_shape(cuda):
    """The tensor-core route returns exactly [B, E, V], contiguous, for
    V and B not multiples of 4, and its self-correlation
    (the block's voxels in data, r = 1 with themselves) is finite, the
    clamp confined to the groups that hold it."""
    e, t, b, v, eps = 8, 25, 6, 41, 4
    data = _normalized(8, e, t, v, cuda)
    blk = data[:, :, :b].contiguous()
    fk.reset_launches()
    got = fk.fcma_corr_normalize(blk, data, eps)
    assert fk.launches()["fcma_corr_normalize_tc"] == 1
    assert got.shape == (b, e, v) and got.stride() == (e * v, v, 1)
    assert torch.isfinite(got).all()
    want = fk.fcma_corr_normalize_plain(blk, data, eps)
    r = torch.einsum('etb,etv->bev', blk.double(), data.double())
    near = (r.abs() > 0.999).reshape(b, e // eps, eps, v).any(
        dim=2, keepdim=True).expand(b, e // eps, eps, v).reshape(b, e, v)
    sigma = _group_sigma(blk, data, eps)
    assert ((got - want).abs() * sigma)[~near].max().item() <= 1e-5
    with pytest.raises(ValueError, match="at most 4 epochs"):
        fk._kernel_corr_normalize(data, data, 8, route="tc")


class _Majority:
    """The least estimator VoxelSelector.run(clf) takes: predicts the
    training folds' most frequent label (no scikit-learn on the card's
    machine)."""

    def fit(self, x, y):
        self.label_ = np.bincount(y).argmax()
        return self

    def score(self, x, y):
        return float(np.mean(y == self.label_))


@pytest.mark.parametrize("eps", [4, 8])
def test_run_clf_reads_the_cached_data2_in_place(cuda, monkeypatch, eps):
    """run(clf) with V = 37, not a multiple of 4: every K3 launch, one
    a block of 3 voxels, gets the selector's cached data2 and its
    kernel reads it without a copy, on either route (4 epochs a
    subject: fcma_corr_tc.cu; 8: fcma_corr_tcl.cu)."""
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector

    rng = np.random.RandomState(3)

    def epoch(n_vox):
        m = rng.randn(12, n_vox).astype(np.float32)
        m -= m.mean(axis=0)
        return m / (m.std(axis=0) * 12 ** 0.5)

    d1 = [epoch(10) for _ in range(16)]
    d2 = [epoch(37) for _ in range(16)]
    vs = VoxelSelector([0, 1] * 8, eps, 2, d1, raw_data2=d2, voxel_unit=3,
                       device=cuda)
    _, data2 = vs._stack()
    operand = fk._corr_operand
    passed = []

    def recorded(x, route):
        y = operand(x, route)
        if x.shape[2] == 37:
            passed.append(x is data2 and y is x)
        return y

    monkeypatch.setattr(fk, "_corr_operand", recorded)
    fk.reset_launches()
    accs = vs.run(_Majority())
    assert len(accs) == 10
    assert passed == [True] * 4
    assert fk.launches()["fcma_corr_normalize"] == 4
    assert fk.launches()["fcma_corr_normalize_tc"] == (4 if eps == 4 else 0)
    assert fk.launches()["fcma_corr_normalize_tcl"] == (0 if eps == 4 else 4)


@pytest.mark.parametrize("n,norm_unit", [
    (12, 0), (12, 1), (12, 4), (12, 12), (32, 0), (32, 4), (40, 0),
    (40, 4), (40, 40), (96, 0), (96, 12)])
def test_fcma_sample_gram_kernel(cuda, n, norm_unit):
    """K4 against its plain version on two-region inputs (no |r| near
    1), ragged widths, both orientations of the regions; 40 samples in
    one group span two sample tiles.  Every entry within 1e-4 of
    K[0, 0]; the entries across sample groups, of the order of
    sqrt(K[0, 0]), also within 1e-3 of their own RMS."""
    d = _normalized(n + norm_unit, n, 20, 300 + 37, cuda)
    x1, x2 = d[:, :, :300].contiguous(), d[:, :, 300:].contiguous()
    group = torch.arange(n, device=cuda) // max(norm_unit, 1)
    cross = group[:, None] != group[None, :]
    fk.reset_launches()
    for a, b in ((x1, x2), (x2, x1)):
        got = fk.fcma_sample_gram(a, b, norm_unit)
        want = fk.fcma_sample_gram_plain(a, b, norm_unit)
        assert got.shape == (n, n)
        diff = (got - want).abs()
        assert torch.all(diff <= 1e-4 * want[0, 0].abs())
        if cross.any():
            rms = want[cross].pow(2).mean().sqrt()
            assert torch.all(diff[cross] <= 1e-3 * rms)
    assert fk.launches()["fcma_sample_gram"] == 2
    route = fk.sample_gram_route(n, norm_unit)[0]
    assert fk.launches()["fcma_sample_gram_tc"] == 2 * (route == "tc")
    assert fk.launches()["fcma_sample_gram_tcm"] == 2 * (route == "tcm")
    assert fk.launches()["fcma_sample_gram_tcs"] == 0


def _cross(n, norm_unit, device):
    group = torch.arange(n, device=device) // max(norm_unit, 1)
    return group[:, None] != group[None, :]


def _assert_k4_close(got, want, norm_unit):
    """K4's rule in the tests: every entry within 1e-4 of K[0, 0]; the
    entries across sample groups (of the order of sqrt(K[0, 0]), where
    a wrong product shows first) within 1e-3 of their own RMS."""
    n = want.shape[0]
    assert got.shape == (n, n) and torch.isfinite(got).all()
    cross = _cross(n, norm_unit, want.device)
    diff = (got - want).abs()
    assert torch.all(diff <= 1e-4 * want[0, 0].abs())
    if cross.any():
        rms = want[cross].pow(2).mean().sqrt()
        assert torch.all(diff[cross] <= 1e-3 * rms)


def _sample_gram_f64(x1, x2, norm_unit):
    """K4's formula (the plain version's: one-pass variance) in
    float64."""
    corr = torch.einsum('ntb,ntv->bnv', x1.double(), x2.double())
    if norm_unit > 1:
        corr = within_subject_normalization(corr, norm_unit)
    feats = corr.transpose(0, 1).reshape(corr.shape[1], -1)
    return feats @ feats.T


@pytest.mark.parametrize("n,norm_unit", [
    (n, u) for n in (8, 16, 24, 32) for u in (0, 1, 2, 4, 8)
    if u <= 1 or n % u == 0])
def test_fcma_sample_gram_routes_agree(cuda, n, norm_unit):
    """K4's tensor-core kernel on one sample tile (16 or 32 samples of
    capacity, N below it too) against the plain version and against
    fcma_sample_gram.cu's FMA kernel forced on the same inputs, each
    launched as asked.  Ragged widths: 37 block voxels (the last
    block-voxel tile mostly padding, which must add exactly 0) and
    203 voxels (rows not 16-byte aligned: copied once), T=37 (not a
    whole 8-row stage).  Two-region inputs (no |r| near 1).

    Groups of two samples: the one-pass variance E[z^2] - mean^2 of
    the formula cancels where a group's two Fisher-z values nearly
    coincide, so an fp32 evaluation, the plain version's too, can miss
    1e-4 of K[0, 0] (tests/test_torch_fcma_kernels.py::
    test_k4_plain_groups_of_two_miss_float64).  There both kernels are
    held to the formula in float64, within four times the plain fp32
    version's own largest error (at least the rule's 1e-4 of K[0, 0]
    and 1e-3 of the cross-group RMS), and not to each other."""
    d = _normalized(100 * n + norm_unit, n, 37, 203 + 37, cuda)
    x1, x2 = d[:, :, :203].contiguous(), d[:, :, 203:].contiguous()
    assert fk.sample_gram_route(n, norm_unit)[0] == "tc"
    want = fk.fcma_sample_gram_plain(x1, x2, norm_unit)
    got = {}
    for route in ("tc", "ffma"):
        fk.reset_launches()
        got[route] = fk._kernel_sample_gram(x1, x2, norm_unit, route=route)
        assert fk.launches()["fcma_sample_gram"] == 1
        assert fk.launches()["fcma_sample_gram_tc"] == int(route == "tc")
        assert torch.isfinite(got[route]).all()
    if norm_unit != 2:
        for route in ("tc", "ffma"):
            _assert_k4_close(got[route], want, norm_unit)
        _assert_k4_close(got["tc"], got["ffma"], norm_unit)
        return
    exact = _sample_gram_f64(x2, x1, norm_unit)
    cross = _cross(n, norm_unit, exact.device)
    rms = exact[cross].pow(2).mean().sqrt()
    plain_err = (want.double() - exact).abs()
    for route in ("tc", "ffma"):
        err = (got[route].double() - exact).abs()
        assert err.max() <= max(1e-4 * exact[0, 0].abs(),
                                4 * plain_err.max()), route
        assert err[cross].max() <= max(1e-3 * rms,
                                       4 * plain_err[cross].max()), route


@pytest.mark.parametrize("n,norm_unit", [(16, 4), (32, 8), (24, 12)])
def test_fcma_sample_gram_tc_self_pairs(cuda, n, norm_unit):
    """Region 2 holds region 1 (the classifier's two-mask fits): every
    region-1 voxel paired with itself has r = 1 up to rounding, where
    the clamped Fisher-z turns the last ulp of r into an O(1) change.
    The tensor-core kernel forms those r again in fp32 FMA, as the FMA
    kernel does, so its Gram is the FMA kernel's and the plain
    version's within K4's rule."""
    d = _normalized(7 * n + norm_unit, n, 37, 203, cuda)
    x1, x2 = d, d[:, :, 50:87].contiguous()
    got = {route: fk._kernel_sample_gram(x1, x2, norm_unit, route=route)
           for route in ("tc", "ffma")}
    want = fk.fcma_sample_gram_plain(x1, x2, norm_unit)
    for route in ("tc", "ffma"):
        _assert_k4_close(got[route], want, norm_unit)
    _assert_k4_close(got["tc"], got["ffma"], norm_unit)


def test_fcma_sample_gram_tc_misaligned_rows(cuda, monkeypatch):
    """A region whose rows do not start 16-byte aligned (a view one
    float into its storage) is copied once into aligned rows, the
    other (20 voxels, aligned) read in place; the Gram is the one of
    its aligned copy, bit for bit, and the plain version's."""
    d = _normalized(17, 24, 30, 203 + 20, cuda)
    x2 = d[:, :, 203:].contiguous()
    store = torch.empty(24 * 30 * 203 + 1, device=cuda)
    store[1:] = d[:, :, :203].reshape(-1)
    x1 = store[1:].view(24, 30, 203)
    assert x1.is_contiguous() and x1.data_ptr() % 16
    aligned = fk.aligned_rows_layout(x1.shape, cuda)
    aligned.copy_(x1)
    copies = []
    layout = fk.aligned_rows_layout

    def counted(*args):
        copies.append(args)
        return layout(*args)

    monkeypatch.setattr(fk, "aligned_rows_layout", counted)
    fk.reset_launches()
    got = fk.fcma_sample_gram(x1, x2, 4)
    assert len(copies) == 1 and fk.launches()["fcma_sample_gram_tc"] == 1
    assert torch.equal(got, fk.fcma_sample_gram(aligned, x2, 4))
    assert len(copies) == 1
    _assert_k4_close(got, fk.fcma_sample_gram_plain(x1, x2, 4), 4)


def test_fcma_sample_gram_tc_refuses_several_tiles(cuda):
    """A forced "tc" is refused on calls of several sample tiles, by
    the route and by the C entry point itself."""
    for n, norm_unit in ((48, 4), (40, 40), (33, 0)):
        x = torch.zeros(n, 6, 8, device=cuda)
        with pytest.raises(ValueError, match="one sample tile"):
            fk._kernel_sample_gram(x, x, norm_unit, route="tc")
    fn = fk._fn("fcma_sample_gram_tc", "fcma_sample_gram_tc_f32")
    x = torch.zeros(48, 8, 8, device=cuda)
    partial = torch.empty(64, 32, 32, device=cuda)
    out = torch.empty(48, 48, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for n, norm_unit in ((48, 4), (32, 3)):
        err = fn(x.data_ptr(), x.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), n, 8, 8, 8, norm_unit, 32, 1, 8, 64, 8,
                 64, stream)
        assert err == 1  # cudaErrorInvalidValue


def _k4_route_launches(route, norm_unit, n_slabs=1):
    """K4's launch counts of one call forced onto ``route``: for the
    slab route, one correlation launch (fcma_corr_tcl.cu's raw mode for
    groups of more than one sample, its r mode for raw features), one
    Gram launch and one block-voxel sum a slab."""
    slab = n_slabs * int(route == "tcs")
    return {"fcma_sample_gram": 1,
            "fcma_sample_gram_tc": int(route == "tc"),
            "fcma_sample_gram_tcm": int(route == "tcm"),
            "fcma_sample_gram_tcs": int(route == "tcs"),
            "fcma_sample_gram_tcs_tcl": slab * int(norm_unit > 1),
            "fcma_sample_gram_tcs_r": slab * int(norm_unit <= 1),
            "fcma_sample_gram_tcs_gram": slab,
            "fcma_sample_gram_tcs_sum": slab}


def _k4_launches():
    return {k: n for k, n in fk.launches().items()
            if k.startswith("fcma_sample_gram")}


def _sample_gram_routes(x1, x2, norm_unit, routes):
    """{route: K4 forced onto it}, each launched as asked."""
    got = {}
    for route in routes:
        fk.reset_launches()
        got[route] = fk._kernel_sample_gram(x1, x2, norm_unit, route=route)
        assert _k4_launches() == _k4_route_launches(route, norm_unit), \
            route
        assert torch.isfinite(got[route]).all(), route
    return got


@pytest.mark.parametrize("n,norm_unit", [
    (33, 0), (33, 11), (48, 0), (48, 4), (80, 0), (80, 40), (96, 0),
    (96, 12), (104, 0), (104, 52)])
def test_fcma_sample_gram_tcm_routes_agree(cuda, n, norm_unit):
    """K4's multi-tile tensor-core kernel (every correlation of all N
    samples formed once, the block voxels summed in the Gram's FMA
    chains) and fcma_sample_gram.cu's FMA kernel forced on the same
    inputs, against the plain version: N from 33 (two sample tiles) to
    104 = TCM_MAX_EPOCHS, raw and normalized features, groups of 40 and
    52 that span sample tiles.  Ragged widths: 37 block voxels (the last
    block group of 8 mostly padding, which must add exactly 0) and 203
    voxels (not whole 32-voxel tiles; rows not 16-byte aligned, copied
    once), T=37 (not whole 16-row stages).  Two-region inputs (no |r|
    near 1)."""
    assert fk.sample_gram_route(n, norm_unit)[0] == "tcm"
    d = _normalized(3 * n + norm_unit, n, 37, 203 + 37, cuda)
    x1, x2 = d[:, :, :203].contiguous(), d[:, :, 203:].contiguous()
    want = fk.fcma_sample_gram_plain(x1, x2, norm_unit)
    got = _sample_gram_routes(x1, x2, norm_unit, ("tcm", "ffma"))
    for route in ("tcm", "ffma"):
        _assert_k4_close(got[route], want, norm_unit)
    _assert_k4_close(got["tcm"], got["ffma"], norm_unit)


@pytest.mark.parametrize("n,norm_unit", [(48, 4), (80, 40), (96, 12)])
def test_fcma_sample_gram_tcm_self_pairs(cuda, n, norm_unit):
    """Region 2 holds region 1 (the classifier's two-mask fits): every
    region-1 voxel paired with itself has r = 1 up to rounding, where
    the clamped Fisher-z turns the last ulp of r into an O(1) change.
    The multi-tile kernel forms those r again in fp32 FMA, as the FMA
    kernel does, so its Gram is the FMA kernel's and the plain
    version's within K4's rule."""
    d = _normalized(7 * n + norm_unit, n, 37, 203, cuda)
    x1, x2 = d, d[:, :, 50:87].contiguous()
    got = _sample_gram_routes(x1, x2, norm_unit, ("tcm", "ffma"))
    want = fk.fcma_sample_gram_plain(x1, x2, norm_unit)
    for route in ("tcm", "ffma"):
        _assert_k4_close(got[route], want, norm_unit)
    _assert_k4_close(got["tcm"], got["ffma"], norm_unit)


def test_fcma_sample_gram_tcm_misaligned_rows(cuda, monkeypatch):
    """A region whose rows do not start 16-byte aligned (a view one
    float into its storage) is copied once into aligned rows, the
    other (20 voxels, aligned) read in place; the multi-tile kernel's
    Gram is the one of its aligned copy, bit for bit, and the plain
    version's."""
    d = _normalized(19, 48, 30, 203 + 20, cuda)
    x2 = d[:, :, 203:].contiguous()
    store = torch.empty(48 * 30 * 203 + 1, device=cuda)
    store[1:] = d[:, :, :203].reshape(-1)
    x1 = store[1:].view(48, 30, 203)
    assert x1.is_contiguous() and x1.data_ptr() % 16
    aligned = fk.aligned_rows_layout(x1.shape, cuda)
    aligned.copy_(x1)
    copies = []
    layout = fk.aligned_rows_layout

    def counted(*args):
        copies.append(args)
        return layout(*args)

    monkeypatch.setattr(fk, "aligned_rows_layout", counted)
    fk.reset_launches()
    got = fk.fcma_sample_gram(x1, x2, 4)
    assert len(copies) == 1 and fk.launches()["fcma_sample_gram_tcm"] == 1
    assert torch.equal(got, fk.fcma_sample_gram(aligned, x2, 4))
    assert len(copies) == 1
    _assert_k4_close(got, fk.fcma_sample_gram_plain(x1, x2, 4), 4)


def test_fcma_sample_gram_tcm_refuses(cuda):
    """A forced "tcm" is refused on one sample tile and beyond 104
    samples by the route; the C entry point itself refuses N = 105,
    groups that do not divide N and misaligned operands."""
    for n, norm_unit in ((32, 4), (12, 0), (108, 4)):
        x = torch.zeros(n, 6, 8, device=cuda)
        with pytest.raises(ValueError, match="route 'tcm'"):
            fk._kernel_sample_gram(x, x, norm_unit, route="tcm")
    fn = fk._fn("fcma_sample_gram_tcm", "fcma_sample_gram_tcm_f32")
    x = torch.zeros(105 * 8 * 8 + 4, device=cuda)
    partial = torch.empty(105, 105, device=cuda)
    out = torch.empty(105, 105, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for n, norm_unit, offset in ((105, 0, 0), (48, 5, 0), (48, 4, 1)):
        ptr = x.data_ptr() + 4 * offset
        err = fn(ptr, ptr, partial.data_ptr(), out.data_ptr(), n, 8, 8, 8,
                 norm_unit, 1, 8, 64, 8, 64, stream)
        assert err == 1  # cudaErrorInvalidValue
    err = fn(x.data_ptr(), x.data_ptr(), partial.data_ptr(),
             out.data_ptr(), 104, 8, 8, 8, 0, 1, 8, 64, 8, 64, stream)
    assert err == 0
    torch.cuda.synchronize()
    assert not out.view(-1)[:104 * 104].any()


@pytest.mark.parametrize("n,t,v1,v2,norm_unit", [
    (108, 37, 203, 37, 4), (112, 37, 203, 37, 0), (120, 9, 203, 37, 12),
    (120, 12, 4099, 21, 12), (105, 20, 77, 13, 0), (120, 20, 77, 13, 1),
    (216, 12, 203, 37, 12), (216, 12, 37, 203, 0), (216, 12, 203, 37, 108),
    (300, 12, 1001, 9, 4), (800, 9, 64, 5, 8)])
def test_fcma_sample_gram_tcs_routes_agree(cuda, n, t, v1, v2, norm_unit):
    """K4's slab route beyond 104 samples and fcma_sample_gram.cu's FMA
    kernel forced on the same inputs, against the plain version: raw
    features (the r mode: norm_unit 0 and 1) and groups of 4, 8, 12 and
    108 (a group longer than 104 samples) through the raw mode; either
    region the narrower (the block operand); ragged widths (rows not
    16-byte aligned, copied once) and T (9 and 12 below the 16-row
    stage); one V split and two (4099 voxels); more than 224 samples
    (the Gram's several groups of output blocks, two stages at 800).
    Two-region inputs (no |r| near 1): both within K4's rule of the
    plain version and of each other; the route's Gram symmetric bit
    for bit."""
    assert fk.sample_gram_route(n, norm_unit)[0] == "tcs"
    d = _normalized(n * t + v1, n, t, v1 + v2, cuda)
    x1, x2 = d[:, :, :v1].contiguous(), d[:, :, v1:].contiguous()
    want = fk.fcma_sample_gram_plain(x1, x2, norm_unit)
    got = _sample_gram_routes(x1, x2, norm_unit, ("tcs", "ffma"))
    for route in ("tcs", "ffma"):
        _assert_k4_close(got[route], want, norm_unit)
    _assert_k4_close(got["tcs"], got["ffma"], norm_unit)
    assert torch.equal(got["tcs"], got["tcs"].T)


@pytest.mark.parametrize("n,norm_unit", [(108, 4), (120, 12), (216, 12),
                                         (216, 108), (112, 0)])
def test_fcma_sample_gram_tcs_self_pairs(cuda, n, norm_unit):
    """Region 2 holds region 1 (the study's stage 2 fit, mask1 x the
    whole volume): every region-1 voxel paired with itself has r = 1 up
    to rounding, where the clamped Fisher-z turns the last ulp of r into
    an O(1) change.  The slab route's correlation (the raw mode, and the
    r mode for raw features) forms those r again in fp32 FMA, as the FMA
    kernel does, so its Gram is the FMA kernel's and the plain
    version's within K4's rule."""
    d = _normalized(7 * n + norm_unit, n, 12, 203, cuda)
    x1, x2 = d[:, :, 50:87].contiguous(), d
    got = _sample_gram_routes(x1, x2, norm_unit, ("tcs", "ffma"))
    want = fk.fcma_sample_gram_plain(x1, x2, norm_unit)
    for route in ("tcs", "ffma"):
        _assert_k4_close(got[route], want, norm_unit)
    _assert_k4_close(got["tcs"], got["ffma"], norm_unit)


def test_fcma_sample_gram_tcs_misaligned_rows(cuda, monkeypatch):
    """A region whose rows do not start 16-byte aligned (a view one
    float into its storage) is copied once into aligned rows, the
    other (20 voxels, aligned) read in place; the slab route's Gram is
    the one of its aligned copy, bit for bit, and the plain version's."""
    n = 120
    d = _normalized(23, n, 20, 203 + 20, cuda)
    x2 = d[:, :, 203:].contiguous()
    store = torch.empty(n * 20 * 203 + 1, device=cuda)
    store[1:] = d[:, :, :203].reshape(-1)
    x1 = store[1:].view(n, 20, 203)
    assert x1.is_contiguous() and x1.data_ptr() % 16
    aligned = fk.aligned_rows_layout(x1.shape, cuda)
    aligned.copy_(x1)
    copies = []
    layout = fk.aligned_rows_layout

    def counted(*args):
        copies.append(args)
        return layout(*args)

    monkeypatch.setattr(fk, "aligned_rows_layout", counted)
    fk.reset_launches()
    got = fk.fcma_sample_gram(x1, x2, 4)
    assert len(copies) == 1
    assert _k4_launches() == _k4_route_launches("tcs", 4)
    assert torch.equal(got, fk.fcma_sample_gram(aligned, x2, 4))
    assert len(copies) == 1
    _assert_k4_close(got, fk.fcma_sample_gram_plain(x1, x2, 4), 4)


@pytest.mark.parametrize("norm_unit", [12, 0])
def test_fcma_sample_gram_tcs_slabs_are_bit_for_bit(cuda, norm_unit):
    """Slab budgets of 128 and 256 block voxels (5 and 3 slabs of 600
    block voxels, the last one shorter) give the default's one-slab
    [N, N] bit for bit: each block voxel's Gram does not depend on the
    slab, and the block-voxel sum runs in one order."""
    n, t, b, v = 120, 12, 600, 1000
    d = _normalized(n + norm_unit, n, t, v + b, cuda)
    x1, x2 = d[:, :, v:].contiguous(), d[:, :, :v].contiguous()
    assert fk.tcs_slabs(b, n, v) == (b, 1)
    whole = fk._kernel_sample_gram(x1, x2, norm_unit)
    for per, n_slabs in ((128, 5), (256, 3)):
        budget = 4 * n * v * per + 3
        assert fk.tcs_slabs(b, n, v, budget) == (per, n_slabs)
        fk.reset_launches()
        got = fk._kernel_sample_gram(x1, x2, norm_unit, budget=budget)
        assert _k4_launches() == _k4_route_launches("tcs", norm_unit,
                                                    n_slabs)
        assert torch.equal(got, whole), per


def test_fcma_sample_gram_tcs_refuses(cuda):
    """A forced "tcs" is refused at 104 samples or fewer and beyond 800
    by the route; the new C entry points refuse what they do not take:
    the r mode a misaligned operand, the block-voxel sum more than 800
    samples, negative sizes and a missing output."""
    for n, norm_unit in ((104, 52), (32, 4), (12, 0), (804, 4)):
        x = torch.zeros(n, 6, 8, device=cuda)
        with pytest.raises(ValueError, match="route 'tcs'"):
            fk._kernel_sample_gram(x, x, norm_unit, route="tcs")
    stream = torch.cuda.current_stream().cuda_stream
    corr = fk._fn("fcma_corr_tcl", "fcma_corr_r_tcl_f32")
    d = torch.zeros(120, 6, 9, device=cuda)
    z = torch.empty(2, 120, 9, device=cuda)
    assert corr(d.data_ptr(), d.data_ptr(), z.data_ptr(), 120, 6, 2, 9,
                9, 54, 9, 54, stream) != 0
    assert corr(d.data_ptr() + 4, d.data_ptr(), z.data_ptr(), 120, 6, 2, 8,
                12, 72, 12, 72, stream) != 0
    total = fk._fn("fcma_sample_gram_tcs", "fcma_sample_gram_tcs_sum_f32")
    grams = torch.ones(3, 120, 120, device=cuda)
    out = torch.full((120, 120), 5.0, device=cuda)
    for args in ((801, 3, 1), (-1, 3, 1), (120, -1, 1)):
        assert total(grams.data_ptr(), out.data_ptr(), *args, stream) != 0
    assert total(grams.data_ptr(), None, 120, 3, 1, stream) != 0
    assert total(grams.data_ptr(), out.data_ptr(), 120, 3, 0, stream) == 0
    torch.cuda.synchronize()
    assert torch.all(out == 8.0)
    assert total(grams.data_ptr(), out.data_ptr(), 120, 2, 1, stream) == 0
    torch.cuda.synchronize()
    assert torch.all(out == 2.0)


def test_fcma_sample_gram_refuses_bad_inputs(cuda):
    x = torch.zeros(8, 6, 5, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        fk.fcma_sample_gram(x, x, 3)
    with pytest.raises(TypeError):
        fk.fcma_sample_gram(x.double(), x.double(), 4)
    with pytest.raises(ValueError):
        fk.fcma_sample_gram(x, x[:, :5], 4)


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


def test_voxel_selector_long_subjects_cuda_matches_cpu(cuda):
    """40 epochs per subject (each subject spans two epoch tiles):
    the card's accuracies are the CPU path's within one test sample
    per fold."""
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector

    d = _normalized(2, 80, 20, 57, torch.device("cpu")).numpy()
    d1, d2 = list(d[:, :, :7]), list(d[:, :, 7:])
    labels = [0, 1] * 40
    got = dict(VoxelSelector(labels, 40, 2, d1, raw_data2=d2).run('svm'))
    want = dict(VoxelSelector(labels, 40, 2, d1, raw_data2=d2,
                              device="cpu").run('svm'))
    g = np.array([got[k] for k in range(7)])
    w = np.array([want[k] for k in range(7)])
    assert np.max(np.abs(g - w)) <= 2 / 80 + 1e-6


class _NearestMean:
    """A precomputed-kernel estimator: the class with the larger mean
    kernel value against its training samples."""

    kernel = "precomputed"

    def fit(self, k_train, y):
        self.y_ = np.asarray(y)
        return self

    def decision_function(self, k_test):
        return k_test[:, self.y_ == 1].mean(axis=1) - \
            k_test[:, self.y_ == 0].mean(axis=1)

    def predict(self, k_test):
        return (self.decision_function(k_test) > 0).astype(int)


@pytest.mark.parametrize("n", [24, 216])
@pytest.mark.parametrize("epochs_per_subj", [0, 4])
def test_classifier_cuda_matches_cpu(cuda, epochs_per_subj, n):
    """The portioned fit (K4 on the card, its plain version on the
    CPU) and the single-portion fit (features on the device) give the
    same test similarities and predictions on two-region inputs; at 216
    samples the portioned fit takes K4's slab route alone."""
    from brainiak_tpu_torch.fcma import Classifier

    d = _normalized(5, n, 30, 40 + 9, torch.device("cpu")).numpy()
    pairs = list(zip(d[:, :, :40], d[:, :, 40:]))
    labels = [0, 1] * (n // 2)
    fk.reset_launches()
    for n_proc, n_train in ((8, n - 8), (2000, None)):
        fits = [Classifier(_NearestMean(), num_processed_voxels=n_proc,
                           epochs_per_subj=epochs_per_subj,
                           device=dev).fit(pairs[:16] if n_train is None
                                           else pairs,
                                           labels[:16] if n_train is None
                                           else labels,
                                           num_training_samples=n_train)
                for dev in ("cuda", "cpu")]
        if n_train is None:
            preds = [f.predict(pairs[16:]) for f in fits]
        else:
            preds = [f.predict() for f in fits]
        got, want = (f.test_data_ for f in fits)
        if n_train is not None:
            route = fk.sample_gram_route(n, epochs_per_subj)[0]
            assert _k4_launches()["fcma_sample_gram"] == 1
            assert _k4_launches()[f"fcma_sample_gram_{route}"] == 1
            assert route == ("tcs" if n > 104 else "tc")
        assert fits[0].num_digits_ == fits[1].num_digits_
        assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want).max())
        np.testing.assert_array_equal(preds[0], preds[1])


def _zscored(seed, t, v, dev):
    """[T, V] float32 columns z-scored with 1/sqrt(T), so that a product
    of two columns is a Pearson r in [-1, 1]."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(t, v)
                         .astype(np.float32)).to(dev)
    x -= x.mean(dim=0, keepdim=True)
    x /= x.std(dim=0, keepdim=True, correction=0) * t ** 0.5
    return x.contiguous()


@pytest.mark.parametrize("route", ["tc", "ffma"])
@pytest.mark.parametrize("t,n_local,b,n,owner", [
    (7, 130, 67, 3, 1), (16, 256, 128, 4, 2), (150, 300, 300, 2, 0),
    (33, 64, 16, 1, 0), (600, 512, 384, 3, 2)])
def test_ring_mma_kernel(cuda, t, n_local, b, n, owner, route):
    """K5 against its plain version on both kernels (the tensor-core
    one through ring_mma's own route, the FMA one forced): ragged and
    aligned widths, one NaN column of each operand; the block written
    within 1e-5 with the same NaN positions, every other block
    bit-identical to the sentinel; one launch, of that route."""
    from brainiak_tpu_torch.ops.kernels import ring as kring

    z = _zscored(t, t, n_local, cuda)
    rot = _zscored(t + 1, t, b, cuda)
    z[:, 3] = float("nan")
    rot[:, b // 2] = float("nan")
    sentinel = torch.full((n_local, n * b), -7.0, device=cuda)
    kring.reset_launches()
    if route == "tc":
        got = kring.ring_mma(sentinel.clone(), z, rot, owner, n_shards=n)
    else:
        got = kring._kernel_ring_mma(sentinel.clone(), z, rot, owner,
                                     n_shards=n, route=route)
    assert kring.launches() == 1 and kring.launches(route) == 1
    assert kring.launches("split") == (2 if route == "tc" else 0)
    want = kring.mma_update(sentinel.clone(), z, rot, owner * b)
    torch.cuda.synchronize()
    blk = slice(owner * b, (owner + 1) * b)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int(torch.isnan(got).sum()) == b + n_local - 1
    diff = (got[:, blk] - want[:, blk]).abs()
    assert diff[~torch.isnan(diff)].max().item() <= 1e-5
    others = torch.ones(n * b, dtype=torch.bool, device=cuda)
    others[blk] = False
    assert torch.equal(got[:, others], sentinel[:, others])
    with pytest.raises(ValueError, match="owner"):
        kring.ring_mma(got, z, rot, n, n_shards=n)


def test_ring_mma_writes_a_row_slab(cuda):
    """A row slab of a wider buffer (stride n B, offset rows), through
    the tensor-core route: the rows outside the slab stay as they
    were."""
    from brainiak_tpu_torch.ops.kernels import ring as kring

    z, rot = _zscored(1, 20, 64, cuda), _zscored(2, 20, 64, cuda)
    full = torch.full((256, 256), 3.0, device=cuda)
    kring.reset_launches()
    kring.ring_mma(full[64:128], z, rot, 3, n_shards=4)
    torch.cuda.synchronize()
    assert kring.launches("tc") == 1
    want = z.T @ rot
    assert (full[64:128, 192:] - want).abs().max().item() <= 1e-5
    full[64:128, 192:] = 3.0
    assert torch.all(full == 3.0)


@pytest.mark.parametrize("t,n", [(7, 130), (600, 1000), (64, 33)])
def test_ring_split_kernel_is_bit_identical(cuda, t, n):
    """The tensor-core route's pre-pass against split_kmajor, bit for
    bit: ragged T and n, a NaN column, a contiguous and a strided
    operand."""
    from brainiak_tpu_torch.ops.kernels import ring as kring

    x = torch.from_numpy(np.random.RandomState(n).randn(t, 2 * n)
                         .astype(np.float32)).to(cuda)
    x[:, 5] = float("nan")
    x[:, 6] = 0.0
    t_pad = kring.t_padded(t)
    for op in (x[:, :n].contiguous(), x[:, ::2]):
        kring.reset_launches()
        hi, lo, n_trs = kring.split(op)
        assert kring.launches("split") == 1 and n_trs == t
        want_hi, want_lo = kring.split_kmajor(op, t_pad)
        torch.cuda.synchronize()
        assert hi.shape == (n, t_pad)
        assert torch.equal(hi.view(torch.int32), want_hi.view(torch.int32))
        assert torch.equal(lo.view(torch.int32), want_lo.view(torch.int32))


def test_ring_mma_splits_a_shared_operand_once(cuda):
    """When the panel is the resident block itself (the one-position
    ring), the pre-pass runs once; a strided resident block is read in
    place; an equal copy is split again."""
    from brainiak_tpu_torch.ops.kernels import ring as kring

    wide = _zscored(4, 150, 600, cuda)
    z = wide[:, ::2]
    out = torch.empty((300, 300), device=cuda)
    kring.reset_launches()
    kring.ring_mma(out, z, z, 0, n_shards=1)
    assert kring.launches("tc") == 1 and kring.launches("split") == 1
    want = z.T @ z
    torch.cuda.synchronize()
    assert (out - want).abs().max().item() <= 1e-5
    kring.ring_mma(out, z, z.clone(), 0, n_shards=1)
    assert kring.launches("split") == 3
    torch.cuda.synchronize()
    assert (out - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("n_shards,two", [(1, False), (4, False),
                                          (1, True), (4, True)])
def test_ring_splits_each_shard_once(cuda, n_shards, two):
    """The ring splits each shard of each operand once (of one operand
    when data_b is absent) and runs n^2 tensor-core steps on the
    splits, with the plain ring's result."""
    from brainiak_tpu_torch.ops import distla
    from brainiak_tpu_torch.ops.kernels import ring as kring
    from brainiak_tpu_torch.parallel import make_mesh

    rng = np.random.RandomState(13)
    a = rng.randn(150, 256).astype(np.float32)
    b = rng.randn(150, 256).astype(np.float32) if two else None
    mesh = make_mesh(("voxel",), (n_shards,), devices=["cuda"] * n_shards)
    kring.reset_launches()
    got = distla.summa_gram(a, mesh, data_b=b)
    assert kring.launches("tc") == n_shards ** 2 == kring.launches()
    assert kring.launches("split") == (2 if two else 1) * n_shards
    cpu = make_mesh(("voxel",), (n_shards,), devices=["cpu"] * n_shards)
    want = distla.summa_gram(a, cpu, data_b=b)
    assert (got.cpu() - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("scale", [1e3, 1e-3])
def test_summa_matmul_cuda_raw_inputs(cuda, scale):
    """The ring's raw product on the card (tensor-core K5, 2 positions)
    on unnormalized inputs against float64: within four times the
    error of the fp32 plain product."""
    from brainiak_tpu_torch.ops import distla
    from brainiak_tpu_torch.ops.kernels import ring as kring
    from brainiak_tpu_torch.parallel import make_mesh

    rng = np.random.RandomState(12)
    a = (rng.randn(600, 512) * scale).astype(np.float32)
    b = (rng.randn(600, 512) * scale).astype(np.float32)
    exact = a.astype(np.float64).T @ b.astype(np.float64)
    mesh = make_mesh(("voxel",), (2,), devices=["cuda"] * 2)
    kring.reset_launches()
    got = distla.summa_matmul(a, mesh, b).cpu().numpy()
    assert kring.launches() == 4 and kring.launches("tc") == 4
    assert kring.launches("split") == 4
    plain = (torch.from_numpy(a).to(cuda).T @ torch.from_numpy(b)
             .to(cuda)).cpu().numpy()
    err = np.abs(got - exact).max()
    err_plain = np.abs(plain - exact).max()
    assert err <= 4 * err_plain, (err, err_plain)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_summa_gram_cuda_matches_cpu(cuda, n_shards):
    """The ring on a 1- and a 4-position mesh of the card against the
    CPU port (uneven split, a cross Gram): n * n K5 launches."""
    from brainiak_tpu_torch.ops import distla
    from brainiak_tpu_torch.ops.kernels import ring as kring
    from brainiak_tpu_torch.parallel import make_mesh

    rng = np.random.RandomState(n_shards)
    data = rng.randn(40, 203).astype(np.float32)
    other = rng.randn(40, 203).astype(np.float32)
    mesh = make_mesh(("voxel",), (n_shards,), devices=["cuda"] * n_shards)
    cpu = make_mesh(("voxel",), (n_shards,), devices=["cpu"] * n_shards)
    for b in (None, other):
        kring.reset_launches()
        got = distla.summa_gram(data, mesh, data_b=b)
        assert kring.launches() == n_shards * n_shards
        assert got.is_cuda and got.shape == (203, 203)
        want = distla.summa_gram(data, cpu, data_b=b)
        assert (got.cpu() - want).abs().max().item() <= 1e-5
    with pytest.raises(ValueError, match="ring_step"):
        distla.summa_gram(data, mesh, ring_step="nope")


def test_isfc_mesh_cuda_matches_cpu(cuda):
    """Leave-one-out ISFC by the ring on the card (one K5 launch per
    subject on a one-position mesh) against the CPU port."""
    from brainiak_tpu_torch import isc as tisc
    from brainiak_tpu_torch.ops.kernels import ring as kring
    from brainiak_tpu_torch.parallel import make_mesh

    rng = np.random.RandomState(9)
    signal = rng.randn(60, 32)
    data = np.dstack([signal + rng.randn(60, 32) for _ in range(5)])
    data[:4, 2, 1] = np.nan
    kring.reset_launches()
    got = tisc.isfc(data, vectorize_isfcs=False,
                    mesh=make_mesh(("voxel",), (-1,), devices=["cuda"]))
    assert kring.launches() == 5
    want = tisc.isfc(data, vectorize_isfcs=False,
                     mesh=make_mesh(("voxel",), (2,), devices=["cpu"] * 2),
                     device="cpu")
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    dense = tisc.isfc(data, vectorize_isfcs=False)
    np.testing.assert_allclose(got, dense, atol=1e-5, rtol=0)
