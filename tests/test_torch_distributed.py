"""The port across processes: two gloo ranks, each with two CPU
positions of one 4-position voxel mesh, spawned by
:func:`brainiak_tpu_torch.parallel.testing.run_distributed`.

One spawn (``tests/torch_dist_workers.py``'s ``parity_worker``) runs
every multi-process path; each test reads its part.  Each rank's result
is held to the other rank's bit for bit, to the port's single-process
run, and to the JAX package's single-process run (no mesh) computed in
this process, on the data of ``tests/parallel/dist_workers.py``.
Tolerances: 1e-5 absolute on correlations (float32 sums in another
order), 1e-5 of K[0, 0] on the FCMA Gram, 1e-6 on accuracies (exact
fractions of the test samples), the JAX package's float64 ISC and ISFC
within 1e-5 of the port's float32.
"""

import importlib
import time

import numpy as np
import pytest
import torch

from brainiak_tpu.fcma.voxelselector import VoxelSelector as JaxSelector
from brainiak_tpu.isc import isc as jisc
from brainiak_tpu.isc import isfc as jisfc
from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector
from brainiak_tpu_torch.ops import distla
from brainiak_tpu_torch.ops.fcma_kernels import fcma_gram_plain
from brainiak_tpu_torch.parallel import make_mesh
from brainiak_tpu_torch.parallel import mesh as tmesh
from brainiak_tpu_torch.parallel.testing import run_distributed
from tests.conftest import REPO_ROOT
from tests.parallel.dist_workers import (make_fcma_data, make_isc_data,
                                         make_isfc_data)
from tests.torch_dist_workers import RING_SHAPE, ring_data, ulp_base

tretry = importlib.import_module("brainiak_tpu_torch.resilience.retry")

ATOL = 1e-5
ACC_ATOL = 1e-6
#: each spawn's limit, far below the suite's
SPAWN_TIMEOUT = 120


@pytest.fixture(scope="module")
def ranks():
    """Both ranks' results of the parity worker (one spawn)."""
    return run_distributed("tests.torch_dist_workers", "parity_worker",
                           n_procs=2, local_devices=2,
                           timeout=SPAWN_TIMEOUT, extra_path=REPO_ROOT)


def _accs(results):
    return np.array([a for _, a in sorted(results)])


def _port_single():
    raw, labels, eps = make_fcma_data()
    return VoxelSelector(labels, eps, 2, raw, voxel_unit=8,
                         device="cpu").run('svm')


def _jax_single():
    raw, labels, eps = make_fcma_data()
    return JaxSelector(labels, eps, 2, raw, voxel_unit=8,
                       use_pallas=False).run('svm')


def test_mesh_spans_both_ranks(ranks):
    for pid, r in enumerate(ranks):
        assert r["pid"] == pid and r["n_positions"] == 4
        assert r["ranks"] == [0, 0, 1, 1]


@pytest.mark.parametrize("path", ["fcma_mesh", "fcma_distla"])
def test_voxelselector_across_ranks(ranks, path):
    """Every rank returns the whole gathered ranking, equal on both
    ranks, to the port's single-process run and to the JAX package's."""
    got = [r[path] for r in ranks]
    assert got[0] == got[1]
    assert sorted(v for v, _ in got[0]) == list(range(32))
    accs = _accs(got[0])
    for want in (_port_single(), _jax_single()):
        np.testing.assert_allclose(accs, _accs(want), rtol=0,
                                   atol=ACC_ATOL)


def test_kkt_gaps_gathered(ranks):
    """The SMO's KKT gaps come back whole, in voxel order, on every
    rank."""
    raw, labels, eps = make_fcma_data()
    vs = VoxelSelector(labels, eps, 2, raw, voxel_unit=8, device="cpu")
    vs.run('svm')
    for r in ranks:
        np.testing.assert_allclose(r["fcma_mesh_gaps"], vs.kkt_gaps_,
                                   rtol=0, atol=ACC_ATOL)


def test_block_gram_all_reduced(ranks):
    """The partial Grams of the 4 positions (30 voxels, 2 zero pad
    columns) summed across ranks: the Gram of the whole data2."""
    raw, _, eps = make_fcma_data()
    stack = torch.from_numpy(np.stack(raw).astype(np.float32))
    want = fcma_gram_plain(stack[:, :, 30:], stack[:, :, :30],
                           eps).numpy()
    k00 = want[:, 0, 0][:, None, None]
    np.testing.assert_array_equal(ranks[0]["block_gram"],
                                  ranks[1]["block_gram"])
    assert np.max(np.abs(ranks[0]["block_gram"] - want) / k00) <= 1e-5


@pytest.mark.parametrize("pairwise", [False, True])
def test_isc_across_ranks(ranks, pairwise):
    got = [r["isc_pairwise" if pairwise else "isc"] for r in ranks]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], jisc(make_isc_data(),
                                            pairwise=pairwise),
                               rtol=0, atol=ATOL)


def test_isfc_ring_across_ranks(ranks):
    """The leave-one-out ISFC by the ring, its panels crossing ranks
    and its [V, V] rows fetched a slab at a time, against the JAX
    package's dense single-process ISFC."""
    (isfcs_0, iscs_0), (isfcs_1, iscs_1) = [r["isfc"] for r in ranks]
    np.testing.assert_array_equal(isfcs_0, isfcs_1)
    np.testing.assert_array_equal(iscs_0, iscs_1)
    want_isfcs, want_iscs = jisfc(make_isfc_data(), vectorize_isfcs=True)
    np.testing.assert_allclose(isfcs_0, want_isfcs, rtol=0, atol=ATOL)
    np.testing.assert_allclose(iscs_0, want_iscs, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["summa_gram", "summa_unfused",
                                  "gram_summa", "panel_gram"])
def test_ring_gram_across_ranks(ranks, name):
    """30 voxels on 4 positions (padded): the ring (both steps), the
    budget dispatcher's ring and the panel Gram across ranks, against
    the single-process ring and float64's corrcoef."""
    data = ring_data()
    got = [r[name] for r in ranks]
    assert got[0].shape == (RING_SHAPE[1],) * 2
    np.testing.assert_array_equal(got[0], got[1])
    single = distla.summa_gram(
        data, make_mesh(("voxel",), (4,), devices=["cpu"] * 4)).numpy()
    np.testing.assert_allclose(got[0], single, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[0], np.corrcoef(data.T.astype(float)),
                               rtol=0, atol=ATOL)


def test_ring_correlation_across_ranks(ranks):
    data = ring_data().astype(float)
    a, b = data[:, :28], data[:, 2:]
    want = np.corrcoef(a.T, b.T)[:28, 28:]
    for r in ranks:
        np.testing.assert_allclose(r["ring_correlation"], want, rtol=0,
                                   atol=ATOL)


def test_split_panels_cross_ranks(ranks):
    """K5's split panels (hi and lo) go round the ring: position i takes
    position i - 1's, on the rank that owns i."""
    for pid, r in enumerate(ranks):
        for k, panel in enumerate(r["hand_on"]):
            if k // 2 != pid:
                assert panel is None
                continue
            hi, lo, n_trs = panel
            src = float((k - 1) % 4)
            assert n_trs == 7
            assert np.all(np.array(hi) == src)
            assert np.all(np.array(lo) == -src)


def test_fetch_replicated_gathers(ranks):
    arr = np.arange(48, dtype=np.float32).reshape(3, 16)
    for r in ranks:
        np.testing.assert_array_equal(r["fetch"], arr)


def test_place_on_mesh_keeps_each_ranks_copy(ranks):
    """Copies that differ in the last ulp: no rank compares them, each
    fills its own positions from its own, and a replicated placement
    keeps each rank's copy."""
    base = ulp_base()
    shifted = np.nextafter(base, np.float32(np.inf))
    assert [r["place_held"] for r in ranks] == [[0, 1], [2, 3]]
    want = np.concatenate([base[:, :4], shifted[:, 4:]], axis=1)
    for r in ranks:
        np.testing.assert_array_equal(r["place"], want)
    np.testing.assert_array_equal(ranks[0]["replicated"], base)
    np.testing.assert_array_equal(ranks[1]["replicated"], shifted)


def test_place_on_mesh_in_one_process():
    """The spec form of shard_along and replicated: a split dimension
    gives one piece a position, none a whole copy a distinct device;
    two split dimensions raise."""
    mesh = make_mesh(("subject", "voxel"), (2, 2),
                     devices=["cpu"] * 3 + ["meta"])
    arr = np.arange(24, dtype=np.float32).reshape(3, 8)
    placed = tmesh.place_on_mesh(arr, mesh, (None, "voxel"))
    assert placed.ranks is None and placed.devices == [torch.device("cpu")] * 2
    np.testing.assert_array_equal(tmesh.fetch_replicated(placed), arr)
    whole = tmesh.place_on_mesh(arr, mesh)
    assert whole.devices == [torch.device("cpu"), torch.device("meta")]
    np.testing.assert_array_equal(tmesh.fetch_replicated(whole), arr)
    with pytest.raises(ValueError, match="splits 2"):
        tmesh.place_on_mesh(arr, mesh, ("subject", "voxel"))


def test_row_helpers_of_a_stack_across_ranks():
    """The row helpers on a stack of 5 rows in 3 pieces (2, 2, 1 rows,
    ``torch.tensor_split``'s cut) of which this rank owns the first and
    the last: its rows are 0, 1 and 4, cut back into its two pieces;
    on a plain tensor every helper hands the leaf back."""
    stack = torch.arange(15.0).reshape(5, 3)
    pieces = torch.tensor_split(stack, 3)
    x = tmesh.Sharded([pieces[0], None, pieces[2]],
                      [torch.device("cpu")] * 3, 0, ("subject",), [0, 1, 0],
                      tuple(stack.shape))
    leaf = torch.arange(5.0) * 10
    assert tmesh.spans_processes(x) and not tmesh.spans_processes(stack)
    assert [p.shape[0] for p in tmesh.local_pieces(x)] == [2, 1]
    mine = tmesh.local_rows(x, leaf)
    np.testing.assert_array_equal(mine.numpy(), [0.0, 10.0, 40.0])
    parts = tmesh.split_rows(x, mine)
    assert [p.tolist() for p in parts] == [[0.0, 10.0], [40.0]]
    laid = tmesh.laid_out_rows(x, mine)
    assert laid.chunks[1] is None and laid.shape == (5,)
    assert torch.equal(tmesh.cat_pieces(parts), mine)
    assert tmesh.cat_pieces([leaf]) is leaf
    for helper in (tmesh.local_rows, tmesh.gather_rows, tmesh.all_sum):
        assert helper(stack, leaf) is leaf
    assert tmesh.split_rows(stack, leaf) == [leaf]
    np.testing.assert_array_equal(tmesh.fetch_rows(stack, leaf),
                                  leaf.numpy())


def test_failing_rank_kills_its_peer():
    """A rank that dies at once is reported with its traceback in
    seconds, its peer (blocked in a collective) killed."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="intentional worker failure"):
        run_distributed("tests.torch_dist_workers", "failing_worker",
                        n_procs=2, local_devices=1, timeout=SPAWN_TIMEOUT,
                        extra_path=REPO_ROOT)
    assert time.monotonic() - t0 < 60


def test_initialize_distributed_retries_transient_connects(monkeypatch):
    """A connect refusal is retried with backoff; a deterministic
    RuntimeError propagates at once; one process is a no-op."""
    calls, sleeps = [], []
    errors = [RuntimeError("connection refused"),
              RuntimeError("Timed out waiting for peers")]

    def init(**kw):
        calls.append(kw)
        if errors:
            raise errors.pop(0)

    monkeypatch.setattr(torch.distributed, "init_process_group", init)
    monkeypatch.setattr(tretry, "_sleep", sleeps.append)
    monkeypatch.setattr(tmesh, "_local_devices", None)
    tmesh.initialize_distributed("127.0.0.1:1234", num_processes=2,
                                 process_id=1, device="cpu")
    assert len(calls) == 3 and len(sleeps) == 2
    assert calls[-1] == {"backend": "gloo",
                         "init_method": "tcp://127.0.0.1:1234",
                         "world_size": 2, "rank": 1}
    assert sleeps[1] > sleeps[0] > 0
    assert tmesh._local_devices == [torch.device("cpu")]

    calls.clear()
    errors[:] = [RuntimeError("process group already initialized")]
    with pytest.raises(RuntimeError, match="already initialized"):
        tmesh.initialize_distributed("tcp://127.0.0.1:1234",
                                     num_processes=2, process_id=0,
                                     device="cpu")
    assert len(calls) == 1
    calls.clear()
    tmesh.initialize_distributed(num_processes=1, device="cpu")
    assert calls == []
    with pytest.raises(RuntimeError, match="not available"):
        tmesh.initialize_distributed(num_processes=2, process_id=0,
                                     backend="nccl", device="cpu")
