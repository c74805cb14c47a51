"""Worker functions of the port's multi-process tests.

They run inside the ``torch.distributed`` processes that
:func:`brainiak_tpu_torch.parallel.testing.run_distributed` spawns (two
gloo ranks, each with two CPU positions), on the data of
``tests/parallel/dist_workers.py``.  They import neither jax nor
``brainiak_tpu``.
"""

import numpy as np
import torch

from tests.parallel.dist_workers import (make_fcma_data, make_isc_data,
                                         make_isfc_data)

#: the ring data: [T, V], V not a multiple of the 4 positions
RING_SHAPE = (16, 30)
#: a [T, V] array whose columns the ranks hold in different ulps
ULP_SHAPE = (3, 8)


def ring_data():
    return np.random.RandomState(21).randn(*RING_SHAPE).astype(np.float32)


def ulp_base():
    return np.random.RandomState(22).randn(*ULP_SHAPE).astype(np.float32)


def _refusal(fn):
    """The message of the ``NotImplementedError`` that ``fn`` raises,
    or a note that it returned."""
    try:
        fn()
    except NotImplementedError as exc:
        return str(exc)
    return "returned"


def _hand_on_splits(mesh, pid):
    """The panels of K5's split form after one hand-over round the
    4-position ring: a :class:`Split` a position, its hi and lo filled
    with the position index."""
    from brainiak_tpu_torch.ops import distla
    from brainiak_tpu_torch.ops.kernels.ring import Split
    from brainiak_tpu_torch.parallel.mesh import axis_devices, axis_ranks

    devices = axis_devices(mesh, "voxel")
    ranks = axis_ranks(mesh, "voxel")
    panels = [Split(torch.full((3, 32), float(k)),
                    torch.full((3, 32), -float(k)), 7)
              if r == pid else None for k, r in enumerate(ranks)]
    moved = distla._hand_on(panels, devices, ranks)
    return [None if p is None else (p.hi.tolist(), p.lo.tolist(), p.n_trs)
            for p in moved]


def parity_worker(process_id, num_processes):
    """Every multi-process path of the port on one 4-position voxel
    mesh of two ranks; each rank returns what it computed."""
    from brainiak_tpu_torch.fcma.voxelselector import VoxelSelector
    from brainiak_tpu_torch.funcalign.rsrm import RSRM
    from brainiak_tpu_torch.funcalign.srm import SRM, DetSRM
    from brainiak_tpu_torch.isc import isc, isfc
    from brainiak_tpu_torch.ops import distla, ring
    from brainiak_tpu_torch.parallel import (fetch_replicated, make_mesh,
                                             place_on_mesh, replicated,
                                             shard_along)

    torch.set_num_threads(1)
    mesh = make_mesh(("voxel",), (-1,))
    out = {"n_positions": mesh.size, "ranks": mesh.ranks.tolist(),
           "pid": process_id}

    raw, labels, eps = make_fcma_data()
    vs = VoxelSelector(labels, eps, 2, raw, voxel_unit=8, mesh=mesh,
                       device="cpu")
    out["fcma_mesh"] = vs.run('svm')
    out["fcma_mesh_gaps"] = vs.kkt_gaps_
    vs = VoxelSelector(labels, eps, 2, raw, voxel_unit=8, mesh=mesh,
                       use_distla=True, device="cpu")
    out["fcma_distla"] = vs.run('svm')
    stack = np.stack(raw).astype(np.float32)
    # 30 voxels for data2: the 4 positions take 2 zero pad columns
    out["block_gram"] = distla.block_gram(stack[:, :, 30:],
                                          stack[:, :, :30], mesh,
                                          eps).numpy()

    out["isc"] = isc(make_isc_data(), mesh=mesh, device="cpu")
    out["isc_pairwise"] = isc(make_isc_data(), pairwise=True, mesh=mesh,
                              device="cpu")
    out["isfc"] = isfc(make_isfc_data(), mesh=mesh, vectorize_isfcs=True,
                       device="cpu")

    data = ring_data()
    out["summa_gram"] = fetch_replicated(distla.summa_gram(data, mesh))
    out["summa_unfused"] = fetch_replicated(
        distla.summa_gram(data, mesh, ring_step="unfused"))
    out["gram_summa"] = fetch_replicated(distla.gram(
        data, mesh=mesh, force="summa", device="cpu"))
    out["ring_correlation"] = fetch_replicated(ring.ring_correlation(
        data[:, :28], mesh, data_b=data[:, 2:]))
    out["panel_gram"] = distla.panel_gram(data, mesh, panel_size=5)
    out["hand_on"] = _hand_on_splits(mesh, process_id)

    arr = np.arange(48, dtype=np.float32).reshape(3, 16)
    out["fetch"] = fetch_replicated(shard_along(arr, mesh, "voxel", 1))
    own = ulp_base()
    if process_id == 1:
        own = np.nextafter(own, np.float32(np.inf))
    placed = place_on_mesh(own, mesh, (None, "voxel"))
    out["place_held"] = [k for k, _, _ in placed.local()]
    out["place"] = fetch_replicated(placed)
    out["replicated"] = fetch_replicated(replicated(own, mesh))

    subjects = [np.random.RandomState(s).randn(10, 12) for s in range(4)]
    smesh = make_mesh(("subject",), (-1,))
    out["refusals"] = {
        "SRM": _refusal(lambda: SRM(n_iter=2, features=2, mesh=smesh,
                                    device="cpu").fit(subjects)),
        "DetSRM": _refusal(lambda: DetSRM(n_iter=2, features=2,
                                          mesh=smesh,
                                          device="cpu").fit(subjects)),
        "RSRM": _refusal(lambda: RSRM(n_iter=2, features=2, mesh=smesh,
                                      device="cpu").fit(subjects)),
        "batched_eigh": _refusal(lambda: distla.batched_eigh(
            torch.eye(3).repeat(4, 1, 1), smesh)),
        "batched_cholesky_solve": _refusal(
            lambda: distla.batched_cholesky_solve(
                torch.eye(3).repeat(4, 1, 1), torch.ones(4, 3, 1), smesh)),
        "shard_vmap": _refusal(lambda: distla.shard_vmap(
            torch.trace, smesh, "subject", 4)(torch.eye(3).repeat(4, 1,
                                                                  1))),
    }
    return out


def failing_worker(process_id, num_processes):
    """Rank 0 fails at once; rank 1 blocks in a collective that needs
    it, so the harness must kill it."""
    if process_id == 0:
        raise RuntimeError("intentional worker failure")
    torch.distributed.all_reduce(torch.ones(1))
    return 0
