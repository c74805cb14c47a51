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
from tests.torch_card_workers import (fixed_centers_widths, make_detsrm_data,
                                      make_rbf_subjects)

#: the ring data: [T, V], V not a multiple of the 4 positions
RING_SHAPE = (16, 30)
#: a [T, V] array whose columns the ranks hold in different ulps
ULP_SHAPE = (3, 8)


def ring_data():
    return np.random.RandomState(21).randn(*RING_SHAPE).astype(np.float32)


def ulp_base():
    return np.random.RandomState(22).randn(*ULP_SHAPE).astype(np.float32)


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
    return out


def failing_worker(process_id, num_processes):
    """Rank 0 fails at once; rank 1 blocks in a collective that needs
    it, so the harness must kill it."""
    if process_id == 0:
        raise RuntimeError("intentional worker failure")
    torch.distributed.all_reduce(torch.ones(1))
    return 0


# -- the subject axis across processes (test_torch_distributed_srm.py) --

#: the environment variable naming the npz of the initial W that the
#: SRM workers inject (the JAX package's draws, written by the test)
W0_ENV = "BRAINIAK_TORCH_TEST_W0"
#: the estimators' settings: iterations, features (and RSRM's gamma)
SRM_FITS = {"SRM": (5, 3), "DetSRM": (5, 3), "RSRM": (8, 3)}
RSRM_GAMMA = 0.5


def make_rsrm_data():
    """4 ragged subjects (40 + 3 i voxels x 30 TRs), 3 features, 2% of
    the entries moved by a sparse term."""
    rng = np.random.RandomState(14)
    R = rng.randn(3, 30)
    X = []
    for i in range(4):
        q, _ = np.linalg.qr(rng.randn(40 + 3 * i, 3))
        s = np.zeros((40 + 3 * i, 30))
        idx = rng.rand(*s.shape) < 0.02
        s[idx] = rng.randn(idx.sum()) * 5
        X.append(q @ R + s + 0.05 * rng.randn(*s.shape))
    return X


def srm_inputs():
    """The data each estimator is fitted on."""
    from tests.parallel.dist_workers import make_srm_class_data
    return {"SRM": make_srm_class_data(), "DetSRM": make_detsrm_data(),
            "RSRM": make_rsrm_data()}


def solve_inputs():
    """A batch of 8 SPD [3, 3] matrices and [8, 3, 2] right-hand
    sides (float64)."""
    rng = np.random.RandomState(15)
    a = rng.randn(8, 3, 3)
    mats = a @ a.transpose(0, 2, 1) + 3 * np.eye(3)
    return mats, rng.randn(8, 3, 2)


def make_estimator(name, **kw):
    """The port's estimator ``name`` with the test's settings."""
    from brainiak_tpu_torch.funcalign.rsrm import RSRM
    from brainiak_tpu_torch.funcalign.srm import SRM, DetSRM

    n_iter, features = SRM_FITS[name]
    if name == "RSRM":
        return RSRM(n_iter=n_iter, features=features, gamma=RSRM_GAMMA,
                    device="cpu", **kw)
    cls = SRM if name == "SRM" else DetSRM
    return cls(n_iter=n_iter, features=features, device="cpu", **kw)


def inject_w0(name):
    """Patch the port's ``_init_w`` to return the initial W of
    ``name`` that the test wrote (every subject's; each rank keeps its
    own)."""
    import os

    from brainiak_tpu_torch.funcalign import srm

    w0 = np.load(os.environ[W0_ENV])[name]
    srm._init_w = lambda *a, device="cpu", **k: \
        torch.tensor(w0).float().to(device)


def fitted(model):
    """An estimator's fitted arrays, numpy."""
    out = {"w": [np.asarray(w) for w in model.w_]}
    for attr in ("s_", "r_", "rho2_", "sigma_s_"):
        if hasattr(model, attr):
            v = getattr(model, attr)
            out[attr] = [np.asarray(a) for a in v] \
                if isinstance(v, list) else np.asarray(v)
    for attr in ("logprob_", "objective_"):
        if hasattr(model, attr):
            out["objective"] = float(getattr(model, attr))
    return out


def _fetch_all(out):
    from brainiak_tpu_torch.parallel import fetch_replicated

    if isinstance(out, tuple):
        return tuple(fetch_replicated(o) for o in out)
    return fetch_replicated(out)


def subject_axis_worker(process_id, num_processes):
    """The subject-axis solves and estimators on one 4-position subject
    mesh of two ranks: the batched solves given the whole batch and
    given a batch laid out along the axis, SRM, DetSRM and RSRM from
    the injected W0, and a checkpointed SRM fit and its resume in a
    directory the ranks share."""
    import os
    import shutil

    from brainiak_tpu_torch.ops import distla
    from brainiak_tpu_torch.parallel import make_mesh, shard_along

    torch.set_num_threads(1)
    mesh = make_mesh(("subject",), (-1,))
    out = {"pid": process_id, "ranks": mesh.ranks.tolist()}
    mats, rhs = (torch.from_numpy(a) for a in solve_inputs())
    laid = [shard_along(a, mesh, "subject", 0) for a in (mats, rhs)]
    calls = {
        "batched_eigh": lambda m, r: distla.batched_eigh(m, mesh),
        "batched_cholesky_solve":
            lambda m, r: distla.batched_cholesky_solve(m, r, mesh),
        "shard_vmap": lambda m, r: distla.shard_vmap(
            lambda a, b: (torch.trace(a), a @ b), mesh, "subject", 8)(
                m, r),
    }
    for name, call in calls.items():
        whole = call(mats, rhs)
        out[name] = tuple(o.numpy() for o in whole) \
            if isinstance(whole, tuple) else whole.numpy()
        res = call(*laid)
        first = res[0] if isinstance(res, tuple) else res
        out[name + "_held"] = [k for k, _, _ in first.local()]
        out[name + "_laid"] = _fetch_all(res)
    # a batch of 6 does not divide the 4 positions: the plain vmap
    out["uneven"] = distla.batched_eigh(mats[:6], mesh)[0].numpy()

    for name, X in srm_inputs().items():
        inject_w0(name)
        out[name] = fitted(make_estimator(name, mesh=mesh).fit(X))

    inject_w0("SRM")
    X = srm_inputs()["SRM"]
    ckpt = os.path.join(os.path.dirname(os.environ[W0_ENV]), "ckpt")
    first = make_estimator("SRM", mesh=mesh).fit(
        X, checkpoint_dir=ckpt, checkpoint_every=2)
    torch.distributed.barrier()
    out["ckpt_files"] = sorted(os.listdir(ckpt))
    torch.distributed.barrier()
    resumed = make_estimator("SRM", mesh=mesh).fit(
        X, checkpoint_dir=ckpt, checkpoint_every=2)
    out["ckpt_first"] = fitted(first)
    out["ckpt_resumed"] = fitted(resumed)
    torch.distributed.barrier()
    if process_id == 0:
        shutil.rmtree(ckpt)
    return out


# -- the searchlight across processes (test_torch_searchlight.py) -------

def mean_masked(patches, mask_patch, rad, bcast):
    """The traced tier's statistic of the JAX package's distributed
    searchlight test: the mean of the masked patches."""
    return torch.mean(patches * mask_patch[None, :, None])


def searchlight_worker(process_id, num_processes):
    """The traced tier's centre sweep split over a 4-position voxel
    mesh of two ranks; every rank returns the whole volume."""
    from brainiak_tpu_torch.parallel import make_mesh
    from brainiak_tpu_torch.searchlight import Searchlight
    from tests.parallel.dist_workers import make_searchlight_data

    torch.set_num_threads(1)
    mesh = make_mesh(("voxel",), (-1,))
    data, mask = make_searchlight_data()
    sl = Searchlight(sl_rad=1, mesh=mesh)
    sl.distribute(data, mask)
    return sl.run_searchlight_jax(mean_masked, batch_size=64)



# -- HTFA and the ridge encoder across processes -------------------------
# (test_torch_factoranalysis.py, test_torch_encoding.py)

#: HTFA's settings on the two-rank subject mesh: 3 subjects on 4
#: positions, so the subject count is padded up and the pad dropped
HTFA_KW = dict(K=2, n_subj=3, max_global_iter=2, max_local_iter=1,
               threshold=0.5, voxel_ratio=1.0, tr_ratio=1.0,
               max_voxel=512, max_tr=60)


def htfa_worker(process_id, num_processes):
    """HTFA on a 4-position subject mesh of two ranks (3 subjects), and
    the meshless fit in the same process; both with the fixed
    seeding."""
    from brainiak_tpu_torch.factoranalysis import HTFA, tfa
    from brainiak_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    tfa.TFA.init_centers_widths = fixed_centers_widths
    X, R, _, _ = make_rbf_subjects(HTFA_KW["n_subj"])
    out = {}
    for label, mesh in (("mesh", make_mesh(("subject",), (-1,))),
                        ("single", None)):
        np.random.seed(0)
        model = HTFA(mesh=mesh, device="cpu", **HTFA_KW).fit(X, R)
        out[label] = (model.global_posterior_, model.local_posterior_,
                      model.local_weights_)
    return out


def make_ridge_data(t=40, f=8, v=12, seed=9, noise=0.5):
    """``tests/encoding/test_ridge.py``'s design and responses."""
    rng = np.random.RandomState(seed)
    x = rng.randn(t, f).astype(np.float32)
    w = (rng.randn(f, v) / np.sqrt(f)).astype(np.float32)
    y = (x @ w + noise * rng.randn(t, v)).astype(np.float32)
    return x, y


def ridge_worker(process_id, num_processes):
    """``RidgeEncoder`` with its Gram on the SUMMA ring of a 4-position
    voxel mesh of two ranks (the distla budget at one byte), and the
    meshless fit in the same process."""
    import os

    from brainiak_tpu_torch.encoding import RidgeEncoder
    from brainiak_tpu_torch.ops.distla import BUDGET_ENV
    from brainiak_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    os.environ[BUDGET_ENV] = "1"
    x, y = make_ridge_data()
    out = {}
    for label, mesh in (("mesh", make_mesh(("voxel",), (-1,))),
                        ("single", None)):
        enc = RidgeEncoder(lambdas=(1.0, 10.0), n_folds=4, mesh=mesh,
                           device="cpu").fit(x, y)
        out[label] = (enc.W_, enc.lambda_, enc.cv_scores_)
    return out
