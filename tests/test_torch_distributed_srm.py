"""The subject axis across processes: distla's batched solves and the
SRM family on two gloo ranks, each with two CPU positions of one
4-position ``'subject'`` mesh, spawned once for the whole file by
:func:`brainiak_tpu_torch.parallel.testing.run_distributed`
(``tests/torch_dist_workers.py``'s ``subject_axis_worker``).

Each rank's result is held to the other rank's bit for bit, to the
port's single-process run and to the JAX package's single-process run
(no mesh, float64 under the harness's x64) computed in this process.
The estimators start from the JAX package's initial W, which this
module writes to an npz that the workers inject (JAX's PRNG has no
torch twin).  Tolerances: the solves in float64, 1e-10 against the
single-process port and JAX; the port's float32 fits against JAX's
float64 fits and against the single-process port, 2e-4 absolute (the
JAX package's ``mesh_atol`` in float32) on every fitted array, times
max(1, its largest entry), and 1e-4 relative on the objectives.
"""

import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu.funcalign import rsrm as jrsrm
from brainiak_tpu.funcalign import srm as jsrm
from brainiak_tpu_torch.funcalign import srm as tsrm
from brainiak_tpu_torch.ops import distla
from brainiak_tpu_torch.parallel.testing import run_distributed
from tests.conftest import REPO_ROOT
from tests.torch_dist_workers import (RSRM_GAMMA, SRM_FITS, W0_ENV,
                                      fitted, make_estimator, solve_inputs,
                                      srm_inputs)

#: the spawn's limit, far below the suite's
SPAWN_TIMEOUT = 120
SOLVE_ATOL = 1e-10
FIT_ATOL = 2e-4
OBJ_RTOL = 1e-4


def _jax_w0(name, X):
    stacked, vc, _, _ = jsrm._stack_and_pad(X, np.float64,
                                            demean=name == "SRM")
    return np.asarray(jsrm._init_w(
        jax.random.PRNGKey(0), stacked.shape[1], stacked.shape[0],
        SRM_FITS[name][1], jnp.asarray(vc.astype(np.float64)),
        dtype=jnp.float64))


@pytest.fixture(scope="module")
def w0s():
    return {name: _jax_w0(name, X) for name, X in srm_inputs().items()}


@pytest.fixture(scope="module")
def ranks(w0s):
    """Both ranks' results of the subject-axis worker (one spawn)."""
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "w0.npz")
    np.savez(path, **w0s)
    os.environ[W0_ENV] = path
    try:
        return run_distributed("tests.torch_dist_workers",
                               "subject_axis_worker", n_procs=2,
                               local_devices=2, timeout=SPAWN_TIMEOUT,
                               extra_path=REPO_ROOT)
    finally:
        del os.environ[W0_ENV]
        shutil.rmtree(tmp)


def _jax_fit(name):
    n_iter, features = SRM_FITS[name]
    X = srm_inputs()[name]
    if name == "RSRM":
        model = jrsrm.RSRM(n_iter=n_iter, features=features,
                           gamma=RSRM_GAMMA)
    else:
        model = getattr(jsrm, name)(n_iter=n_iter, features=features)
    return fitted(model.fit(X))


def _port_fit(name, w0, monkeypatch):
    monkeypatch.setattr(tsrm, "_init_w", lambda *a, device="cpu", **k:
                        torch.tensor(w0).float().to(device))
    return fitted(make_estimator(name).fit(srm_inputs()[name]))


def _close(got, want, what):
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        assert g.shape == w.shape, what
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() <= FIT_ATOL * scale, what


def _hold_fit(got, want):
    for key in ("w", "s_", "r_", "rho2_", "sigma_s_"):
        if key in want:
            _close(got[key], want[key], key)
    assert abs(got["objective"] - want["objective"]) <= \
        OBJ_RTOL * abs(want["objective"])


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _jax_solve(name, mats, rhs):
    m, r = jnp.asarray(mats), jnp.asarray(rhs)
    if name == "batched_eigh":
        return jax.vmap(jnp.linalg.eigh)(m)
    if name == "batched_cholesky_solve":
        return jax.vmap(lambda a, b: jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(a), b))(m, r)
    return jax.vmap(lambda a, b: (jnp.trace(a), a @ b))(m, r)


def _port_solve(name, mats, rhs):
    m, r = torch.from_numpy(mats), torch.from_numpy(rhs)
    if name == "batched_eigh":
        return distla.batched_eigh(m)
    if name == "batched_cholesky_solve":
        return distla.batched_cholesky_solve(m, r)
    return distla.shard_vmap(lambda a, b: (torch.trace(a), a @ b), None,
                             "subject", 8)(m, r)


def _signed(vecs):
    """Eigenvectors with the sign of each one's largest entry made
    positive (LAPACK builds may pick either sign)."""
    vecs = np.asarray(vecs)
    idx = np.abs(vecs).argmax(axis=-2)[..., None, :]
    return vecs * np.sign(np.take_along_axis(vecs, idx, axis=-2))


def _hold_solve(name, got, mats, rhs):
    single = _port_solve(name, mats, rhs)
    want = _jax_solve(name, mats, rhs)
    got = got if isinstance(got, tuple) else (got,)
    single = tuple(single) if isinstance(single, tuple) else (single,)
    want = tuple(want) if isinstance(want, tuple) else (want,)
    for i, (g, s, w) in enumerate(zip(got, single, want)):
        s, w = s.numpy(), np.asarray(w)
        if name == "batched_eigh" and i == 1:
            g, s, w = _signed(g), _signed(s), _signed(w)
        np.testing.assert_allclose(g, s, rtol=0, atol=SOLVE_ATOL)
        np.testing.assert_allclose(g, w, rtol=0, atol=SOLVE_ATOL)


def test_subject_mesh_spans_both_ranks(ranks):
    for pid, r in enumerate(ranks):
        assert r["pid"] == pid and r["ranks"] == [0, 0, 1, 1]


@pytest.mark.parametrize("name", ["SRM", "DetSRM", "RSRM", "batched_eigh",
                                  "batched_cholesky_solve", "shard_vmap"])
def test_subject_axis_across_processes(ranks, name):
    """No rank-partial result: every rank returns the whole fit, or
    the whole output of a solve given the whole batch, equal on both
    ranks, and held to the JAX package's single-process run."""
    _equal(ranks[0][name], ranks[1][name])
    if name in SRM_FITS:
        got = ranks[0][name]
        assert len(got["w"]) == len(srm_inputs()[name])
        _hold_fit(got, _jax_fit(name))
    else:
        _hold_solve(name, ranks[0][name], *solve_inputs())


@pytest.mark.parametrize("name", ["batched_eigh", "batched_cholesky_solve",
                                  "shard_vmap"])
def test_solves_keep_a_laid_out_batch(ranks, name):
    """Given a batch laid out along the subject axis, each rank maps
    only its own positions' pieces and the output keeps that layout;
    fetched, it is the whole batch's output."""
    assert [r[name + "_held"] for r in ranks] == [[0, 1], [2, 3]]
    _equal(ranks[0][name + "_laid"], ranks[1][name + "_laid"])
    _hold_solve(name, ranks[0][name + "_laid"], *solve_inputs())


def test_uneven_batch_takes_the_plain_vmap(ranks):
    mats, _ = solve_inputs()
    want = np.linalg.eigvalsh(mats[:6])
    for r in ranks:
        np.testing.assert_allclose(r["uneven"], want, rtol=0,
                                   atol=SOLVE_ATOL)


@pytest.mark.parametrize("name", ["SRM", "DetSRM", "RSRM"])
def test_fit_across_processes_matches_single_process_port(ranks, w0s,
                                                          name,
                                                          monkeypatch):
    _hold_fit(ranks[1][name], _port_fit(name, w0s[name], monkeypatch))


def test_checkpointed_fit_across_processes(ranks):
    """Every rank saves the whole EM state to the shared directory (the
    JAX package's semantic); a second fit resumes from it to the end;
    both equal the uncheckpointed fit over the ranks."""
    for r in ranks:
        assert r["ckpt_files"] and all(
            f.startswith("ckpt_") and f.endswith(".npz")
            for f in r["ckpt_files"])
        _hold_fit(r["ckpt_first"], r["SRM"])
        _equal(r["ckpt_resumed"]["w"], r["ckpt_first"]["w"])
        _equal(r["ckpt_resumed"]["s_"], r["ckpt_first"]["s_"])
    _equal(ranks[0]["ckpt_first"], ranks[1]["ckpt_first"])
