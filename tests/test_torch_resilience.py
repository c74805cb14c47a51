"""The port's resilience layer and checkpoint writer on the CPU: the
cases of ``tests/resilience/test_faults.py``, ``test_retry.py`` and
``test_guards.py`` that need neither jax nor an estimator not yet
ported, run on the port, and the port held to the JAX package.

Parity means: ``run_resilient_loop`` driven by the same NumPy chunk
ends in the same state and step, with the same sequence of event
names and fields (times and fit ids aside), in both packages; an npz
checkpoint either package writes, the other restores; the same
``array_digest``; and the same iterates from a device-carry chunk.
"""

import importlib
import os

import numpy as np
import pytest
import torch
from scipy import stats

from brainiak_tpu.obs import sink as jsink
from brainiak_tpu.resilience import faults as jfaults
from brainiak_tpu.resilience import guards as jguards
from brainiak_tpu.utils import checkpoint as jcheckpoint
from brainiak_tpu_torch.obs import progress as obs_progress
from brainiak_tpu_torch.obs import sink as obs_sink
from brainiak_tpu_torch.resilience import faults, guards
from brainiak_tpu_torch.resilience.faults import (InjectedIOError,
                                                  PreemptionError, inject)
from brainiak_tpu_torch.resilience.guards import (
    DivergenceError,
    FitParked,
    array_digest,
    check_state,
    make_device_carry_chunk,
    pack_rng_state,
    park_scope,
    run_resilient_loop,
    unpack_rng_state,
)
from brainiak_tpu_torch.resilience.retry import retry
from brainiak_tpu_torch.utils.checkpoint import CheckpointManager
from torch_obs_state import clean_obs  # noqa: F401

retry_mod = importlib.import_module("brainiak_tpu_torch.resilience.retry")
jretry_mod = importlib.import_module("brainiak_tpu.resilience.retry")

#: the two packages' loop modules, for the parity cases
LOOPS = {
    "torch": (guards, faults, obs_sink),
    "jax": (jguards, jfaults, jsink),
}


@pytest.fixture(autouse=True)
def _no_sleep(clean_obs, monkeypatch):  # noqa: F811
    """Record requested retry delays instead of sleeping."""
    delays = []
    monkeypatch.setattr(retry_mod, "_sleep", delays.append)
    monkeypatch.setattr(jretry_mod, "_sleep", lambda _d: None)
    monkeypatch.setattr(faults, "_env_fault", None)
    monkeypatch.setattr(faults, "_env_spec_seen", None)
    return delays


def _counting_chunk(state, step, n_steps):
    return {"x": np.asarray(state["x"]) + n_steps}, False


# -- faults ----------------------------------------------------------

def test_preempt_fires_at_step_crossing():
    with inject("preempt", at_step=3) as fault:
        faults.preempt_point(2)
        with pytest.raises(PreemptionError, match="step 4"):
            faults.preempt_point(4)
        assert fault.fired == 1
        faults.preempt_point(6)


def test_nan_corrupts_a_host_copy_of_the_first_float_leaf():
    state = {"count": np.arange(3), "w": np.ones(4), "b": np.ones(2)}
    with inject("nan", at_step=2) as fault:
        assert faults.corrupt_state(state, 1) is state
        out = faults.corrupt_state(state, 2)
        assert np.isnan(out["w"]).any()
        assert not np.isnan(state["w"]).any()
        assert fault.fired == 1


def test_nan_targets_named_leaf():
    state = {"a": np.ones(2), "b": np.ones(2)}
    with inject("nan", at_step=0, leaf="b"):
        out = faults.corrupt_state(state, 5)
    assert np.isnan(out["b"]).any() and not np.isnan(out["a"]).any()


def test_io_error_lets_through_at_step_calls():
    with inject("io_error", at_step=2, times=1) as fault:
        faults.io_point("f1")
        faults.io_point("f2")
        with pytest.raises(InjectedIOError):
            faults.io_point("f3")
        faults.io_point("f4")
        assert fault.fired == 1


def test_unknown_kind_rejected_and_jax_kinds_accepted():
    with pytest.raises(ValueError, match="unknown fault kind"):
        with inject("segfault"):
            pass
    assert faults.KINDS == jfaults.KINDS
    for kind in faults.KINDS:
        with inject(kind):
            pass


def test_io_error_consumed_by_checkpoint_retry(tmp_path):
    mngr = CheckpointManager(str(tmp_path / "ck"))
    with inject("io_error", times=1) as fault:
        mngr.save(1, {"x": np.ones(3)})
    assert fault.fired == 1
    step, state = mngr.restore()
    assert step == 1 and np.allclose(state["x"], 1.0)


def test_env_var_fault(monkeypatch):
    monkeypatch.setenv(faults.FAULT_ENV_VAR, "preempt@2")
    with pytest.raises(PreemptionError):
        faults.preempt_point(2)
    faults.preempt_point(5)  # fires once per process


def test_env_var_fault_with_times(monkeypatch):
    monkeypatch.setenv(faults.FAULT_ENV_VAR, "io_error@1x2")
    faults.io_point("a")
    for _ in range(2):
        with pytest.raises(InjectedIOError):
            faults.io_point("b")
    faults.io_point("c")


def test_env_var_malformed_ignored(monkeypatch):
    monkeypatch.setenv(faults.FAULT_ENV_VAR, "preempt@banana")
    faults.preempt_point(10)


# -- retry -----------------------------------------------------------

def test_retry_succeeds_after_transient_failures(_no_sleep):
    calls = {"n": 0}

    @retry(retries=3, backoff=0.5, jitter=0.0)
    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert flaky() == "ok"
    assert calls["n"] == 3
    assert _no_sleep == [0.5, 1.0]


def test_retry_exhausts_reraises_and_dumps(_no_sleep, tmp_path,
                                           monkeypatch):
    from brainiak_tpu_torch.obs import flight

    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    mem = obs_sink.add_sink(obs_sink.MemorySink())

    @retry(retries=2, backoff=0.0, jitter=0.0, name="unit.io")
    def always_fails():
        raise OSError("still down")

    with pytest.raises(OSError, match="still down"):
        always_fails()
    obs_sink.remove_sink(mem)
    names = [r["name"] for r in mem.records if r["kind"] == "event"]
    assert names == ["retry", "retry", "retry_exhausted", "flight_dump"]
    assert flight.last_dump()["trigger"] == "retry_exhausted"


def test_non_retriable_propagates_immediately(_no_sleep):
    calls = {"n": 0}

    @retry(retries=5, backoff=0.0)
    def typed_failure():
        calls["n"] += 1
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        typed_failure()
    assert calls["n"] == 1 and _no_sleep == []


def test_bare_decorator_form():
    @retry
    def fine(x):
        return x + 1

    assert fine(1) == 2


def test_inline_wrapper_form():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise ConnectionError("refused")
        return 7

    assert retry(flaky, retries=1, backoff=0.0,
                 retriable=(ConnectionError,))() == 7


def test_retry_if_predicate_gates_broad_types():
    calls = {"n": 0}

    @retry(retries=3, backoff=0.0, retriable=(RuntimeError,),
           retry_if=lambda e: "connect" in str(e))
    def deterministic_failure():
        calls["n"] += 1
        raise RuntimeError("already initialized")

    with pytest.raises(RuntimeError, match="already initialized"):
        deterministic_failure()
    assert calls["n"] == 1
    attempts = {"n": 0}

    @retry(retries=3, backoff=0.0, retriable=(RuntimeError,),
           retry_if=lambda e: "connect" in str(e))
    def transient_failure():
        attempts["n"] += 1
        if attempts["n"] < 2:
            raise RuntimeError("failed to connect to coordinator")
        return "up"

    assert transient_failure() == "up" and attempts["n"] == 2


def test_jitter_scales_delay(_no_sleep):
    @retry(retries=1, backoff=1.0, jitter=0.5)
    def flaky():
        if not _no_sleep:
            raise OSError("once")
        return True

    assert flaky()
    assert len(_no_sleep) == 1 and 1.0 <= _no_sleep[0] <= 1.5


# -- guards ----------------------------------------------------------

def test_check_state_passes_finite():
    check_state({"a": np.ones(3), "ints": np.arange(2),
                 "t": torch.ones(2), "ti": torch.arange(2)})


@pytest.mark.parametrize("as_tensor", [False, True])
def test_check_state_names_bad_leaves_and_iteration(as_tensor):
    wrap = torch.tensor if as_tensor else np.asarray
    state = {"good": wrap([1.0, 2.0]), "bad": wrap([1.0, np.nan]),
             "worse": wrap([np.inf])}
    with pytest.raises(DivergenceError) as exc:
        check_state(state, iteration=7, where="unit")
    assert exc.value.leaves == ["bad", "worse"]
    assert exc.value.iteration == 7
    assert "bad" in str(exc.value) and "iteration 7" in str(exc.value)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_check_state_skip_and_nan_only(as_tensor):
    wrap = torch.tensor if as_tensor else np.asarray
    state = {"hist": wrap([np.nan]), "ll": wrap([-np.inf])}
    check_state(state, skip=("hist",), nan_only=True)
    with pytest.raises(DivergenceError):
        check_state(state, skip=("hist",), nan_only=False)


def test_array_digest_distinguishes_zscored_data():
    rng = np.random.RandomState(0)
    a = stats.zscore(rng.randn(20, 30), axis=1, ddof=1)
    b = stats.zscore(rng.randn(20, 30), axis=1, ddof=1)
    da, db = array_digest(a), array_digest(b)
    assert abs(da - db) > 1e-6 * max(abs(da), abs(db))
    assert array_digest(a) == da


def test_array_digest_equals_jax_package():
    """Equal on the same data, given as arrays, float32 tensors or
    float64 tensors, to the JAX package's digest of the arrays."""
    rng = np.random.RandomState(1)
    x32 = rng.randn(12, 7).astype(np.float32)
    x64 = rng.randn(30)
    want = jguards.array_digest(x32, x64)
    assert array_digest(x32, x64) == want
    assert array_digest(torch.from_numpy(x32),
                        torch.from_numpy(x64)) == want


def test_rng_state_roundtrip():
    rng = np.random.RandomState(42)
    rng.randn(17)
    keys, meta = pack_rng_state(rng)
    expected = rng.randn(5)
    rng2 = unpack_rng_state(np.random.RandomState(0), keys, meta)
    assert np.allclose(rng2.randn(5), expected)
    jkeys, jmeta = jguards.pack_rng_state(
        unpack_rng_state(np.random.RandomState(0), keys, meta))
    assert np.array_equal(jkeys, keys) and np.array_equal(jmeta, meta)


def test_torch_generator_state_roundtrips_through_a_checkpoint(tmp_path):
    gen = torch.Generator().manual_seed(1234)
    torch.randn(17, generator=gen)
    keys, meta = pack_rng_state(gen)
    assert keys.dtype == np.uint8
    expected = torch.randn(5, generator=gen)
    mngr = CheckpointManager(str(tmp_path / "ck"))
    mngr.save(3, {"rng_keys": keys, "rng_meta": meta})
    _, saved = mngr.restore()
    fresh = unpack_rng_state(torch.Generator().manual_seed(0),
                             saved["rng_keys"], saved["rng_meta"])
    assert torch.equal(torch.randn(5, generator=fresh), expected)


def test_leaves_to_device_makes_new_tensors_and_refuses_cuda(monkeypatch):
    state = {"a": np.arange(3.0), "b": torch.ones(2, dtype=torch.float64)}
    a, b = guards.leaves_to_device(state, ("a", "b"), dtype=torch.float32,
                                   device="cpu")
    assert a.dtype == b.dtype == torch.float32
    a += 1
    assert state["a"][0] == 0.0  # a copy, not a view of the state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        guards.leaves_to_device(state, ("a",))


def test_loop_advances_in_chunks():
    state, step = run_resilient_loop(
        _counting_chunk, {"x": np.zeros(1)}, 7, checkpoint_every=3)
    assert step == 7 and state["x"][0] == 7.0


def test_loop_checkpoints_and_resumes(tmp_path):
    d = str(tmp_path / "ck")
    with inject("preempt", at_step=4):
        with pytest.raises(PreemptionError):
            run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 10,
                               checkpoint_dir=d, checkpoint_every=2)
    steps_run = []

    def tracked(state, step, n_steps):
        steps_run.append((step, n_steps))
        return _counting_chunk(state, step, n_steps)

    state, step = run_resilient_loop(
        tracked, {"x": np.zeros(1)}, 10, checkpoint_dir=d,
        checkpoint_every=2)
    assert steps_run[0][0] == 4
    assert step == 10 and state["x"][0] == 10.0


def test_loop_rejects_nonpositive_checkpoint_every():
    with pytest.raises(ValueError, match="checkpoint_every"):
        run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 4,
                           checkpoint_every=0)


def test_loop_fingerprint_mismatch_rejected(tmp_path):
    d = str(tmp_path / "ck")
    run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 2,
                       checkpoint_dir=d, fingerprint=np.array([1.0]))
    with pytest.raises(ValueError, match="different data"):
        run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 4,
                           checkpoint_dir=d, fingerprint=np.array([2.0]))


def test_loop_lower_budget_than_checkpoint_rejected(tmp_path):
    d = str(tmp_path / "ck")
    run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 6,
                       checkpoint_dir=d, checkpoint_every=3)
    with pytest.raises(ValueError, match="iteration"):
        run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 2,
                           checkpoint_dir=d)


def test_loop_rollback_recovers_from_transient_nan():
    with inject("nan", at_step=4) as fault:
        state, step = run_resilient_loop(
            _counting_chunk, {"x": np.zeros(1)}, 6, checkpoint_every=2)
    assert fault.fired == 1
    assert step == 6 and state["x"][0] == 6.0


def test_loop_aborts_after_consecutive_rollbacks():
    calls = []

    def diverging(state, step, n_steps):
        calls.append(step)
        return {"x": np.full(1, np.nan)}, False

    with pytest.raises(DivergenceError) as exc:
        run_resilient_loop(diverging, {"x": np.zeros(1)}, 4,
                           checkpoint_every=2, max_rollbacks=2,
                           name="unit")
    assert exc.value.leaves == ["x"]
    assert calls == [0, 0, 0]


def test_loop_done_flag_short_circuits():
    def converge_at_3(state, step, n_steps):
        x = float(np.asarray(state["x"])[0])
        for _ in range(n_steps):
            x += 1
            if x >= 3:
                return {"x": np.array([x]), "done": np.array(1.0)}, True
        return {"x": np.array([x]), "done": np.array(0.0)}, False

    state, step = run_resilient_loop(
        converge_at_3, {"x": np.zeros(1), "done": np.zeros(1)}, 10,
        checkpoint_every=2)
    assert state["x"][0] == 3.0 and step < 10


def test_loop_resume_of_done_state_skips(tmp_path):
    d = str(tmp_path / "ck")

    def instantly_done(state, step, n_steps):
        return {"x": np.asarray(state["x"]) + 1,
                "done": np.array(1.0)}, True

    run_resilient_loop(instantly_done,
                       {"x": np.zeros(1), "done": np.zeros(1)}, 10,
                       checkpoint_dir=d, checkpoint_every=2)

    def must_not_run(state, step, n_steps):  # pragma: no cover
        raise AssertionError("resumed-done loop must not re-run")

    state, _ = run_resilient_loop(
        must_not_run, {"x": np.zeros(1), "done": np.zeros(1)}, 10,
        checkpoint_dir=d, checkpoint_every=2)
    assert state["x"][0] == 1.0


def test_preempt_fires_only_after_save(tmp_path):
    d = str(tmp_path / "ck")
    with inject("preempt", at_step=2):
        with pytest.raises(PreemptionError):
            run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 6,
                               checkpoint_dir=d, checkpoint_every=2)
    step, state = CheckpointManager(d).restore()
    assert step == 2 and state["x"][0] == 2.0


def test_checkpoints_pruned_to_max_to_keep(tmp_path):
    d = str(tmp_path / "ck")
    run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 10,
                       checkpoint_dir=d, checkpoint_every=2)
    assert sorted(os.listdir(d)) == ["ckpt_10.npz", "ckpt_8.npz"]
    assert CheckpointManager(d).latest_step() == 10


def test_fit_id_and_wall_survive_preempt_resume(tmp_path):
    d = str(tmp_path / "ck")
    mem = obs_sink.add_sink(obs_sink.MemorySink())
    with inject("preempt", at_step=4):
        with pytest.raises(PreemptionError):
            run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 10,
                               checkpoint_dir=d, checkpoint_every=2)
    state, step = run_resilient_loop(
        _counting_chunk, {"x": np.zeros(1)}, 10, checkpoint_dir=d,
        checkpoint_every=2)
    obs_sink.remove_sink(mem)
    assert step == 10 and state["x"][0] == 10.0
    assert set(state) == {"x"}
    progress = [r for r in mem.records if r["kind"] == "progress"]
    assert len({r["fit_id"] for r in progress}) == 1
    assert [r["chunk"] for r in progress] == [1, 2, 3, 4, 5]
    walls = [r["fit_wall_s"] for r in progress]
    assert all(b > a for a, b in zip(walls, walls[1:]))
    (resume,) = [r for r in mem.records if r["name"] == "resume"]
    assert resume["fit_id"] == progress[0]["fit_id"]


def test_fresh_checkpoint_dir_mints_fresh_fit_id(tmp_path):
    mem = obs_sink.add_sink(obs_sink.MemorySink())
    for sub in ("a", "b"):
        run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 4,
                           checkpoint_dir=str(tmp_path / sub),
                           checkpoint_every=2)
    obs_sink.remove_sink(mem)
    assert len({r["fit_id"] for r in mem.records
                if r["kind"] == "progress"}) == 2


def test_divergence_abort_reports_fit_id_and_diverged_status(tmp_path,
                                                             monkeypatch):
    from brainiak_tpu_torch.obs import flight

    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    mem = obs_sink.add_sink(obs_sink.MemorySink())
    with inject("nan", at_step=2, times=10):
        with pytest.raises(DivergenceError):
            run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 6,
                               checkpoint_every=2, max_rollbacks=1)
    obs_sink.remove_sink(mem)
    (abort,) = [r for r in mem.records if r["name"] == "divergence_abort"]
    (snap,) = [s for s in obs_progress.active_fits()
               if s["fit_id"] == abort["fit_id"]]
    assert snap["status"] == "diverged" and snap["rollbacks"] == 2
    dump = flight.last_dump(fit_id=abort["fit_id"])
    assert dump["trigger"] == "divergence_abort"


def test_sanitizer_lane_rolls_back_a_non_finite_chunk(monkeypatch):
    """With ``BRAINIAK_TPU_SANITIZE=1`` a chunk whose output holds an
    Inf trips the sanitizer, which the loop rolls back like any other
    divergence; the chunk runs once a try."""
    monkeypatch.setenv("BRAINIAK_TPU_SANITIZE", "1")
    calls = []

    def planted_once(state, step, n_steps):
        calls.append(step)
        x = torch.as_tensor(state["x"]) + n_steps
        if len(calls) == 2:
            x[0] = float("inf")
        return {"x": x.numpy()}, False

    mem = obs_sink.add_sink(obs_sink.MemorySink())
    state, step = run_resilient_loop(planted_once, {"x": np.zeros(2)}, 6,
                                     checkpoint_every=2)
    obs_sink.remove_sink(mem)
    assert step == 6 and np.array_equal(state["x"], np.full(2, 6.0))
    assert calls == [0, 2, 2, 4]
    (rollback,) = [r for r in mem.records if r["name"] == "rollback"]
    assert rollback["attrs"]["leaves"][0].startswith("sanitizer:")
    assert len([r for r in mem.records if r["name"] == "sanitizer"]) == 1


def test_park_scope_parks_after_grant_and_resumes(tmp_path):
    d = str(tmp_path / "ck")
    chunks = {"n": 0}

    def two_chunk_grant():
        chunks["n"] += 1
        return chunks["n"] >= 2

    with park_scope(two_chunk_grant):
        with pytest.raises(FitParked) as excinfo:
            run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 10,
                               checkpoint_dir=d, checkpoint_every=2)
    assert excinfo.value.step == 4
    assert excinfo.value.fit_id is not None
    state, step = run_resilient_loop(
        _counting_chunk, {"x": np.zeros(1)}, 10, checkpoint_dir=d,
        checkpoint_every=2)
    assert step == 10 and state["x"][0] == 10.0


def test_park_scope_ignored_without_checkpoint_dir():
    with park_scope(lambda: True):
        state, step = run_resilient_loop(
            _counting_chunk, {"x": np.zeros(1)}, 4, checkpoint_every=2)
    assert step == 4 and state["x"][0] == 4.0


def test_park_scope_nests_and_restores(tmp_path):
    d = str(tmp_path / "ck")
    with park_scope(lambda: True):
        with park_scope(lambda: False):
            _, step = run_resilient_loop(
                _counting_chunk, {"x": np.zeros(1)}, 4,
                checkpoint_dir=d, checkpoint_every=2)
        assert step == 4
        with pytest.raises(FitParked):
            run_resilient_loop(_counting_chunk, {"x": np.zeros(1)}, 8,
                               checkpoint_dir=d, checkpoint_every=2)


def test_park_scope_predicate_exceptions_are_swallowed(tmp_path):
    def broken():
        raise RuntimeError("scheduler bug")

    with park_scope(broken):
        state, step = run_resilient_loop(
            _counting_chunk, {"x": np.zeros(1)}, 4,
            checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    assert step == 4 and state["x"][0] == 4.0


# -- the loop against the JAX package --------------------------------

def _power_chunk(state, step, n_steps):
    """A deterministic float64 host chunk: a few normalized power
    steps of a fixed matrix."""
    g = np.arange(1.0, 17.0).reshape(4, 4) / 10.0
    v = np.asarray(state["v"])
    for _ in range(n_steps):
        v = g @ v
        v = v / np.linalg.norm(v, axis=0)
    return {"v": v}, False


def _nan_chunk(state, step, n_steps):
    return {"v": np.full((4, 2), np.nan)}, False


def _events(records):
    """``(name, attrs)`` of each event, with the fields that differ
    between two runs (fit ids, seconds, paths) left out."""
    out = []
    for rec in records:
        if rec["kind"] != "event":
            continue
        attrs = {k: v for k, v in (rec.get("attrs") or {}).items()
                 if k not in ("seconds", "fit_wall_s", "path")}
        out.append((rec["name"], attrs))
    return out


def _run_case(case, pkg, tmp_path, monkeypatch):
    """One case of the loop in package ``pkg``: returns (outcome,
    final state, step, events)."""
    g, f, snk = LOOPS[pkg]
    monkeypatch.setenv("BRAINIAK_TPU_CHECKPOINT_NPZ", "1")
    d = str(tmp_path / pkg / "ck")
    init = {"v": np.eye(4, 2) + 0.5}
    kw = dict(checkpoint_dir=d, checkpoint_every=2, name="unit.fit")
    mem = snk.add_sink(snk.MemorySink())
    outcome, state, step = "ok", None, None
    try:
        if case == "plain":
            state, step = g.run_resilient_loop(_power_chunk, init, 8, **kw)
        elif case == "preempt_resume":
            with f.inject("preempt", at_step=4):
                try:
                    g.run_resilient_loop(_power_chunk, init, 8, **kw)
                except f.PreemptionError:
                    outcome = "preempted"
            state, step = g.run_resilient_loop(_power_chunk, init, 8, **kw)
        elif case == "nan_rollback":
            with f.inject("nan", at_step=4):
                state, step = g.run_resilient_loop(_power_chunk, init, 8,
                                                   **kw)
        elif case == "rollback_exhaustion":
            try:
                g.run_resilient_loop(_nan_chunk, init, 8, max_rollbacks=2,
                                     **kw)
            except g.DivergenceError as exc:
                outcome = ("diverged", exc.leaves, exc.iteration)
        elif case == "fingerprint_mismatch":
            g.run_resilient_loop(_power_chunk, init, 4,
                                 fingerprint=np.array([1.0, 2.0]), **kw)
            try:
                g.run_resilient_loop(_power_chunk, init, 8,
                                     fingerprint=np.array([1.0, 3.0]),
                                     **kw)
            except ValueError as exc:
                outcome = ("refused", "different data" in str(exc))
        elif case == "park":
            with g.park_scope(lambda: True):
                try:
                    g.run_resilient_loop(_power_chunk, init, 8, **kw)
                except g.FitParked as exc:
                    outcome = ("parked", exc.step, exc.name)
            state, step = g.run_resilient_loop(_power_chunk, init, 8, **kw)
    finally:
        snk.remove_sink(mem)
    return outcome, state, step, _events(mem.records)


@pytest.mark.parametrize("case", [
    "plain", "preempt_resume", "nan_rollback", "rollback_exhaustion",
    "fingerprint_mismatch", "park"])
def test_loop_matches_jax_package(case, tmp_path, monkeypatch):
    port = _run_case(case, "torch", tmp_path, monkeypatch)
    ref = _run_case(case, "jax", tmp_path, monkeypatch)
    assert port[0] == ref[0]
    assert port[2] == ref[2]
    if ref[1] is not None:
        assert set(port[1]) == set(ref[1]) == {"v"}
        assert np.array_equal(port[1]["v"], ref[1]["v"])
    assert port[3] == ref[3]
    assert len(port[3]) >= 2


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_npz_checkpoint_restores_across_packages(writer, tmp_path,
                                                 monkeypatch):
    """A checkpoint either package's loop writes, the other's loop
    resumes: the same step, state and fit_id."""
    monkeypatch.setenv("BRAINIAK_TPU_CHECKPOINT_NPZ", "1")
    reader = "jax" if writer == "torch" else "torch"
    d = str(tmp_path / "ck")
    fp = np.array([3.0, 1.5])
    g, f, _ = LOOPS[writer]
    with f.inject("preempt", at_step=4):
        with pytest.raises(f.PreemptionError):
            g.run_resilient_loop(_power_chunk, {"v": np.eye(4, 2) + 0.5},
                                 8, checkpoint_dir=d, checkpoint_every=2,
                                 fingerprint=fp)
    assert sorted(os.listdir(d)) == ["ckpt_2.npz", "ckpt_4.npz"]
    mngr = (CheckpointManager if reader == "torch"
            else jcheckpoint.CheckpointManager)(d)
    step, saved = mngr.restore()
    assert step == 4
    assert set(saved) == {"v", "fingerprint", "fit_id", "fit_wall"}
    g, _, snk = LOOPS[reader]
    mem = snk.add_sink(snk.MemorySink())
    steps = []

    def tracked(state, step, n_steps):
        steps.append(step)
        return _power_chunk(state, step, n_steps)

    state, step = g.run_resilient_loop(
        tracked, {"v": np.zeros((4, 2))}, 8, checkpoint_dir=d,
        checkpoint_every=2, fingerprint=fp)
    snk.remove_sink(mem)
    assert steps == [4, 6] and step == 8
    want, _ = g.run_resilient_loop(_power_chunk, {"v": np.eye(4, 2) + 0.5},
                                   8, checkpoint_every=2)
    assert np.array_equal(state["v"], want["v"])
    (resume,) = [r for r in mem.records if r["name"] == "resume"]
    assert resume["fit_id"] == bytes(saved["fit_id"].tolist()).decode()


def test_device_carry_chunk_matches_jax_iterates(monkeypatch):
    """``make_device_carry_chunk(device="cpu")`` with a torch chunk gives
    the JAX package's iterates with a jnp chunk of the same math, to
    1e-6, through a NaN rollback (which rebuilds the leaves from the
    host state)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    g = rng.randn(32, 32).astype(np.float32)
    g = (g @ g.T / 32).astype(np.float32)
    v0 = rng.randn(32, 4).astype(np.float32)
    tg = torch.from_numpy(g)
    jg = jnp.asarray(g)

    def torch_chunk(leaves, n_steps):
        (v,) = leaves
        for _ in range(n_steps):
            v = tg @ v
            v = v / torch.linalg.vector_norm(v, dim=0)
        return (v,)

    def jax_chunk(leaves, n_steps):
        (v,) = leaves
        for _ in range(n_steps):
            v = jg @ v
            v = v / jnp.linalg.norm(v, axis=0)
        return (v,)

    out = {}
    for name, chunk, kw in (
            ("torch", torch_chunk, {"device": "cpu",
                                    "dtype": torch.float32}),
            ("jax", jax_chunk, {"dtype": jnp.float32})):
        g_mod, f_mod, _ = LOOPS[name]
        run_chunk, final = g_mod.make_device_carry_chunk(
            chunk, ("v",), **kw)
        with f_mod.inject("nan", at_step=6):
            state, step = g_mod.run_resilient_loop(
                run_chunk, {"v": v0}, 12, checkpoint_every=3)
        (dev,) = final(state, step)
        out[name] = (state["v"], np.asarray(dev), step)
    assert out["torch"][2] == out["jax"][2] == 12
    assert out["torch"][0].dtype == np.float32
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], atol=1e-6)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], atol=1e-6)


def test_device_carry_chunk_reuses_carried_tensors():
    """Between chunks the device tensors are carried, not rebuilt from
    the host state; a step mismatch (rollback, resume) rebuilds."""
    seen, made = [], []

    def chunk(leaves, n_steps):
        seen.append(leaves[0])
        made.append(leaves[0] + n_steps)
        return (made[-1],)

    run_chunk, final = make_device_carry_chunk(chunk, ("x",),
                                               device="cpu")
    state, _ = run_chunk({"x": np.zeros(2)}, 0, 2)
    assert isinstance(state["x"], np.ndarray)
    run_chunk(state, 2, 2)
    assert seen[1] is made[0]
    assert final(None, 4)[0] is made[1]
    rebuilt = final({"x": np.ones(2)}, 3)[0]
    assert torch.equal(rebuilt, torch.ones(2, dtype=torch.float64))
    run_chunk({"x": np.full(2, 7.0)}, 1, 2)  # a rollback's step
    assert torch.equal(seen[2], torch.full((2,), 7.0,
                                           dtype=torch.float64))


# -- SRM and DetSRM under the resilient loop -------------------------
# The cases of tests/resilience/test_resume_parity.py and of the
# checkpoint tests of tests/funcalign/test_srm.py, on the port's
# estimators (float32 on the CPU).  One device and the same shapes give
# the same products, so a resumed or rolled-back fit is held to the
# uninterrupted one bit for bit.

def _srm_data(n_subjects=3, voxels=14, samples=20, features=3, seed=0):
    rng = np.random.RandomState(seed)
    shared = rng.randn(features, samples)
    X = []
    for _ in range(n_subjects):
        q, _ = np.linalg.qr(rng.randn(voxels, features))
        X.append(q @ shared + 0.1 * rng.randn(voxels, samples))
    return X


def _estimator(name, n_iter):
    from brainiak_tpu_torch.funcalign import srm
    return getattr(srm, name)(n_iter=n_iter, features=3, device="cpu")


def _assert_same_fit(a, b):
    for w0, w1 in zip(a.w_, b.w_):
        assert np.array_equal(w0, w1)
    assert np.array_equal(a.s_, b.s_)
    for name in ("rho2_", "sigma_s_", "logprob_", "objective_"):
        if hasattr(a, name):
            assert np.array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("name", ["SRM", "DetSRM"])
def test_srm_preempt_resume_is_bit_for_bit(tmp_path, name):
    X = _srm_data()

    def fit(d):
        return _estimator(name, 8).fit(X, checkpoint_dir=d,
                                       checkpoint_every=2)

    plain = _estimator(name, 8).fit(X)
    full = fit(str(tmp_path / "full"))
    d = str(tmp_path / "ck")
    with inject("preempt", at_step=4) as fault:
        with pytest.raises(PreemptionError):
            fit(d)
    assert fault.fired == 1
    assert any(f.endswith(".npz") for f in os.listdir(d))
    resumed = fit(d)
    _assert_same_fit(resumed, full)
    _assert_same_fit(resumed, plain)


@pytest.mark.parametrize("name", ["SRM", "DetSRM"])
def test_srm_nan_rollback_recovers(tmp_path, name):
    X = _srm_data()
    plain = _estimator(name, 8).fit(X)
    mem = obs_sink.add_sink(obs_sink.MemorySink())
    with inject("nan", at_step=4) as fault:
        recovered = _estimator(name, 8).fit(
            X, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    obs_sink.remove_sink(mem)
    assert fault.fired == 1
    rollbacks = [r for r in mem.records if r["name"] == "rollback"]
    assert len(rollbacks) == 1
    assert rollbacks[0]["attrs"]["to_step"] == 2
    _assert_same_fit(recovered, plain)


@pytest.mark.parametrize("name,leaf", [("SRM", "sigma_s"),
                                       ("DetSRM", "shared")])
def test_srm_persistent_nan_aborts_naming_leaf(tmp_path, name, leaf):
    X = _srm_data()
    with inject("nan", at_step=2, times=10, leaf=leaf):
        with pytest.raises(DivergenceError) as exc:
            _estimator(name, 8).fit(
                X, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    assert leaf in exc.value.leaves
    assert exc.value.where == name + ".fit"


@pytest.mark.parametrize("name", ["SRM", "DetSRM"])
def test_srm_checkpoint_resume(tmp_path, name):
    """The checkpointed fit is the plain fit, and a fit of 4 of 9
    iterations resumes to 9 rather than starting over."""
    X = _srm_data(n_subjects=4, voxels=20, samples=30)
    plain = _estimator(name, 9).fit(X)
    ckpt = _estimator(name, 9).fit(
        X, checkpoint_dir=str(tmp_path / "full"), checkpoint_every=4)
    _assert_same_fit(ckpt, plain)
    d = str(tmp_path / "partial")
    _estimator(name, 4).fit(X, checkpoint_dir=d, checkpoint_every=4)
    mem = obs_sink.add_sink(obs_sink.MemorySink())
    resumed = _estimator(name, 9).fit(X, checkpoint_dir=d,
                                      checkpoint_every=4)
    obs_sink.remove_sink(mem)
    resume = [r for r in mem.records if r["name"] == "resume"]
    assert len(resume) == 1 and resume[0]["attrs"]["step"] == 4
    _assert_same_fit(resumed, plain)


@pytest.mark.parametrize("name", ["SRM", "DetSRM"])
def test_srm_checkpoint_rejects_mismatched_data(tmp_path, name):
    X = _srm_data(n_subjects=4, voxels=20, samples=30)
    d = str(tmp_path / "ck")
    _estimator(name, 4).fit(X, checkpoint_dir=d)
    # different data of the same shape must be refused
    X2 = [x + 1.0 for x in X]
    with pytest.raises(ValueError, match="different data"):
        _estimator(name, 8).fit(X2, checkpoint_dir=d)
    # a lower n_iter than the checkpoint's step must be refused
    with pytest.raises(ValueError, match="iteration"):
        _estimator(name, 2).fit(X, checkpoint_dir=d)


def test_nan_reaches_a_transposed_leaf():
    """A leaf fetched from a transposed tensor (an F-ordered host view,
    as SRM's sigma_s is) is poisoned too."""
    leaf = torch.arange(9.0).reshape(3, 3).T.numpy()
    assert not leaf.flags["C_CONTIGUOUS"]
    with inject("nan", leaf="s"):
        out = faults.corrupt_state({"s": leaf}, 1)
    assert np.isnan(out["s"]).sum() == 1 and np.isnan(out["s"][0, 0])
    assert not np.isnan(leaf).any()


# -- RSRM and FastSRM under the resilient loop ------------------------
# The RSRM and FastSRM cases of tests/resilience/test_resume_parity.py
# on the port's estimators (float32 on the CPU), bit for bit.

def _rsrm(n_iter=8):
    from brainiak_tpu_torch.funcalign.rsrm import RSRM
    return RSRM(n_iter=n_iter, features=3, gamma=1.0, device="cpu")


def _assert_same_rsrm(a, b):
    for w0, w1 in zip(a.w_, b.w_):
        assert np.array_equal(w0, w1)
    for s0, s1 in zip(a.s_, b.s_):
        assert np.array_equal(s0, s1)
    assert np.array_equal(a.r_, b.r_)
    assert a.objective_ == b.objective_


def test_rsrm_preempt_resume_is_bit_for_bit(tmp_path):
    X = _srm_data()

    def fit(d):
        return _rsrm().fit(X, checkpoint_dir=d, checkpoint_every=2)

    plain = _rsrm().fit(X)
    _assert_same_rsrm(fit(str(tmp_path / "full")), plain)
    d = str(tmp_path / "ck")
    with inject("preempt", at_step=4) as fault:
        with pytest.raises(PreemptionError):
            fit(d)
    assert fault.fired == 1
    _assert_same_rsrm(fit(d), plain)


def test_rsrm_nan_rollback_recovers(tmp_path):
    X = _srm_data()
    plain = _rsrm().fit(X)
    mem = obs_sink.add_sink(obs_sink.MemorySink())
    with inject("nan", at_step=4, leaf="s") as fault:
        recovered = _rsrm().fit(X, checkpoint_dir=str(tmp_path / "ck"),
                                checkpoint_every=2)
    obs_sink.remove_sink(mem)
    assert fault.fired == 1
    rollbacks = [r for r in mem.records if r["name"] == "rollback"]
    assert len(rollbacks) == 1 and rollbacks[0]["attrs"]["to_step"] == 2
    _assert_same_rsrm(recovered, plain)


def test_rsrm_fingerprint_holds_gamma(tmp_path):
    """A checkpoint of one gamma is not resumed by a fit of another."""
    from brainiak_tpu_torch.funcalign.rsrm import RSRM

    X = _srm_data()
    d = str(tmp_path / "ck")
    _rsrm(4).fit(X, checkpoint_dir=d, checkpoint_every=2)
    with pytest.raises(ValueError):
        RSRM(n_iter=8, features=3, gamma=0.5, device="cpu").fit(
            X, checkpoint_dir=d, checkpoint_every=2)


def test_fastsrm_preempt_resume_is_bit_for_bit(tmp_path):
    from brainiak_tpu_torch.funcalign.fastsrm import FastSRM

    rng = np.random.RandomState(1)
    shared = rng.randn(4, 30)
    imgs = [np.linalg.qr(rng.randn(25, 4))[0] @ shared
            + 0.05 * rng.randn(25, 30) for _ in range(3)]

    def make():
        return FastSRM(n_components=3, n_iter=10, aggregate=None,
                       device="cpu")

    def fit(d):
        return make().fit(imgs, checkpoint_dir=d, checkpoint_every=3)

    plain = make().fit(imgs)
    d = str(tmp_path / "ck")
    with inject("preempt", at_step=6) as fault:
        with pytest.raises(PreemptionError):
            fit(d)
    assert fault.fired == 1
    assert os.listdir(os.path.join(d, "reduced_srm"))
    resumed = fit(d)
    for b0, b1 in zip(plain.basis_list, resumed.basis_list):
        assert np.array_equal(b0, b1)
