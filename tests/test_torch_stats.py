"""The port's resampling statistics against the JAX package on the CPU.

``brainiak_tpu_torch.stats`` (the engine, its accumulator, the surrogate
families), ``ops.stats`` and the four ``*_isc`` nulls of
``brainiak_tpu_torch.isc`` run on ``device="cpu"``, the JAX package
with x64 on, as the harness sets it.  Tolerances:

- exact tests (every sign flip of 5 subjects, every shuffle of 6):
  observed, p and the whole null equal the JAX package's, exactly for
  medians and within 1e-12 for means (arctanh / tanh in another
  library);
- the sampled families, each on the JAX package's own descriptors
  (re-drawn from its keys as its programs draw them): 1e-12 for the
  ISC-input families (float64), 1e-5 for the shift families (the port
  runs them in float32, the JAX package here in float64);
- public p-values of sampled tests: other draws, so within a Monte
  Carlo band of four standard errors plus two counts;
- within the port, counted and materialized p-maps, chunked, resumed,
  merged and meshed runs: bit for bit.
"""

import itertools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainiak_tpu import isc as jisc
from brainiak_tpu.ops import stats as jops_stats
from brainiak_tpu.stats import accum as jaccum
from brainiak_tpu.stats import engine as jengine
from brainiak_tpu.stats import pvalues as jpvalues
from brainiak_tpu.stats import surrogates as jsur
from brainiak_tpu_torch import isc as tisc
from brainiak_tpu_torch import stats as tstats
from brainiak_tpu_torch.ops import stats as tops_stats
from brainiak_tpu_torch.parallel import make_mesh
from brainiak_tpu_torch.stats import engine as tengine
from brainiak_tpu_torch.stats import pvalues as tpvalues
from brainiak_tpu_torch.stats import surrogates as tsur
from brainiak_tpu_torch.stats.accum import NullAccumulator
from torch_obs_state import clean_obs  # noqa: F401

SEED = 42
ISC_TOL = 1e-12
SHIFT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def simulated_timeseries(n_subjects, n_TRs, n_voxels=30, noise=1.0,
                         random_state=None):
    """Shared signal + independent noise per subject -> [T, V, S]."""
    prng = np.random.RandomState(random_state)
    signal = prng.randn(n_TRs, n_voxels)
    return np.dstack([signal + prng.randn(n_TRs, n_voxels) * noise
                      for _ in range(n_subjects)])


def correlated_timeseries(n_subjects, n_TRs, noise=0.0, random_state=None):
    """3 voxels: first two share a signal, third is independent noise."""
    prng = np.random.RandomState(random_state)
    signal = prng.randn(n_TRs)
    data = np.repeat(np.column_stack((signal, signal))[..., np.newaxis],
                     n_subjects, axis=2)
    uncorrelated = prng.randn(n_TRs, 1, n_subjects)
    data = np.concatenate((data, uncorrelated), axis=1)
    return data + prng.randn(n_TRs, 3, n_subjects) * noise


def _p_reference(observed, distribution, side, exact):
    """The brainiak convention from scratch: exact tests divide raw
    counts by n; sampled tests add the observed value to both the
    numerator and the denominator."""
    observed = np.asarray(observed, dtype=np.float64)
    distribution = np.asarray(distribution, dtype=np.float64)
    n = distribution.shape[0]
    if side == 'right':
        numerator = np.sum(distribution >= observed, axis=0)
    elif side == 'left':
        numerator = np.sum(distribution <= observed, axis=0)
    else:
        numerator = np.sum(np.abs(distribution) >= np.abs(observed),
                           axis=0)
    if exact:
        return numerator / n
    return (numerator + 1) / (n + 1)


def _mc_band(p_got, p_want, n):
    """Two sampled p-maps of ``n`` resamples each agree within four
    standard errors of their difference plus two counts."""
    p_got, p_want = np.asarray(p_got), np.asarray(p_want)
    p = (p_got + p_want) / 2
    band = 4 * np.sqrt(2 * p * (1 - p) / n) + 2 / (n + 1)
    assert np.all(np.abs(p_got - p_want) <= band), \
        np.max(np.abs(p_got - p_want) - band)


# ---------------------------------------------------------------------------
# p-values and the accumulator (NumPy copies)

def test_p_from_null_pins_plus_one_convention():
    rng = np.random.RandomState(0)
    observed = rng.randn(7)
    distribution = rng.randn(100, 7)
    for side in ('right', 'left', 'two-sided'):
        for exact in (False, True):
            got = tpvalues.p_from_null(observed, distribution, side=side,
                                       exact=exact, axis=0)
            assert np.array_equal(
                got, _p_reference(observed, distribution, side, exact))
            assert np.array_equal(got, jpvalues.p_from_null(
                observed, distribution, side=side, exact=exact, axis=0))


def test_pvalue_names_share_one_implementation():
    assert tisc.compute_summary_statistic is \
        tpvalues.compute_summary_statistic
    assert tstats.p_from_null is tpvalues.p_from_null
    assert tstats.compute_summary_statistic is \
        tpvalues.compute_summary_statistic


def test_p_from_counts_matches_exceedance_counts():
    rng = np.random.RandomState(1)
    observed = rng.randn(5)
    distribution = rng.randn(64, 5)
    ge, le, abs_ge = tpvalues.exceedance_counts(observed, distribution)
    for side, numerator in (('right', ge), ('left', le),
                            ('two-sided', abs_ge)):
        for exact in (False, True):
            assert np.array_equal(
                tpvalues.p_from_counts(numerator, 64, exact=exact),
                _p_reference(observed, distribution, side, exact))


@pytest.mark.parametrize("side", ["two-sided", "left", "right"])
@pytest.mark.parametrize("exact", [False, True])
def test_ops_p_from_null_on_tensors(side, exact):
    rng = np.random.RandomState(2)
    observed = rng.randn(6)
    distribution = rng.randn(40, 6)
    got = tops_stats.p_from_null(torch.as_tensor(observed),
                                 torch.as_tensor(distribution), side=side,
                                 exact=exact)
    want = jops_stats.p_from_null(jnp.asarray(observed),
                                  jnp.asarray(distribution), side=side,
                                  exact=exact)
    # XLA divides by a constant through its reciprocal: the last ulp
    assert np.array_equal(got.numpy(), _p_reference(
        observed, distribution, side, exact))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
    with pytest.raises(ValueError):
        tops_stats.p_from_null(torch.as_tensor(observed),
                               torch.as_tensor(distribution), side="up")


def test_accumulator_reproduces_p_from_null_bitwise():
    rng = np.random.RandomState(2)
    observed = rng.randn(6)
    distribution = rng.randn(90, 6)
    distribution[13:40, 2] = np.nan
    acc = NullAccumulator(observed, 90, shape=(6,))
    for lo, hi in ((0, 17), (17, 64), (64, 90)):
        acc.update(distribution[lo:hi], (lo, hi))
    assert acc.complete
    for side in ('right', 'left', 'two-sided'):
        for exact in (False, True):
            assert np.array_equal(
                acc.p_values(side=side, exact=exact),
                tpvalues.p_from_null(observed, distribution, side=side,
                                     exact=exact, axis=0)), (side, exact)


def test_accumulator_merge_exact_through_both_wire_formats(tmp_path):
    rng = np.random.RandomState(3)
    observed = rng.randn(5)
    distribution = rng.randn(120, 5)
    full = NullAccumulator(observed, 120, shape=(5,))
    full.update(distribution, (0, 120))
    a = NullAccumulator(observed, 120, shape=(5,))
    a.update(distribution[:50], (0, 50))
    b = NullAccumulator(observed, 120, shape=(5,))
    b.update(distribution[50:], (50, 120))
    a = NullAccumulator.from_json(a.to_json())
    path = os.path.join(str(tmp_path), "half_b.npz")
    b.save(path)
    b = NullAccumulator.load(path)
    merged = a.merge(b)
    assert merged.complete
    for side in ('right', 'left', 'two-sided'):
        assert np.array_equal(merged.p_values(side=side),
                              full.p_values(side=side))
    for q in (0.025, 0.5, 0.975):
        assert np.array_equal(merged.quantile(q), full.quantile(q))
    assert merged.fwer_threshold() == full.fwer_threshold()
    assert merged.fdr_threshold() == full.fdr_threshold()
    # moments are float sums in another order: the last ulp may move
    assert np.allclose(merged.mean(), full.mean(), rtol=1e-12)
    assert np.allclose(merged.variance(), full.variance(), rtol=1e-12)


def test_accumulator_rejects_overlap_and_config_mismatch():
    rng = np.random.RandomState(4)
    observed = rng.randn(3)
    a = NullAccumulator(observed, 20, shape=(3,))
    a.update(rng.randn(10, 3), (0, 10))
    b = NullAccumulator(observed, 20, shape=(3,))
    b.update(rng.randn(10, 3), (5, 15))
    with pytest.raises(ValueError, match="overlap"):
        a.merge(b)
    c = NullAccumulator(observed, 21, shape=(3,))
    with pytest.raises(ValueError, match="configurations"):
        a.merge(c)
    with pytest.raises(ValueError, match="already accumulated"):
        a.update(rng.randn(5, 3), (5, 10))


@pytest.mark.parametrize("fmt", ["npz", "json"])
def test_jax_saved_accumulator_loads_and_merges(tmp_path, fmt):
    """The wire format is plain NumPy: a half the JAX package saves
    loads in the port and merges with the port's other half to the
    verdicts of one full run, and the reverse."""
    rng = np.random.RandomState(5)
    observed = rng.randn(7)
    center = 0.1 * rng.randn(7)
    distribution = rng.randn(80, 7)
    full = NullAccumulator(observed, 80, center=center, shape=(7,))
    full.update(distribution, (0, 80))
    j_half = jaccum.NullAccumulator(observed, 80, center=center,
                                    shape=(7,))
    j_half.update(distribution[:30], (0, 30))
    t_half = NullAccumulator(observed, 80, center=center, shape=(7,))
    t_half.update(distribution[30:], (30, 80))
    if fmt == "npz":
        path = os.path.join(str(tmp_path), "jax_half.npz")
        j_half.save(path)
        loaded = NullAccumulator.load(path)
        path = os.path.join(str(tmp_path), "port_half.npz")
        t_half.save(path)
        back = jaccum.NullAccumulator.load(path)
    else:
        loaded = NullAccumulator.from_json(j_half.to_json())
        back = jaccum.NullAccumulator.from_json(t_half.to_json())
    merged = loaded.merge(t_half)
    assert merged.complete
    for side in ('right', 'left', 'two-sided'):
        assert np.array_equal(merged.p_values(side=side),
                              full.p_values(side=side))
    assert np.array_equal(merged.ci(95)[0], full.ci(95)[0])
    assert merged.fwer_threshold() == full.fwer_threshold()
    j_merged = back.merge(j_half)
    assert np.array_equal(j_merged.p_values(), full.p_values())


def test_fdr_threshold_matches_jax():
    rng = np.random.RandomState(6)
    p = rng.rand(200) ** 3
    for alpha in (0.01, 0.05, 0.2):
        assert tstats.fdr_threshold(p, alpha) == \
            jaccum.fdr_threshold(p, alpha)


# ---------------------------------------------------------------------------
# the fold on the device against the host update

@pytest.mark.parametrize("center", [False, True])
def test_chunk_fold_equals_host_update(center):
    """The engine's fold (tensors) adds the counts and histograms the
    host ``NullAccumulator.update`` adds, bit for bit, chunk after
    chunk; the moments agree to rounding."""
    rng = np.random.RandomState(7)
    observed = 0.3 * rng.randn(9)
    cen = 0.2 * rng.randn(9) if center else None
    values = 0.5 * rng.randn(60, 9)
    values[5:9, 3] = np.nan
    values[11, :] = 0.0
    values[12, 4] = 3e-6
    values[13, 5] = 20.0
    host = NullAccumulator(observed, 60, center=cen, shape=(9,))
    fold = tengine._ChunkFold(host, torch.device("cpu"))
    state = fold.zeros(NullAccumulator(observed, 60, center=cen,
                                       shape=(9,)).to_state())
    for lo, hi in ((0, 16), (16, 32), (32, 60)):
        host.update(values[lo:hi], (lo, hi))
        state = fold.fold(state, torch.as_tensor(values[lo:hi]), lo, hi)
    got = NullAccumulator.from_state(
        {k: tengine._host(v) for k, v in state.items()})
    want = host.to_state()
    for key, leaf in got.to_state().items():
        if key in ("sum", "sumsq"):
            np.testing.assert_allclose(leaf, want[key], rtol=1e-13)
        else:
            assert np.array_equal(leaf, want[key], equal_nan=True), key
    with pytest.raises(ValueError, match="already accumulated"):
        fold.fold(state, torch.as_tensor(values[:4]), 0, 4)


# ---------------------------------------------------------------------------
# the engine

def test_engine_chunk_invariance_bitwise():
    rng = np.random.RandomState(5)
    iscs = 0.2 + 0.1 * rng.randn(10, 4)
    kwargs = dict(statistic="median", side="two-sided", seed=11,
                  return_distribution=True)
    one = tstats.NullEngine(null_batch_size=16, device="cpu").run(
        iscs, "subject_bootstrap", 48, **kwargs)
    many = tstats.NullEngine(null_batch_size=16, budget_bytes=1,
                             device="cpu").run(
        iscs, "subject_bootstrap", 48, **kwargs)
    assert np.array_equal(one.distribution, many.distribution,
                          equal_nan=True)
    assert np.array_equal(one.p_values(), many.p_values())


def test_engine_population_scale_chunked_run_and_resume(tmp_path):
    """20,000 resamples under a 64 KiB budget (the materialized null
    cannot fit it, so the run chunks: 40 chunks), and an injected
    preemption mid-run resumes from the checkpoint to the same p-map,
    bit for bit."""
    from brainiak_tpu_torch.resilience import faults

    rng = np.random.RandomState(6)
    iscs = 0.2 + 0.1 * rng.randn(12, 8)
    n_resamples, budget = 20000, 64 * 1024
    assert n_resamples * iscs.shape[1] * 8 > budget
    kwargs = dict(statistic="median", side="right", seed=7)
    engine = tstats.NullEngine(null_batch_size=64, budget_bytes=budget,
                               device="cpu")
    full = engine.run(iscs, "subject_bootstrap", n_resamples, **kwargs)
    assert full.n == n_resamples
    ckpt = os.path.join(str(tmp_path), "ckpt")
    with pytest.raises(faults.PreemptionError):
        with faults.inject("preempt", at_step=3):
            engine.run(iscs, "subject_bootstrap", n_resamples,
                       checkpoint_dir=ckpt, **kwargs)
    resumed = engine.run(iscs, "subject_bootstrap", n_resamples,
                         checkpoint_dir=ckpt, **kwargs)
    assert np.array_equal(resumed.p_values(), full.p_values())
    assert np.array_equal(resumed.observed, full.observed)
    assert resumed.fwer_threshold() == full.fwer_threshold()
    assert np.array_equal(resumed.ci(95)[1], full.ci(95)[1])


def test_engine_resumes_a_materialized_shift_null(tmp_path):
    """A preempted ``return_distribution=True`` run of a shift family
    resumes to the uninterrupted null, bit for bit."""
    from brainiak_tpu_torch.resilience import faults

    data = simulated_timeseries(5, 24, 6, random_state=3)
    kwargs = dict(statistic="median", side="right", seed=3,
                  return_distribution=True)
    engine = tstats.NullEngine(null_batch_size=4, budget_bytes=16 * 6 * 8,
                               device="cpu")
    full = engine.run(data, "phase_randomize", 40, **kwargs)
    ckpt = os.path.join(str(tmp_path), "ckpt")
    with pytest.raises(faults.PreemptionError):
        with faults.inject("preempt", at_step=2):
            engine.run(data, "phase_randomize", 40, checkpoint_dir=ckpt,
                       **kwargs)
    resumed = engine.run(data, "phase_randomize", 40,
                         checkpoint_dir=ckpt, **kwargs)
    assert np.array_equal(resumed.distribution, full.distribution)
    assert np.array_equal(resumed.p_values(), full.p_values())


@pytest.mark.parametrize("family", ["subject_bootstrap",
                                    "circular_timeshift"])
def test_engine_disjoint_ranges_pool_exactly(family):
    rng = np.random.RandomState(7)
    data = 0.2 + 0.1 * rng.randn(9, 5) if family == "subject_bootstrap" \
        else simulated_timeseries(5, 20, 5, random_state=7)
    kwargs = dict(statistic="median", side="two-sided", seed=13,
                  return_distribution=True)
    engine = tstats.NullEngine(null_batch_size=16, device="cpu")
    full = engine.run(data, family, 64, **kwargs)
    lo = engine.run(data, family, 64, index_range=(0, 24), **kwargs)
    hi = engine.run(data, family, 64, index_range=(24, 64), **kwargs)
    assert lo.n == 24 and hi.n == 40 and not lo.complete
    pooled = lo.merge(hi)
    assert pooled.complete
    assert np.array_equal(pooled.p_values(), full.p_values())
    assert np.array_equal(pooled.ci(95)[0], full.ci(95)[0])
    assert pooled.fwer_threshold() == full.fwer_threshold()
    assert np.array_equal(pooled.distribution, full.distribution)


def test_engine_emits_chunk_spans_and_counter(clean_obs):  # noqa: F811
    """Each chunk runs under a ``stats.chunk`` span with its family and
    resample range, and ``stats_surrogates_total`` counts the
    resamples, as the JAX package's engine reports them."""
    from brainiak_tpu_torch.obs import metrics, sink

    iscs = 0.2 + 0.1 * np.random.RandomState(14).randn(8, 4)
    mem = sink.add_sink(sink.MemorySink())
    tstats.NullEngine(null_batch_size=16, budget_bytes=16 * 4 * 16,
                      device="cpu").run(iscs, "sign_flip", 40, seed=3)
    sink.remove_sink(mem)
    spans = [r["attrs"] for r in mem.records
             if r["kind"] == "span" and r["name"] == "stats.chunk"]
    assert [(a["family"], a["lo"], a["hi"]) for a in spans] == [
        ("sign_flip", 0, 16), ("sign_flip", 16, 32),
        ("sign_flip", 32, 40)]
    assert metrics.counter("stats_surrogates_total").value(
        family="sign_flip") == 40


def test_exact_sign_flip_matches_itertools_brute_force():
    rng = np.random.RandomState(8)
    iscs = 0.2 + 0.3 * rng.randn(4, 3)
    engine = tstats.NullEngine(null_batch_size=16, device="cpu")
    res = engine.run(iscs, "sign_flip", 16, statistic="median",
                     side="two-sided", return_distribution=True)
    assert res.exact and res.n == 16
    brute = np.stack([
        np.median(np.asarray(signs)[:, None] * iscs, axis=0)
        for signs in itertools.product((1.0, -1.0), repeat=4)])
    assert np.array_equal(np.sort(res.distribution, axis=0),
                          np.sort(brute, axis=0))
    want = _p_reference(res.observed, brute, 'two-sided', True)
    assert np.array_equal(res.p_values(), want)


def test_engine_runs_every_family():
    rng = np.random.RandomState(9)
    iscs = 0.2 + 0.1 * rng.randn(8, 4)
    data = rng.randn(24, 4, 6)
    group = [0] * 3 + [1] * 5
    engine = tstats.NullEngine(null_batch_size=16, device="cpu")
    runs = {
        "subject_bootstrap": (iscs, {}),
        "sign_flip": (iscs, {}),
        "group_shuffle": (iscs, {"group_assignment": group}),
        "circular_timeshift": (data, {}),
        "phase_randomize": (data, {}),
    }
    assert set(runs) == set(tstats.FAMILIES) == set(tstats.TRANSFORMS)
    for family, (payload, extra) in runs.items():
        res = engine.run(payload, family, 24, statistic="median",
                         side="two-sided", seed=1, **extra)
        p = res.p_values()
        assert p.shape == (4,)
        assert np.all((p > 0.0) & (p <= 1.0)), family
        assert res.family == family
        assert set(res.thresholds) == {"fwer_0.05", "fdr_0.05",
                                       "fwer_0.01", "fdr_0.01"}
    with pytest.raises(ValueError, match="Unknown surrogate family"):
        engine.run(iscs, "bogus", 8)
    with pytest.raises(ValueError, match="index_range"):
        engine.run(iscs, "sign_flip", 8, seed=1, index_range=(4, 40))


def test_default_null_batch_unified():
    sizes = [tstats.default_null_batch(v)
             for v in (1, 64, 1024, 1 << 20)]
    for batch in sizes:
        assert batch in (16, 32, 64)
    assert sizes == sorted(sizes, reverse=True)
    for v in (None, 1, 5000, 1 << 16, 300 * 65536 * 20):
        assert tstats.default_null_batch(v) == \
            jengine.default_null_batch(v)


def test_stats_budget_env_override(monkeypatch):
    monkeypatch.setenv("BRAINIAK_TPU_STATS_BUDGET_BYTES", "12345")
    assert tstats.stats_budget_bytes() == 12345
    monkeypatch.delenv("BRAINIAK_TPU_STATS_BUDGET_BYTES")
    assert tstats.stats_budget_bytes() == (1 << 28)
    assert tstats.stats_budget_bytes() == tengine.DEFAULT_BUDGET_BYTES


def test_stats_exports_match_jax():
    from brainiak_tpu import stats as jstats
    assert tstats.__all__ == jstats.__all__
    for name in jstats.__all__:
        assert getattr(tstats, name) is not None
    assert tsur.FAMILIES == jsur.FAMILIES
    assert tsur.ISC_INPUT_FAMILIES == jsur.ISC_INPUT_FAMILIES
    assert set(tisc.__all__) == set(jisc.__all__)
    with pytest.raises(AttributeError):
        tstats.no_such_name


# ---------------------------------------------------------------------------
# ops.stats.phase_randomize

def test_phase_randomize_matches_jax_on_its_angles():
    """On the angles the JAX op draws from its key, the port's
    rfft/irfft rotation equals the JAX op's fft/ifft one."""
    rng = np.random.RandomState(10)
    for n_trs, voxelwise in ((25, True),):
        data = rng.randn(n_trs, 4, 3)
        key = jax.random.PRNGKey(3)
        want = np.asarray(jops_stats.phase_randomize(
            key, jnp.asarray(data), voxelwise=voxelwise))
        n_pos = tops_stats.n_positive_bins(n_trs)
        angles = np.asarray(jax.random.uniform(
            key, (n_pos, 4 if voxelwise else 1, 3),
            dtype=jnp.float64)) * 2 * np.pi
        got = tops_stats.phase_randomize(torch.as_tensor(data),
                                         torch.as_tensor(angles))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    # the power spectrum is kept; a 2-D input is one voxel
    g = torch.Generator().manual_seed(0)
    x = torch.as_tensor(rng.randn(30, 5))
    out = tops_stats.phase_randomize(x, generator=g)
    assert out.shape == x.shape
    np.testing.assert_allclose(np.abs(np.fft.fft(out.numpy(), axis=0)),
                               np.abs(np.fft.fft(x.numpy(), axis=0)),
                               atol=1e-10)
    with pytest.raises(ValueError):
        tops_stats.phase_randomize(x)


def test_percentiles_are_numpys():
    """The device percentiles the bootstrap CI reads equal NumPy's
    linear percentiles bit for bit, NaN columns and the ends
    included."""
    rng = np.random.RandomState(12)
    for n in (1, 2, 7, 400):
        x = rng.randn(n, 6)
        x[:, 4] = x[0, 4]
        if n > 2:
            x[1, 2] = np.nan
        qs = (0.0, 2.5, 25.0, 50.0, 97.5, 99.9, 100.0)
        got = tops_stats.percentiles(torch.as_tensor(x), qs)
        for q, g in zip(qs, got):
            assert np.array_equal(g, np.percentile(x, q, axis=0),
                                  equal_nan=True), (n, q)


def test_wrapper_p_and_ci_are_the_host_conventions():
    """The materialized wrappers read p and the CI on the device; they
    are p_from_null's and np.percentile's on the returned null."""
    rng = np.random.RandomState(13)
    iscs = 0.2 + 0.1 * rng.randn(9, 5)
    obs, ci, p, dist = tisc.bootstrap_isc(iscs, n_bootstraps=64,
                                          random_state=1, device="cpu")
    assert np.array_equal(ci[0], np.percentile(dist, 2.5, axis=0))
    assert np.array_equal(ci[1], np.percentile(dist, 97.5, axis=0))
    assert np.array_equal(p, tpvalues.p_from_null(
        obs, dist - obs, side="right", exact=False, axis=0))
    obs, p, dist = tisc.permutation_isc(iscs, n_permutations=64,
                                        random_state=1, side="two-sided",
                                        device="cpu")
    assert np.array_equal(p, tpvalues.p_from_null(
        obs, dist, side="two-sided", exact=False, axis=0))


# ---------------------------------------------------------------------------
# each family on the JAX package's descriptors

def _keys(seed, n):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _jax_descriptors(family, keys, n_subjects, n_trs=None, dtype=None):
    if family == "sign_flip":
        return np.stack([np.asarray(jax.random.choice(
            k, jnp.asarray([-1.0, 1.0], dtype=dtype), (n_subjects,)))
            for k in keys])
    if family == "group_shuffle":
        return np.stack([np.asarray(jax.random.permutation(k, n_subjects))
                         for k in keys])
    if family == "subject_bootstrap":
        return np.stack([np.asarray(jax.random.choice(k, n_subjects,
                                                      (n_subjects,)))
                         for k in keys])
    if family == "circular_timeshift":
        return np.stack([np.asarray(jax.random.choice(k, n_trs,
                                                      (n_subjects,)))
                         for k in keys])
    n_pos = tops_stats.n_positive_bins(n_trs)
    return np.stack([np.asarray(jax.random.uniform(
        k, (n_pos, 1, n_subjects), dtype=dtype)) * 2 * np.pi
        for k in keys])


def _iu(n):
    iu = np.triu_indices(n, k=1)
    return torch.as_tensor(iu[0]), torch.as_tensor(iu[1])


@pytest.mark.parametrize("statistic,pairwise", [("median", False),
                                                ("mean", True)])
def test_isc_families_on_jax_descriptors(statistic, pairwise):
    """sign flips, shuffles and bootstraps of the JAX package's keys:
    the port's family programs give its null within 1e-12."""
    rng = np.random.RandomState(11)
    n_subj, n_vox, n = 6, 5, 12
    data = simulated_timeseries(n_subj, 30, n_vox, random_state=11)
    iscs = jisc.isc(data, pairwise=pairwise)
    iscs[1, 2] = np.nan
    keys = _keys(5, n)
    iu0, iu1 = jnp.asarray(np.triu_indices(n_subj, 1)[0]), \
        jnp.asarray(np.triu_indices(n_subj, 1)[1])
    iu = _iu(n_subj) if pairwise else None
    t_iscs = torch.as_tensor(iscs)

    # sign flip
    prog = jsur.sign_flip_program(statistic, 4, True, n_subj, pairwise)
    want = prog(jnp.asarray(iscs), keys, iu0, iu1) if pairwise else \
        prog(jnp.asarray(iscs), keys)
    flips = _jax_descriptors("sign_flip", keys, n_subj,
                             dtype=jnp.float64)
    got = tsur.sign_flip_null(t_iscs, torch.as_tensor(flips), statistic,
                              iu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ISC_TOL, rtol=0)

    # group shuffle
    group = np.array([0, 1, 0, 1, 1, 0])
    labels = jnp.asarray(np.unique(group).astype(float))
    perms = _jax_descriptors("group_shuffle", keys, n_subj)
    prog = jsur.group_shuffle_program(statistic, 4, True, pairwise)
    if pairwise:
        sq = np.full((n_subj, n_subj), np.nan)
        for g in (0, 1):
            idx = np.where(group == g)[0]
            sq[np.ix_(idx, idx)] = g
        np.fill_diagonal(sq, np.nan)
        want = prog(jnp.asarray(iscs), jnp.asarray(sq), labels, iu0, iu1,
                    keys)
        got = tsur.group_shuffle_null(
            t_iscs, None, torch.as_tensor([0.0, 1.0]),
            torch.as_tensor(perms), statistic, torch.as_tensor(sq), iu)
    else:
        want = prog(jnp.asarray(iscs), jnp.asarray(group), labels, keys)
        got = tsur.group_shuffle_null(
            t_iscs, torch.as_tensor(group.astype(float)),
            torch.as_tensor([0.0, 1.0]), torch.as_tensor(perms),
            statistic)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ISC_TOL, rtol=0)

    # subject bootstrap
    samples = _jax_descriptors("subject_bootstrap", keys, n_subj)
    prog = jsur.subject_bootstrap_program(statistic, 4, pairwise)
    if pairwise:
        from scipy.spatial.distance import squareform
        sq = np.stack([squareform(v, force='tomatrix') for v in iscs.T],
                      axis=-1)
        for v in range(sq.shape[-1]):
            np.fill_diagonal(sq[..., v], 1.0)
        want = prog(jnp.asarray(sq), keys, iu0, iu1)
        got = tsur.bootstrap_null(torch.as_tensor(sq),
                                  torch.as_tensor(samples), statistic, iu)
    else:
        want = prog(jnp.asarray(iscs), keys)
        got = tsur.bootstrap_null(t_iscs, torch.as_tensor(samples),
                                  statistic)
    want = np.asarray(want)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, atol=ISC_TOL, rtol=0,
                               equal_nan=True)
    del rng


@pytest.mark.parametrize("statistic,pairwise", [("median", False),
                                                ("mean", True)])
def test_shift_families_on_jax_descriptors(statistic, pairwise):
    """Circular shifts and phase angles of the JAX package's keys: the
    port's float32 programs give its float64 null within 1e-5."""
    n_subj, n_trs, n_vox, n = 5, 24, 4, 8
    data = simulated_timeseries(n_subj, n_trs, n_vox, random_state=12)
    keys = _keys(9, n)
    iu = np.triu_indices(n_subj, 1)
    iu0, iu1 = jnp.asarray(iu[0]), jnp.asarray(iu[1])
    data_j = jnp.asarray(data)
    others_j = data_j if pairwise else jisc._loo_means_core(data_j, True)
    t_data = torch.as_tensor(data, dtype=torch.float32)
    t_others = None if pairwise else tisc._loo_means_core(t_data, True)
    t_iu = _iu(n_subj) if pairwise else None

    prog = jsur.circular_timeshift_program(statistic, 4, pairwise)
    want = np.asarray(prog(data_j, others_j, keys, iu0, iu1))
    shifts = _jax_descriptors("circular_timeshift", keys, n_subj, n_trs)
    got = tsur.timeshift_null(t_data, t_others, torch.as_tensor(shifts),
                              statistic, t_iu)
    np.testing.assert_allclose(got.numpy(), want, atol=SHIFT_TOL, rtol=0)

    prog = jsur.phase_randomize_program(statistic, 4, pairwise, False)
    want = np.asarray(prog(data_j, others_j, keys, iu0, iu1))
    angles = _jax_descriptors("phase_randomize", keys, n_subj, n_trs,
                              dtype=jnp.float64)
    got = tsur.phase_null(t_data, t_others,
                          torch.as_tensor(angles, dtype=torch.float32),
                          statistic, t_iu)
    np.testing.assert_allclose(got.numpy(), want, atol=SHIFT_TOL, rtol=0)
    if pairwise:
        return
    # voxelwise phases: the JAX op's angles, one set a voxel
    prog = jsur.phase_randomize_program(statistic, 4, False, True)
    want = np.asarray(prog(data_j, others_j, keys, iu0, iu1))
    n_pos = tops_stats.n_positive_bins(n_trs)
    angles = np.stack([np.asarray(jax.random.uniform(
        k, (n_pos, n_vox, n_subj), dtype=jnp.float64)) * 2 * np.pi
        for k in keys])
    got = tsur.phase_null(t_data, t_others,
                          torch.as_tensor(angles, dtype=torch.float32),
                          statistic)
    np.testing.assert_allclose(got.numpy(), want, atol=SHIFT_TOL, rtol=0)


def test_descriptors_are_a_function_of_seed_and_index():
    for family in tsur.FAMILIES:
        a = tsur.draw_descriptors(family, 7, 30, 5, n_trs=20)
        b = tsur.draw_descriptors(family, 7, 30, 5, n_trs=20)
        c = tsur.draw_descriptors(family, 8, 30, 5, n_trs=20)
        assert np.array_equal(a, b) and not np.array_equal(a, c)
    perms = tsur.draw_descriptors("group_shuffle", 1, 50, 6)
    assert np.array_equal(np.sort(perms, axis=1),
                          np.tile(np.arange(6), (50, 1)))
    flips = tsur.draw_descriptors("sign_flip", 1, 50, 6)
    assert set(np.unique(flips)) == {-1.0, 1.0}


def test_median_averages_the_two_middle_values():
    x = torch.tensor([[1.0, 4.0], [2.0, np.nan], [10.0, 5.0],
                      [3.0, np.nan]], dtype=torch.float64)
    got = tsur._nanmedian(x, 0).numpy()
    assert np.array_equal(got, np.nanmedian(x.numpy(), axis=0))
    allnan = torch.full((3, 2), np.nan, dtype=torch.float64)
    assert np.all(np.isnan(tsur._nanmedian(allnan, 0).numpy()))


# ---------------------------------------------------------------------------
# exact tests: the JAX package's whole output

@pytest.mark.parametrize("statistic", ["median", "mean"])
@pytest.mark.parametrize("pairwise", [False, True])
def test_exact_sign_flip_equals_jax(pairwise, statistic):
    data = correlated_timeseries(5, 60, noise=0.5, random_state=1)
    iscs = jisc.isc(data, pairwise=pairwise)
    got = tisc.permutation_isc(iscs, pairwise=pairwise,
                               summary_statistic=statistic,
                               n_permutations=100, device="cpu")
    want = jisc.permutation_isc(iscs, pairwise=pairwise,
                                summary_statistic=statistic,
                                n_permutations=100)
    assert got[2].shape == (32, 3)
    _exactly(got, want, statistic)


@pytest.mark.parametrize("statistic", ["median", "mean"])
def test_exact_group_shuffle_equals_jax(statistic):
    g1 = simulated_timeseries(3, 40, 3, noise=0.5, random_state=3)
    g2 = simulated_timeseries(3, 40, 3, noise=10.0, random_state=4)
    iscs = np.vstack([jisc.isc(g1), jisc.isc(g2)])
    kw = dict(group_assignment=[1, 1, 1, 2, 2, 2],
              summary_statistic=statistic, n_permutations=1000)
    got = tisc.permutation_isc(iscs, device="cpu", **kw)
    want = jisc.permutation_isc(iscs, **kw)
    assert got[2].shape == (720, 3)
    _exactly(got, want, statistic)
    with pytest.raises(ValueError):
        tisc.permutation_isc(iscs, group_assignment=[1, 1, 2, 2, 3, 3],
                             device="cpu")
    with pytest.raises(ValueError):
        tisc.permutation_isc(iscs, group_assignment=[1, 1, 2],
                             device="cpu")


def _exactly(got, want, statistic):
    """Observed and null equal (medians) or within 1e-12 (means); p
    equal for medians.  For means a null value that ties the observed
    one to within 1e-12 (the identity resample: the observed statistic
    is NumPy's, the null the device program's) may fall on either side
    of it, so each p may move by the count of such ties over n."""
    (obs, p, dist), (w_obs, w_p, w_dist) = got, want
    for g, w in ((obs, w_obs), (dist, w_dist)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if statistic == "median":
            assert np.array_equal(g, w, equal_nan=True)
        else:
            np.testing.assert_allclose(g, w, atol=ISC_TOL, rtol=0)
    if statistic == "median":
        assert np.array_equal(p, w_p)
    else:
        ties = np.sum(np.abs(dist - obs) <= ISC_TOL, axis=0)
        assert np.all(np.abs(p - w_p) <= ties / dist.shape[0] + 1e-15)


# ---------------------------------------------------------------------------
# the public wrappers: JAX's within Monte Carlo, the port's own contracts

def test_sampled_p_values_within_monte_carlo_band_of_jax():
    """The public p-values of a bootstrap, a two-group shuffle and a
    circular time-shift test, each from other draws than the JAX
    package's, within a Monte Carlo band of its."""
    n = 600
    data = correlated_timeseries(10, 80, noise=0.8, random_state=42)
    iscs = jisc.isc(data)
    p_t = tisc.bootstrap_isc(iscs, n_bootstraps=n, random_state=0,
                             device="cpu")[2]
    p_j = jisc.bootstrap_isc(iscs, n_bootstraps=n, random_state=0)[2]
    _mc_band(p_t, p_j, n)
    group = [0] * 5 + [1] * 5
    p_t = tisc.permutation_isc(iscs, group_assignment=group,
                               n_permutations=n, random_state=2,
                               side="two-sided", device="cpu")[1]
    p_j = jisc.permutation_isc(iscs, group_assignment=group,
                               n_permutations=n, random_state=2,
                               side="two-sided")[1]
    _mc_band(p_t, p_j, n)
    n = 200
    obs_t, p_t, _ = tisc.timeshift_isc(data, n_shifts=n, random_state=3,
                                       device="cpu")
    obs_j, p_j, _ = jisc.timeshift_isc(data, n_shifts=n, random_state=3)
    np.testing.assert_allclose(obs_t, obs_j, atol=SHIFT_TOL)
    _mc_band(p_t, p_j, n)


@pytest.fixture(scope="module")
def iscs():
    rng = np.random.RandomState(0)
    return 0.2 + 0.1 * rng.randn(10, 6)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(1)
    return rng.randn(30, 4, 8)


def test_bootstrap_isc_matched_seed_and_counted_path(iscs):
    obs, ci, p, dist = tisc.bootstrap_isc(
        iscs, n_bootstraps=48, random_state=SEED, device="cpu")
    obs2, ci2, p2, dist2 = tisc.bootstrap_isc(
        iscs, n_bootstraps=48, random_state=SEED, device="cpu")
    assert np.array_equal(obs, obs2)
    assert np.array_equal(p, p2)
    assert np.array_equal(dist, dist2, equal_nan=True)
    assert dist.shape == (48, 6)
    obs3, ci3, p3, dist3 = tisc.bootstrap_isc(
        iscs, n_bootstraps=48, random_state=SEED, device="cpu",
        return_distribution=False)
    assert dist3 is None
    assert np.array_equal(obs3, obs)
    assert np.array_equal(p3, p)
    # the counted CI is the histogram's, to its relative accuracy
    np.testing.assert_allclose(ci3[0], ci[0], rtol=0.05)


def test_permutation_isc_matched_seed_and_counted_path(iscs):
    group = [0] * 4 + [1] * 6
    obs, p, dist = tisc.permutation_isc(
        iscs, group_assignment=group, n_permutations=48,
        random_state=SEED, device="cpu")
    obs2, p2, dist2 = tisc.permutation_isc(
        iscs, group_assignment=group, n_permutations=48,
        random_state=SEED, device="cpu")
    assert np.array_equal(p, p2)
    assert np.array_equal(dist, dist2, equal_nan=True)
    obs3, p3, dist3 = tisc.permutation_isc(
        iscs, group_assignment=group, n_permutations=48,
        random_state=SEED, device="cpu", return_distribution=False)
    assert dist3 is None
    assert np.array_equal(np.asarray(obs3), np.asarray(obs))
    assert np.array_equal(p3, p)


def test_permutation_isc_one_sample_counted_path(iscs):
    obs, p, dist = tisc.permutation_isc(
        iscs, n_permutations=32, random_state=SEED, device="cpu")
    obs3, p3, dist3 = tisc.permutation_isc(
        iscs, n_permutations=32, random_state=SEED, device="cpu",
        return_distribution=False)
    assert dist3 is None
    assert np.array_equal(p3, p)


@pytest.mark.parametrize("name", ["timeshift_isc", "phaseshift_isc"])
def test_shift_isc_matched_seed_and_counted_path(data, name):
    fn = getattr(tisc, name)
    obs, p, dist = fn(data, n_shifts=32, random_state=SEED, device="cpu")
    obs2, p2, dist2 = fn(data, n_shifts=32, random_state=SEED,
                         device="cpu")
    assert np.array_equal(p, p2)
    assert np.array_equal(dist, dist2, equal_nan=True)
    obs3, p3, dist3 = fn(data, n_shifts=32, random_state=SEED,
                         device="cpu", return_distribution=False)
    assert dist3 is None
    assert np.array_equal(obs3, obs)
    assert np.array_equal(p3, p)


def test_random_state_forms():
    assert tisc._resolve_seed(5) == 5
    a = tisc._resolve_seed(np.random.RandomState(3))
    assert a == tisc._resolve_seed(np.random.RandomState(3))
    assert 0 <= tisc._resolve_seed(None) < tisc.MAX_RANDOM_SEED
    assert tisc.MAX_RANDOM_SEED == jisc.MAX_RANDOM_SEED


def test_bootstrap_isc():
    n_bootstraps = 100
    data = correlated_timeseries(15, 80, noise=0.5, random_state=42)
    for pairwise in (False, True):
        iscs = tisc.isc(data, pairwise=pairwise, device="cpu")
        observed, ci, p, distribution = tisc.bootstrap_isc(
            iscs, pairwise=pairwise, summary_statistic='median',
            n_bootstraps=n_bootstraps, random_state=0, device="cpu")
        assert distribution.shape == (n_bootstraps, 3)
        assert len(ci) == 2
        assert p[0] < 0.05 and p[1] < 0.05
        assert p[2] > 0.01
    iscs = tisc.isc(data, pairwise=False, device="cpu")
    _, _, _, d1 = tisc.bootstrap_isc(iscs, n_bootstraps=50,
                                     random_state=7, device="cpu")
    _, _, _, d2 = tisc.bootstrap_isc(iscs, n_bootstraps=50,
                                     random_state=7, device="cpu")
    _, _, _, d3 = tisc.bootstrap_isc(iscs, n_bootstraps=50,
                                     random_state=8, device="cpu")
    assert np.array_equal(d1, d2)
    assert not np.array_equal(d1, d3)
    with pytest.raises(ValueError):
        tisc.bootstrap_isc(iscs, summary_statistic='mode', device="cpu")


def test_permutation_isc_one_sample():
    data = correlated_timeseries(12, 80, noise=0.5, random_state=42)
    for pairwise in (False, True):
        iscs = tisc.isc(data, pairwise=pairwise, device="cpu")
        observed, p, distribution = tisc.permutation_isc(
            iscs, pairwise=pairwise, summary_statistic='median',
            n_permutations=200, random_state=0, device="cpu")
        assert distribution.shape == (200, 3)
        assert p[0] < 0.05 and p[1] < 0.05
        # the noise voxel is never more significant than the signal
        # voxels; 200 draws may leave all three at the floor 1/201 (the
        # pairwise noise voxel's exact p is 0.018), the exact test below
        # orders them strictly
        assert p[2] >= max(p[0], p[1])
        exact_p = tisc.permutation_isc(
            iscs, pairwise=pairwise, summary_statistic='median',
            n_permutations=4096, device="cpu")[1]
        assert exact_p[2] > max(exact_p[0], exact_p[1])


def test_permutation_isc_two_sample():
    g1 = simulated_timeseries(8, 60, 4, noise=0.5, random_state=3)
    g2 = simulated_timeseries(8, 60, 4, noise=20.0, random_state=4)
    iscs = np.vstack([tisc.isc(g1, device="cpu"),
                      tisc.isc(g2, device="cpu")])
    group_assignment = [1] * 8 + [2] * 8
    observed, p, distribution = tisc.permutation_isc(
        iscs, group_assignment=group_assignment, pairwise=False,
        summary_statistic='mean', n_permutations=200, random_state=0,
        device="cpu")
    assert distribution.shape == (200, 4)
    assert np.all(np.asarray(p) < 0.05)
    data = np.dstack([g1, g2])
    iscs_pw = tisc.isc(data, pairwise=True, device="cpu")
    observed2, p2, dist2 = tisc.permutation_isc(
        iscs_pw, group_assignment=group_assignment, pairwise=True,
        summary_statistic='mean', n_permutations=200, random_state=0,
        device="cpu")
    assert dist2.shape == (200, 4)
    assert np.all(np.asarray(p2) < 0.1)
    # the observed two-group statistic is the JAX package's
    want = jisc.permutation_isc(
        iscs_pw, group_assignment=group_assignment, pairwise=True,
        summary_statistic='mean', n_permutations=8, random_state=0)[0]
    np.testing.assert_allclose(observed2, want, atol=ISC_TOL)


@pytest.mark.parametrize("name", ["timeshift_isc", "phaseshift_isc"])
def test_shift_isc(name):
    fn = getattr(tisc, name)
    data = correlated_timeseries(10, 80, noise=0.5, random_state=42)
    observed, p, distribution = fn(data, pairwise=False, n_shifts=100,
                                   random_state=0, device="cpu")
    assert distribution.shape == (100, 3)
    assert p[0] < 0.05 and p[1] < 0.05 and p[2] > 0.01
    observed, p, distribution = fn(data, pairwise=True, n_shifts=50,
                                   random_state=0, device="cpu")
    assert distribution.shape == (50, 3)


def test_voxelwise_phaseshift_isc():
    data = correlated_timeseries(6, 40, noise=0.5, random_state=5)
    obs, p, dist = tisc.phaseshift_isc(data, n_shifts=20, voxelwise=True,
                                       random_state=1, device="cpu")
    obs2, p2, dist2 = tisc.phaseshift_isc(
        data, n_shifts=20, voxelwise=True, random_state=1, device="cpu",
        return_distribution=False)
    assert dist.shape == (20, 3) and np.all(np.isfinite(dist))
    assert np.array_equal(p, p2)
    shared = tisc.phaseshift_isc(data, n_shifts=20, random_state=1,
                                 device="cpu")[2]
    assert not np.array_equal(dist, shared)


def test_resampling_preserves_nan_voxel_columns():
    rng = np.random.RandomState(0)
    data = rng.randn(30, 4, 6)
    data[:, 1, :] = np.nan
    for fn in (tisc.timeshift_isc, tisc.phaseshift_isc):
        obs, p, dist = fn(data, n_shifts=10, random_state=0, device="cpu")
        assert obs.shape == (4,)
        assert dist.shape == (10, 4)
        assert np.isnan(obs[1]) and np.all(np.isnan(dist[:, 1]))
        assert np.all(np.isfinite(dist[:, [0, 2, 3]]))
        obs2, p2, _ = fn(data, n_shifts=10, random_state=0, device="cpu",
                         return_distribution=False)
        assert np.array_equal(p2, p)
        assert p2[1] == 1.0 / 11


def test_isc_and_nulls_mesh_match_single():
    """mesh= splits the voxel axis (13 voxels NaN-padded over 4
    positions of the CPU) and draws the same resamples as the meshless
    run.  The ISC-input nulls (float64 sorts and subject sums) are bit
    for bit the meshless ones.  The shift nulls sum float32 over time,
    and PyTorch's CPU sum orders a reduction by the tensor's extent, so
    the pieces lie within 1e-6 of the whole (as ``isc(mesh=)`` itself);
    their p-values move only where a null value ties the observed one
    to within that."""
    mesh = make_mesh(("voxel",), (4,), devices=["cpu"] * 4)
    data = simulated_timeseries(n_subjects=5, n_TRs=40, n_voxels=13,
                                noise=1.0, random_state=42)
    iscs = tisc.isc(data, device="cpu")
    iscs_pw = tisc.isc(data, pairwise=True, device="cpu")
    exact_runs = [
        (tisc.bootstrap_isc, iscs, dict(n_bootstraps=30)),
        (tisc.bootstrap_isc, iscs, dict(n_bootstraps=30,
                                        summary_statistic="mean")),
        (tisc.bootstrap_isc, iscs_pw, dict(n_bootstraps=30,
                                           pairwise=True)),
        (tisc.permutation_isc, iscs, dict(n_permutations=30)),
        (tisc.permutation_isc, iscs_pw, dict(n_permutations=30,
                                             pairwise=True)),
        (tisc.permutation_isc, iscs,
         dict(n_permutations=30, group_assignment=[0, 0, 1, 1, 1]))]
    for fn, x, kwargs in exact_runs:
        r_plain = fn(x, random_state=7, device="cpu", null_batch_size=4,
                     **kwargs)
        r_mesh = fn(x, random_state=7, mesh=mesh, null_batch_size=4,
                    device="cpu", **kwargs)
        for a, b in zip(r_plain, r_mesh):
            for u, v in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert np.array_equal(np.asarray(u), np.asarray(v),
                                      equal_nan=True), fn.__name__
    for pairwise in (False, True):
        np.testing.assert_allclose(
            tisc.isc(data, pairwise=pairwise, mesh=mesh, device="cpu"),
            tisc.isc(data, pairwise=pairwise, device="cpu"), atol=1e-6)
    for fn, kwargs in ((tisc.timeshift_isc, dict(n_shifts=20)),
                       (tisc.phaseshift_isc, dict(n_shifts=20)),
                       (tisc.phaseshift_isc, dict(n_shifts=12,
                                                  voxelwise=True)),
                       (tisc.timeshift_isc, dict(n_shifts=12,
                                                 pairwise=True))):
        obs, p, dist = fn(data, random_state=7, device="cpu",
                          null_batch_size=4, **kwargs)
        m_obs, m_p, m_dist = fn(data, random_state=7, mesh=mesh,
                                null_batch_size=4, device="cpu", **kwargs)
        np.testing.assert_allclose(m_obs, obs, atol=1e-6, rtol=0)
        np.testing.assert_allclose(m_dist, dist, atol=1e-6, rtol=0)
        ties = np.sum(np.abs(dist - obs) <= 2e-6, axis=0)
        assert np.all(np.abs(m_p - p) <= ties / (len(dist) + 1) + 1e-15)


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tisc.bootstrap_isc(np.ones((4, 3)) * 0.3, n_bootstraps=8,
                           random_state=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstats.NullEngine().run(np.ones((4, 3)) * 0.3, "sign_flip", 8)


def test_exact_sizes_follow_jax():
    assert math.factorial(6) == 720
    spec = tsur.make_spec("sign_flip", np.ones((5, 2)) * 0.2,
                          n_resamples=40, device="cpu")
    assert spec.exact and spec.n_total == 32
    jspec = jsur.make_spec("sign_flip", np.ones((5, 2)) * 0.2,
                           n_resamples=40)
    assert np.array_equal(spec.xs, jspec.xs)
    spec = tsur.make_spec("group_shuffle", np.ones((6, 2)) * 0.2,
                          n_resamples=1000, group_assignment=[0, 1] * 3,
                          device="cpu")
    jspec = jsur.make_spec("group_shuffle", np.ones((6, 2)) * 0.2,
                           n_resamples=1000, group_assignment=[0, 1] * 3)
    assert spec.exact and np.array_equal(spec.xs, jspec.xs)
