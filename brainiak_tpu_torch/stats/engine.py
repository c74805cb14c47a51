"""Population-scale resampling-statistics engine.

PyTorch counterpart of ``brainiak_tpu/stats/engine.py``.
:class:`NullEngine` drives thousands of null resamples through the
:mod:`.surrogates` family programs, folding each chunk into the
mergeable :class:`~brainiak_tpu_torch.stats.accum.NullAccumulator`
state instead of materializing the ``[n_resamples, V]`` null (unless
``return_distribution=True`` asks for it).  The null axis is chunked
whenever ``n_resamples * V`` exceeds the budget
(``BRAINIAK_TPU_STATS_BUDGET_BYTES``, a sizing budget as in the JAX
package), the loop runs under
:func:`~brainiak_tpu_torch.resilience.guards.run_resilient_loop` so a
preempted run resumes at the last completed null chunk (fingerprint =
data digest + family + seed + grid), and every chunk emits a
``stats.chunk`` span plus ``stats_surrogates_total``.

The fold of a chunk into the accumulator state runs where the chunk's
values are (:class:`_ChunkFold`): the exceedance counts, finite
counts, moments and the log-bucket histograms are reduced on the
device and stay there from chunk to chunk; the per-resample maximum
and the coverage are host arrays.  The state is the accumulator's wire
format, so the counts are the ones :meth:`NullAccumulator.update`
would add, and the p-map of a counted run is bit for bit the
materialized one's.

Disjoint-range pooling: two runs over disjoint ``index_range``s of
the SAME (data, family, seed) slice the same descriptors, so their
:class:`NullDistribution` results ``merge()`` to exactly the
single-run verdict -- across the serialized wire format.
"""

import logging
import os
import zlib

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from ..resilience.guards import _host, array_digest, run_resilient_loop
from .accum import NullAccumulator
from .surrogates import FAMILIES, make_spec

__all__ = [
    "DEFAULT_BUDGET_BYTES",
    "NullDistribution",
    "NullEngine",
    "default_null_batch",
    "stats_budget_bytes",
]

logger = logging.getLogger(__name__)

#: default per-run materialization budget (bytes) when
#: ``BRAINIAK_TPU_STATS_BUDGET_BYTES`` is unset: 256 MiB.
DEFAULT_BUDGET_BYTES = 1 << 28

#: state leaves that are NaN-bearing by design (uncovered resample
#: slots, NaN voxel columns) and must skip the non-finite guard.
_NAN_LEAVES = ("observed", "center", "max_stat", "dist")

#: accumulator leaves that the fold keeps on the values' device.
_DEVICE_LEAVES = ("ge", "le", "abs_ge", "n_finite", "small", "pos",
                  "neg", "sum", "sumsq")


def stats_budget_bytes():
    """The configured null-materialization budget in bytes."""
    return int(os.environ.get("BRAINIAK_TPU_STATS_BUDGET_BYTES",
                              DEFAULT_BUDGET_BYTES))


def default_null_batch(n_elements=None):
    """The unified ``null_batch_size`` default, sized from the budget.

    ``n_elements`` is the per-resample working-set element count (the
    ISC stack's ``V`` for the ISC-resampling families, ``T * V * S``
    for the shift families).  The batch is the largest power of two
    whose f32 working set (``batch * n_elements * 4`` bytes) stays
    within 1/8 of :func:`stats_budget_bytes`, clamped to [16, 64]:
    64 lanes for cheap ISC resamples, 16 for the heavy shift families.
    At whole-brain width a shift family's 16 lanes hold many GB of
    temporaries each; pass ``null_batch_size`` to fit the card.
    """
    if n_elements is None:
        return 64
    budget = stats_budget_bytes()
    per_resample = 4 * max(1, int(n_elements))
    lanes = budget // (8 * per_resample)
    if lanes >= 64:
        return 64
    if lanes <= 16:
        return 16
    return 1 << (int(lanes).bit_length() - 1)


def _chunk_length(n_voxels, batch, budget):
    """Resamples per chunk: the materialized per-chunk null block
    ``[chunk, V]`` (one device copy + one f64 host copy + integer
    accumulator updates) is held to the budget, rounded down to a
    whole number of ``batch``-size dispatch lanes."""
    per_resample = 16 * max(1, int(n_voxels))
    chunk = int(budget) // per_resample
    chunk = (chunk // batch) * batch
    return max(batch, chunk)


class _ChunkFold:
    """:meth:`NullAccumulator.update` of a chunk of values, with the
    per-voxel reductions on the values' device.

    ``fold(state, values, lo, hi)`` returns a new state dict in the
    accumulator's wire format: the :data:`_DEVICE_LEAVES` are new
    tensors on ``device`` (the input state is not modified, so the
    resilient loop's last good state survives a rollback), the
    max-statistic track and coverage new host arrays.  Counts are
    exact integers, so they equal the host update's; the moments are
    float sums in the device's order.
    """

    def __init__(self, acc, device):
        self.device = device
        f64 = torch.float64
        self.observed = torch.as_tensor(acc.observed, dtype=f64,
                                        device=device)
        self.center = None if acc.center is None else torch.as_tensor(
            acc.center, dtype=f64, device=device)
        self.shape = acc.shape
        self.k_lo, self.n_keys = acc.k_lo, acc.n_keys
        self.k_hi = acc.k_hi
        self.log_gamma = acc._log_gamma
        self.min_magnitude = acc.min_magnitude
        self.n_cols = int(np.prod(self.shape, dtype=np.int64)) or 1

    def zeros(self, state):
        """``state`` with its device leaves replaced by zeros on the
        device (a fresh accumulator's)."""
        out = dict(state)
        for k in _DEVICE_LEAVES:
            leaf = np.asarray(state[k])
            out[k] = torch.zeros(leaf.shape, device=self.device,
                                 dtype=torch.from_numpy(leaf[:0]).dtype)
        return out

    def on_device(self, state):
        """``state`` (host arrays after a checkpoint restore, or the
        fold's own) with its device leaves on the device."""
        out = dict(state)
        for k in _DEVICE_LEAVES:
            out[k] = torch.as_tensor(state[k], device=self.device)
        return out

    def _hist(self, values, mask):
        """Per-voxel bucket counts ``[n_keys, *shape]`` of the masked
        values: one integer scatter-add over a bucket-major linear
        index, the masked-out entries sent to a spare last bin (integer
        adds in any order give one result; ``torch.bincount`` would
        read its input's extent back to the host)."""
        mags = torch.where(mask, values.abs(), 1.0)
        keys = torch.clamp(torch.ceil(torch.log(mags) / self.log_gamma),
                           self.k_lo, self.k_hi).to(torch.int64)
        cols = torch.arange(self.n_cols, device=self.device).reshape(
            (1,) + self.shape).expand(values.shape)
        spare = self.n_keys * self.n_cols
        lin = torch.where(mask, (keys - self.k_lo) * self.n_cols + cols,
                          spare)
        lin = lin.reshape(-1)
        counts = torch.zeros(spare + 1, dtype=torch.int64,
                             device=self.device).scatter_add_(
            0, lin, torch.ones_like(lin))
        return counts[:spare].reshape((self.n_keys,) + self.shape)

    def fold(self, state, values, lo, hi):
        covered = np.array(state["covered"], copy=True)
        if hi - lo != values.shape[0]:
            raise ValueError(
                "index_range {} spans {} resamples but chunk has {}"
                .format((lo, hi), hi - lo, values.shape[0]))
        if np.any(covered[lo:hi]):
            raise ValueError(
                "resample indices [{}, {}) already accumulated".format(
                    lo, hi))
        v = values.to(torch.float64)
        shifted = v if self.center is None else v - self.center
        out = dict(state)
        out["ge"] = state["ge"] + (shifted >= self.observed).sum(dim=0)
        out["le"] = state["le"] + (shifted <= self.observed).sum(dim=0)
        out["abs_ge"] = state["abs_ge"] + (
            shifted.abs() >= self.observed.abs()).sum(dim=0)
        out["n"] = np.asarray(int(np.asarray(state["n"])) + v.shape[0],
                              dtype=np.int64)

        finite = torch.isfinite(v)
        out["n_finite"] = state["n_finite"] + finite.sum(dim=0)
        zeroed = torch.where(finite, v, 0.0)
        out["sum"] = state["sum"] + zeroed.sum(dim=0)
        out["sumsq"] = state["sumsq"] + (zeroed * zeroed).sum(dim=0)

        bucketed = finite & (v.abs() >= self.min_magnitude)
        out["small"] = state["small"] + (finite & ~bucketed).sum(dim=0)
        out["pos"] = state["pos"] + self._hist(v, bucketed & (v > 0))
        out["neg"] = state["neg"] + self._hist(v, bucketed & (v < 0))

        per_resample = shifted.reshape(v.shape[0], -1)
        row_finite = torch.isfinite(per_resample)
        row_max = torch.where(row_finite, per_resample,
                              -torch.inf).amax(dim=1)
        row_max = torch.where(row_finite.any(dim=1), row_max, torch.nan)
        max_stat = np.array(state["max_stat"], dtype=np.float64,
                            copy=True)
        max_stat[lo:hi] = row_max.cpu().numpy()
        covered[lo:hi] = 1
        out["max_stat"] = max_stat
        out["covered"] = covered
        return out


def _quantile(acc, hist, q):
    """:meth:`NullAccumulator.quantile` over histogram leaves ``hist``
    (``pos``, ``neg``, ``small``, ``n_finite``) that lie on a device:
    the same nearest-rank arithmetic, so the same values, without
    bringing the ``[2 n_keys + 1, V]`` counts to the host."""
    rep = (2.0 * np.exp(np.arange(acc.k_lo, acc.k_hi + 1)
                        * acc._log_gamma) / (acc._gamma + 1.0))
    values = torch.as_tensor(np.concatenate([-rep[::-1], [0.0], rep]),
                             device=hist["pos"].device)
    counts = torch.cat([hist["neg"].flip(0), hist["small"][None],
                        hist["pos"]])
    cum = torch.cumsum(counts, dim=0)
    total = hist["n_finite"]
    rank = torch.round(q * torch.clamp(total - 1, min=0).to(
        torch.float64)).to(torch.int64)
    idx = torch.clamp((cum <= rank).sum(dim=0), max=len(values) - 1)
    out = torch.where(total > 0, values[idx], torch.nan)
    return out.cpu().numpy()


class NullDistribution:
    """The engine's result: observed statistic + mergeable null
    summary.

    ``distribution`` is the materialized ``[n_total, V]`` null (rows
    outside the run's covered index range are NaN) when the run asked
    for ``return_distribution=True``; ``None`` otherwise.
    ``null_tensor`` is the same null on the engine's device (the
    ``*_isc`` wrappers read p-values and percentiles from it), and the
    CI reads the accumulator's histograms where the engine left them;
    :meth:`merge` drops both.
    """

    def __init__(self, family, statistic, seed, side, exact,
                 observed, accumulator, distribution=None,
                 thresholds=None, null_tensor=None, hist=None):
        self.family = family
        self.statistic = statistic
        self.seed = None if seed is None else int(seed)
        self.side = side
        self.exact = bool(exact)
        self.observed = np.asarray(observed)
        self.accumulator = accumulator
        self.distribution = distribution
        self.thresholds = dict(thresholds or {})
        self.null_tensor = null_tensor
        self._hist = hist

    @property
    def n_total(self):
        return self.accumulator.n_total

    @property
    def n(self):
        return self.accumulator.n

    @property
    def complete(self):
        return self.accumulator.complete

    def p_values(self, side=None, exact=None):
        return self.accumulator.p_values(
            side=self.side if side is None else side,
            exact=self.exact if exact is None else exact)

    def ci(self, ci_percentile=95):
        if self._hist is None:
            return self.accumulator.ci(ci_percentile)
        lo_q = (100.0 - ci_percentile) / 200.0
        hi_q = (ci_percentile + (100.0 - ci_percentile) / 2.0) / 100.0
        return (_quantile(self.accumulator, self._hist, lo_q),
                _quantile(self.accumulator, self._hist, hi_q))

    def fwer_threshold(self, alpha=0.05):
        return self.accumulator.fwer_threshold(alpha)

    def fdr_threshold(self, alpha=0.05):
        return self.accumulator.fdr_threshold(
            alpha, side=self.side, exact=self.exact)

    def compute_thresholds(self, alphas=(0.05, 0.01)):
        """Precompute the FWER/FDR thresholds."""
        for alpha in alphas:
            self.thresholds["fwer_{:g}".format(alpha)] = \
                self.fwer_threshold(alpha)
            self.thresholds["fdr_{:g}".format(alpha)] = \
                self.fdr_threshold(alpha)
        return self.thresholds

    def merge(self, other):
        """Pool a disjoint-range run into this one, in place --
        counts, histograms, and max-statistic slots merge exactly
        (see :meth:`NullAccumulator.merge`)."""
        if (self.family, self.statistic, self.seed, self.side,
                self.exact) != (other.family, other.statistic,
                                other.seed, other.side, other.exact):
            raise ValueError("cannot merge null distributions from "
                             "different runs")
        before = self.accumulator.covered.astype(bool).copy()
        self.accumulator.merge(other.accumulator)
        self.null_tensor = self._hist = None
        if self.distribution is not None:
            if other.distribution is None:
                self.distribution = None
            else:
                rows = other.accumulator.covered.astype(bool) & ~before
                self.distribution[rows] = other.distribution[rows]
        return self


class NullEngine:
    """Chunked, resumable, poolable null-distribution runner.

    Parameters
    ----------
    mesh : optional Mesh with a ``'voxel'`` axis -- surrogate programs
        run voxel-split over its positions.
    null_batch_size : resamples a batched program evaluates at once
        (its lanes) inside a chunk; default :func:`default_null_batch`.
    budget_bytes : override of ``BRAINIAK_TPU_STATS_BUDGET_BYTES``.
    device : ``"cuda"`` (default; raises without a card) or ``"cpu"``;
        unused with a mesh, whose devices hold the inputs.
    """

    def __init__(self, mesh=None, null_batch_size=None,
                 budget_bytes=None, device="cuda"):
        self.mesh = mesh
        self.null_batch_size = null_batch_size
        self.budget_bytes = (stats_budget_bytes()
                             if budget_bytes is None
                             else int(budget_bytes))
        self.device = device

    def run(self, data, family, n_resamples, statistic='median', *,
            side='right', seed=0, pairwise=False,
            group_assignment=None, voxelwise=False, tolerate_nans=True,
            observed=None, center=None, index_range=None,
            return_distribution=False, checkpoint_dir=None,
            checkpoint_every=1, quantile_accuracy=None):
        """Evaluate ``n_resamples`` nulls of ``family`` over ``data``.

        ``observed`` defaults to the family's own observed statistic;
        ``center`` (e.g. the observed value, for the Hall & Wilson
        bootstrap shift) is subtracted from every null before
        exceedance counting.  ``index_range=(lo, hi)`` restricts this
        run to a slice of the global resample index space -- the
        pooling hook: disjoint-range results ``merge()`` exactly.
        ``checkpoint_dir`` / ``checkpoint_every`` (in chunks) persist
        the accumulator so a preempted run resumes at the last
        completed null chunk.
        """
        if family not in FAMILIES:
            raise ValueError(
                "Unknown surrogate family {!r}; registered families: "
                "{}".format(family, ", ".join(FAMILIES)))
        spec = make_spec(
            family, data, statistic=statistic,
            n_resamples=n_resamples, seed=seed, pairwise=pairwise,
            group_assignment=group_assignment, voxelwise=voxelwise,
            tolerate_nans=tolerate_nans, mesh=self.mesh,
            null_batch_size=self.null_batch_size, device=self.device)
        n_total = spec.n_total
        lo, hi = (0, n_total) if index_range is None else (
            int(index_range[0]), int(index_range[1]))
        if not 0 <= lo < hi <= n_total:
            raise ValueError("index_range {} outside [0, {}]".format(
                (lo, hi), n_total))

        if observed is None:
            observed = spec.compute_observed()
        observed = np.asarray(observed)

        batch = (self.null_batch_size
                 if self.null_batch_size is not None
                 else default_null_batch(spec.n_voxels))
        chunk_len = _chunk_length(spec.n_voxels, batch,
                                  self.budget_bytes)
        # never pad past the requested range: one whole-range chunk
        # (rounded up to full dispatch lanes) is the floor
        chunk_len = min(chunk_len, -(-(hi - lo) // batch) * batch)
        n_chunks = -(-(hi - lo) // chunk_len)
        acc_kwargs = {}
        if quantile_accuracy is not None:
            acc_kwargs["quantile_accuracy"] = float(quantile_accuracy)

        # Materialize the null at a dtype that stores the program's
        # values EXACTLY (f64 for an f64 observed): a lossy cast would
        # let a tie round across ``observed`` and flip an exceedance
        # count between the counted and the materialized p-map, and in
        # exact enumeration would drop the identity resample's
        # self-tie (the p >= 1/n guarantee).
        dist_dtype = np.result_type(np.asarray(observed).dtype,
                                    np.float32)
        acc0 = NullAccumulator(observed, n_total, center=center,
                               shape=(spec.n_voxels,), **acc_kwargs)
        folder = _ChunkFold(acc0, spec.device)
        init_state = folder.zeros(acc0.to_state())
        # the materialized null lives on the device, filled chunk by
        # chunk, and comes to the host once at the end
        dist_torch = torch.from_numpy(np.zeros(0, dist_dtype)).dtype
        fresh_dist = torch.full((n_total, spec.n_voxels), torch.nan,
                                dtype=dist_torch, device=spec.device) \
            if return_distribution else None
        if return_distribution:
            init_state["dist"] = fresh_dist
        # the data digest reads every element on the host: only a run
        # that checkpoints needs it
        fingerprint = None if checkpoint_dir is None else \
            self._fingerprint(data, spec, statistic, seed, lo, hi,
                              chunk_len, batch)

        carry = {}

        def run_chunk(state, step, n_steps):
            if carry.get("step") == step:
                folded, dist = carry["state"], carry["dist"]
            else:
                folded = folder.on_device(
                    {k: v for k, v in state.items() if k != "dist"})
                dist = None
                if return_distribution:
                    # this run's fresh null is its own; a restored or
                    # rolled-back one is copied, so a rollback keeps
                    # the prior chunk's rows
                    dist = state["dist"]
                    if dist is not fresh_dist:
                        dist = torch.as_tensor(dist).to(
                            spec.device, dist_torch, copy=True)
            for i in range(step, step + n_steps):
                c_lo = lo + i * chunk_len
                c_hi = min(c_lo + chunk_len, hi)
                xs_chunk = spec.xs[c_lo:c_hi]
                pad = chunk_len - (c_hi - c_lo)
                if pad:
                    # pad to the chunk extent: the lane groups stay
                    # full; pad rows are sliced off below
                    xs_chunk = np.concatenate(
                        [xs_chunk,
                         np.repeat(xs_chunk[:1], pad, axis=0)])
                with obs_spans.span(
                        "stats.chunk",
                        attrs={"family": family, "lo": c_lo,
                               "hi": c_hi}):
                    values = spec.run(xs_chunk)[:c_hi - c_lo]
                folded = folder.fold(folded, values, c_lo, c_hi)
                if dist is not None:
                    dist[c_lo:c_hi] = values
                obs_metrics.counter(
                    "stats_surrogates_total",
                    help="null surrogates evaluated").inc(
                        c_hi - c_lo, family=family)
            new_state = dict(folded)
            if dist is not None:
                new_state["dist"] = dist
            carry["step"] = step + n_steps
            carry["state"] = folded
            carry["dist"] = dist
            return new_state, False

        state, _ = run_resilient_loop(
            run_chunk, init_state, n_chunks,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            fingerprint=fingerprint, name="stats",
            guard_skip=_NAN_LEAVES)

        acc = NullAccumulator.from_state(
            {k: _host(v) for k, v in state.items() if k != "dist"})
        null = torch.as_tensor(state["dist"], device=spec.device) \
            if return_distribution else None
        hist = {k: torch.as_tensor(state[k], device=spec.device)
                for k in ("pos", "neg", "small", "n_finite")}
        result = NullDistribution(
            family, statistic, seed, side, spec.exact, observed, acc,
            distribution=None if null is None else null.cpu().numpy(),
            null_tensor=null, hist=hist)
        if result.complete:
            result.compute_thresholds()
        return result

    @staticmethod
    def _fingerprint(data, spec, statistic, seed, lo, hi, chunk_len,
                     batch):
        flat = np.nan_to_num(np.asarray(data, dtype=float))
        return np.asarray([
            array_digest(flat),
            array_digest(np.asarray(spec.xs, dtype=float)),
            float(zlib.crc32(spec.family.encode())),
            float(zlib.crc32(str(statistic).encode())),
            float(-1 if seed is None else int(seed)),
            float(spec.n_total), float(lo), float(hi),
            float(chunk_len), float(batch),
        ], dtype=float)
