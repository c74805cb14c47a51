"""Non-finite-state guards and the resilient fit-loop driver (the port's).

A copy of ``brainiak_tpu.resilience.guards``: the same loop, events,
metrics and order of calls, with torch tensors where the JAX package
moves jax arrays.  Every iterative estimator advances a flat dict of
state arrays chunk by chunk, and :func:`run_resilient_loop` drives
that shape uniformly:

- **guard** — after each chunk the new state is checked for NaN/Inf
  (:func:`check_state`); a non-finite leaf triggers a rollback to the
  last good state and a deterministic re-run of the chunk, and after
  ``max_rollbacks`` consecutive failures the fit aborts with a
  :class:`DivergenceError` naming the offending leaves and iteration;
- **checkpoint/resume** — with ``checkpoint_dir`` the state is
  persisted every ``checkpoint_every`` iterations through
  :class:`~brainiak_tpu_torch.utils.checkpoint.CheckpointManager` (npz
  files the JAX package's npz path also reads and writes) and a later
  call resumes from the latest step, validated against a data/config
  ``fingerprint``;
- **fault hooks** — :mod:`brainiak_tpu_torch.resilience.faults`
  injection points (``nan`` corruption before the guard, ``preempt``
  after each checkpoint save);
- **telemetry** — with :mod:`brainiak_tpu_torch.obs` enabled every
  chunk runs under a ``fit_chunk`` span and the loop emits
  ``resume``/``rollback``/``checkpoint``/``divergence_abort`` events
  plus ``fit_steps_total``/``rollback_total``/``checkpoint_seconds``
  metrics and per-chunk memory watermarks
  (``hbm_peak_bytes``/``hbm_bytes_in_use``/``host_peak_rss_bytes``
  via :func:`brainiak_tpu_torch.obs.profile.memory_watermark`), all
  labeled with the loop ``name`` (disabled: no-ops).

A chunk on the card keeps its leaves there:
:func:`make_device_carry_chunk` carries the device tensors from chunk
to chunk and hands the loop host copies, fetched once a chunk — the
loop's only device read.
"""

import contextlib
import logging
import threading
import time

import numpy as np
import torch

from . import faults
from ..device import resolve_device
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import profile as obs_profile
from ..obs import progress as obs_progress
from ..obs import sanitize as obs_sanitize
from ..obs import sink as obs_sink
from ..obs import spans as obs_spans

logger = logging.getLogger(__name__)

__all__ = ["DivergenceError", "FitParked", "array_digest",
           "check_state", "leaves_to_device", "make_device_carry_chunk",
           "pack_rng_state", "park_scope", "run_resilient_loop",
           "unpack_rng_state"]


def array_digest(*arrays):
    """Order-sensitive content digest of arrays for checkpoint
    fingerprints.

    A plain ``sum(data)`` is ~0 for demeaned/z-scored inputs (the
    common fMRI preprocessing), and a sum of squares is constant for
    per-voxel z-scored data — either would let a checkpoint from one
    dataset silently resume against another of the same shape.  The
    cosine-ramp inner product is position- and content-sensitive;
    the squared term additionally scales with magnitude.  Tensors are
    read through a float64 host copy, so the digest is the JAX
    package's on the same data.
    """
    total = 0.0
    for a in arrays:
        flat = _host(a).astype(float).ravel()
        ramp = np.cos(np.arange(flat.size, dtype=float))
        total += float(flat @ ramp) + float(flat @ flat)
    return total


def _host(leaf):
    """A numpy view or copy of a host array or a tensor (a CUDA tensor
    is copied to the host: one device read)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def leaves_to_device(state, keys, dtype=None, device="cuda"):
    """Return ``state``'s leaves at ``keys``, in order, as new tensors
    of ``dtype`` (a torch dtype; None keeps each leaf's) on
    ``device`` — the standard round-trip when an on-device chunk
    resumes from :func:`run_resilient_loop` state (host numpy after a
    checkpoint restore).  ``device`` defaults to ``"cuda"`` and raises
    without a card unless it is ``"cpu"``."""
    dev = resolve_device(device)
    return tuple(torch.tensor(_host(state[k]), dtype=dtype, device=dev)
                 for k in keys)


def _fetch(tensor):
    return tensor.detach().cpu().numpy()


def make_device_carry_chunk(chunk_fn, leaf_keys, fetch=_fetch,
                            dtype=None, device="cuda"):
    """Build ``(run_chunk, final_leaves)`` for an on-device fit.

    ``chunk_fn(leaves, n_steps) -> leaves`` advances the fit on
    ``device``.  The returned ``run_chunk`` feeds
    :func:`run_resilient_loop`: the host dict it returns (``fetch``
    of each leaf, by default a copy to numpy) serves the guard +
    checkpoint, while the device tensors are carried across chunks so
    the next chunk (and ``final_leaves(state, step)`` after the loop)
    reuse them directly — no re-upload per chunk.  On a resume or a
    rollback the carried step no longer matches and the leaves are
    rebuilt from the (host) driver state.
    """
    carry = {}

    def run_chunk(state, step, n_steps):
        if carry.get("step") == step:
            dev = carry["leaves"]
        else:
            dev = leaves_to_device(state, leaf_keys, dtype, device)
        dev = chunk_fn(dev, n_steps)
        carry["step"] = step + n_steps
        carry["leaves"] = dev
        return {k: fetch(v) for k, v in zip(leaf_keys, dev)}, False

    def final_leaves(state, step):
        if carry.get("step") == step:
            return carry["leaves"]
        # resumed straight to completion: no chunk ran this process
        return leaves_to_device(state, leaf_keys, dtype, device)

    return run_chunk, final_leaves


def pack_rng_state(rng):
    """Serialize a ``np.random.RandomState`` as two checkpointable
    arrays ``(keys uint32[624], meta float[3])``, or a
    ``torch.Generator`` (the port's explicit generator, CPU or CUDA)
    as ``(state uint8[n], meta float[0])`` — stochastic fit loops must
    persist their stream position for a resumed fit to reproduce the
    uninterrupted iterates."""
    if isinstance(rng, torch.Generator):
        return (rng.get_state().numpy().copy(),
                np.zeros(0, dtype=float))
    kind, keys, pos, has_gauss, cached = rng.get_state()
    assert kind == "MT19937"
    return (np.asarray(keys, dtype=np.uint32),
            np.array([pos, has_gauss, cached], dtype=float))


def unpack_rng_state(rng, keys, meta):
    """Restore a ``np.random.RandomState`` or a ``torch.Generator``
    from :func:`pack_rng_state` arrays (possibly round-tripped through
    a checkpoint)."""
    if isinstance(rng, torch.Generator):
        rng.set_state(torch.from_numpy(
            np.asarray(keys).astype(np.uint8)))
        return rng
    meta = np.asarray(meta, dtype=float)
    rng.set_state(("MT19937", np.asarray(keys).astype(np.uint32),
                   int(meta[0]), int(meta[1]), float(meta[2])))
    return rng


class DivergenceError(FloatingPointError):
    """An iterative fit produced non-finite state.

    Attributes
    ----------
    leaves : list of str
        Names of the offending state leaves.
    iteration : int or None
        Iteration at which the guard tripped.
    where : str or None
        Estimator / loop label.
    """

    def __init__(self, leaves, iteration=None, where=None):
        self.leaves = list(leaves)
        self.iteration = iteration
        self.where = where
        at = f" at iteration {iteration}" if iteration is not None else ""
        loop = f" in {where}" if where else ""
        super().__init__(
            f"non-finite values{loop}{at} in state leaves: "
            f"{', '.join(self.leaves)}")


class FitParked(RuntimeError):
    """A resilient fit stopped at a chunk boundary on request.

    Raised by :func:`run_resilient_loop` when the ambient
    :func:`park_scope` predicate returns true right after a checkpoint
    save — the fit's state is durably on disk, so re-invoking the same
    fit entry point with the same ``checkpoint_dir`` resumes under the
    same ``fit_id`` with cumulative wall-clock accounting.  This is the
    preemption primitive the jobs scheduler builds on; it is NOT an
    error in the fit itself.

    Attributes
    ----------
    step : int
        Iteration the checkpoint holds (where the resume will start).
    fit_id : str or None
        The fit's stable id (persisted in the checkpoint).
    name : str or None
        Loop label (``SRM.fit``, ...).
    """

    def __init__(self, step, fit_id=None, name=None):
        self.step = step
        self.fit_id = fit_id
        self.name = name
        loop = f"{name}: " if name else ""
        super().__init__(
            f"{loop}fit parked at iteration {step} "
            f"(fit_id={fit_id}); re-run with the same checkpoint_dir "
            f"to resume")


_park_local = threading.local()


@contextlib.contextmanager
def park_scope(should_park):
    """Make every :func:`run_resilient_loop` on this thread parkable.

    ``should_park`` is a zero-argument callable consulted exactly once
    per persisted chunk (right after the checkpoint save, and only when
    the loop has a ``checkpoint_dir`` — parking without a checkpoint
    would discard work).  When it returns true the loop finishes its
    progress stream with status ``"parked"`` and raises
    :class:`FitParked`.  Because the predicate fires once per chunk it
    doubles as the scheduler's chunk-grant meter: a closure counting
    its own invocations implements "run N chunks, then yield".

    Scopes nest; the innermost predicate wins and the previous one is
    restored on exit.  Predicate exceptions are swallowed (a broken
    scheduler must not kill a healthy fit).
    """
    prev = getattr(_park_local, "pred", None)
    _park_local.pred = should_park
    try:
        yield
    finally:
        _park_local.pred = prev


def _should_park():
    pred = getattr(_park_local, "pred", None)
    if pred is None:
        return False
    try:
        return bool(pred())
    except Exception:
        logger.exception("park predicate raised; ignoring")
        return False


def check_state(state, iteration=None, where=None, skip=(),
                nan_only=False):
    """Raise :class:`DivergenceError` if any floating leaf of ``state``
    (a flat dict of arrays or tensors) is non-finite.  A tensor is
    checked where it lies, one host read of its verdict.

    ``skip`` names leaves excluded from the check (e.g. log-likelihood
    histories that are NaN-padded by design); ``nan_only=True`` accepts
    infinities, for log-domain states where ``-inf`` is a legitimate
    zero probability.
    """
    bad = []
    for name, leaf in state.items():
        if name in skip:
            continue
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            bad_values = torch.isnan(leaf) if nan_only \
                else ~torch.isfinite(leaf)
            if bool(bad_values.any()):
                bad.append(name)
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind != "f":
            continue
        if nan_only:
            ok = not np.any(np.isnan(arr))
        else:
            ok = bool(np.all(np.isfinite(arr)))
        if not ok:
            bad.append(name)
    if bad:
        raise DivergenceError(bad, iteration=iteration, where=where)


def _fingerprint_mismatch(saved, fingerprint):
    if saved is None:
        return True
    saved = np.asarray(saved, dtype=float).reshape(-1)
    fingerprint = np.asarray(fingerprint, dtype=float).reshape(-1)
    if saved.shape != fingerprint.shape:
        return True
    # atol=0: the default atol=1e-8 would equate any two near-zero
    # components (e.g. data sums of demeaned inputs), defeating the
    # mismatch guard entirely
    return not np.allclose(saved, fingerprint, rtol=1e-10, atol=0.0)


#: Checkpoint bookkeeping leaves the loop owns (stripped from the
#: state handed to ``run_chunk``): the data/config fingerprint, the
#: fit_id (uint8[16] of its hex digits), and [cumulative wall
#: seconds, cumulative chunk count] — the latter two so a resumed
#: fit continues the same progress stream with honest rate/ETA
#: accounting instead of restarting the clock from zero.
_CKPT_META = ("fingerprint", "fit_id", "fit_wall")


def _encode_fit_id(fit_id):
    return np.frombuffer(fit_id.encode("ascii"),
                         dtype=np.uint8).copy()


def _decode_fit_id(leaf):
    try:
        raw = bytes(np.asarray(leaf).astype(np.uint8).tolist())
        fit_id = raw.decode("ascii")
        int(fit_id, 16)  # trace-id shaped or bust
        return fit_id
    except (ValueError, UnicodeDecodeError):
        return None


def run_resilient_loop(run_chunk, init_state, n_iter, *,
                       checkpoint_dir=None, checkpoint_every=5,
                       fingerprint=None, max_rollbacks=2,
                       name="fit", guard_skip=(), guard_nan_only=False,
                       progress_objective=None,
                       progress_direction="min"):
    """Drive an iterative fit resiliently; returns ``(state, step)``.

    Parameters
    ----------
    run_chunk : callable ``(state, step, n_steps) -> (state, done)``
        Advance the fit ``n_steps`` iterations from ``state`` (a flat
        dict mapping leaf name to array).  ``done=True`` signals early
        convergence.  Must be deterministic in ``(state, step)`` so a
        rollback re-run and a resume reproduce the original iterates.
    init_state : dict
        Fresh-start state (ignored when a checkpoint is resumed).
        A ``"done"`` leaf, when present, is interpreted as the early-
        convergence flag across checkpoint round trips.
    n_iter : int
        Total iteration budget.
    checkpoint_dir, checkpoint_every
        When ``checkpoint_dir`` is set, state is persisted every
        ``checkpoint_every`` iterations and the latest checkpoint is
        resumed (after fingerprint validation).
    fingerprint : 1-D float array, optional
        Data/config digest stored with each checkpoint; resuming
        against a different digest raises ``ValueError`` instead of
        silently mixing runs.
    max_rollbacks : int, default 2
        Consecutive guard-triggered rollbacks tolerated before the
        :class:`DivergenceError` propagates.
    name : str
        Label for logs and errors.
    guard_skip, guard_nan_only
        Forwarded to :func:`check_state`.
    progress_objective : str or callable, optional
        Objective hint for the fit-progress tracker
        (:class:`brainiak_tpu_torch.obs.progress.FitProgress`): a state
        leaf name (reduced with ``np.mean``) or ``state -> float``.
        Without it the fit still reports chunk cadence / ratio / ETA
        but no objective-trend telemetry.
    progress_direction : {"min", "max"}
        Whether ``progress_objective`` should decrease or increase
        as the fit converges (drives the divergence precursor).

    Every run owns a stable ``fit_id`` (persisted in the checkpoint,
    so a resume continues the same id) and emits one schema-v4
    ``progress`` record per chunk; on divergence abort the flight
    recorder dumps an incident snapshot
    (:func:`brainiak_tpu_torch.obs.flight.dump`).  The JAX package's
    ``template=`` (a restore template for sharded orbax checkpoints)
    has no counterpart: npz restores need none.
    """
    from ..utils.checkpoint import CheckpointManager

    if checkpoint_every < 1:
        raise ValueError(
            "checkpoint_every must be >= 1 (got {}); omit "
            "checkpoint_dir to disable checkpointing".format(
                checkpoint_every))
    mngr = None
    step = 0
    state = init_state
    saved_fit_id = None
    saved_wall, saved_chunks = 0.0, 0
    if checkpoint_dir is not None:
        mngr = CheckpointManager(checkpoint_dir)
        saved_step, saved = mngr.restore()
        if saved is not None:
            if fingerprint is not None and _fingerprint_mismatch(
                    saved.get("fingerprint"), fingerprint):
                raise ValueError(
                    "Checkpoint in {} was written for different data "
                    "or model settings; use a fresh "
                    "checkpoint_dir".format(checkpoint_dir))
            if saved_step > n_iter:
                raise ValueError(
                    "Checkpoint is at iteration {} but n_iter={}; use "
                    "a fresh checkpoint_dir or raise n_iter".format(
                        saved_step, n_iter))
            if "fit_id" in saved:
                saved_fit_id = _decode_fit_id(saved["fit_id"])
            if "fit_wall" in saved:
                wall = np.asarray(saved["fit_wall"],
                                  dtype=float).reshape(-1)
                if wall.size >= 2 and np.all(np.isfinite(wall[:2])):
                    saved_wall = float(wall[0])
                    saved_chunks = int(wall[1])
            state = {k: v for k, v in saved.items()
                     if k not in _CKPT_META}
            step = saved_step
            logger.info("%s: resumed from checkpoint at iteration %d",
                        name, step)
            obs_sink.event("resume", estimator=name, step=step,
                           fit_id=saved_fit_id)
            obs_metrics.counter(
                "resume_total",
                help="checkpoint resumes").inc(estimator=name)
    progress = obs_progress.FitProgress(
        name, n_iter, fit_id=saved_fit_id,
        objective=progress_objective, direction=progress_direction,
        n_chunks=-(-int(n_iter) // int(checkpoint_every)) or None,
        wall0=saved_wall, chunks0=saved_chunks)

    done = bool(np.asarray(state.get("done", False)).reshape(-1)[0]) \
        if isinstance(state, dict) and "done" in state else False
    last_good = (step, state)
    rollbacks = 0
    while step < n_iter and not done:
        n_steps = min(checkpoint_every, n_iter - step)
        try:
            # run_chunk may itself raise DivergenceError from a
            # per-iteration check_state; it gets the same rollback.
            # The span is a no-op while obs is disabled (and never
            # introduces a device sync either way: run_chunk returns
            # host-checkpointable state by contract).  Memory
            # watermarks bracket the chunk: the delta of the device
            # high-water mark across the chunk becomes
            # hbm_peak_bytes{estimator=} (never a CUDA context, never
            # a sync — the allocator's counters are host-side reads).
            watermark = obs_profile.memory_watermark() \
                if obs_sink.enabled() else None
            t_chunk = time.perf_counter()
            with obs_spans.span(
                    "fit_chunk",
                    attrs={"estimator": name, "step": step,
                           "n_steps": n_steps,
                           "fit_id": progress.fit_id}):
                if obs_sanitize.enabled():
                    # the sanitizer lane (BRAINIAK_TPU_SANITIZE=1): a
                    # non-finite value in the chunk's output emits a
                    # typed ``sanitizer`` event and feeds the
                    # rollback machinery like any other divergence
                    sanitizer_error, (new_state, done) = \
                        obs_sanitize.call_checked(
                            run_chunk, (state, step, n_steps),
                            site=name, scope="resilient_loop")
                    if sanitizer_error is not None:
                        raise DivergenceError(
                            ["sanitizer:" + sanitizer_error
                             .splitlines()[0].strip()],
                            iteration=step + n_steps, where=name)
                else:
                    new_state, done = run_chunk(state, step, n_steps)
            if watermark is not None:
                obs_profile.memory_watermark(estimator=name,
                                             before=watermark)
            new_state = faults.corrupt_state(new_state, step + n_steps,
                                             site=name)
            # progress observes the PRE-guard state: a non-finite or
            # trend-worsening objective fires the typed
            # divergence_precursor event strictly before the guard
            # below can trip (and before its rollback/abort events)
            progress.observe(new_state, step + n_steps, n_steps,
                             time.perf_counter() - t_chunk)
            check_state(new_state, iteration=step + n_steps, where=name,
                        skip=guard_skip, nan_only=guard_nan_only)
        except DivergenceError as exc:
            rollbacks += 1
            progress.note_rollback()
            if rollbacks > max_rollbacks:
                logger.error("%s: %s; %d consecutive rollbacks "
                             "exhausted", name, exc, max_rollbacks)
                obs_sink.event("divergence_abort", estimator=name,
                               step=last_good[0],
                               leaves=list(exc.leaves),
                               fit_id=progress.fit_id)
                progress.finish("diverged")
                obs_flight.dump(
                    "divergence_abort", fit_id=progress.fit_id,
                    state={"estimator": name, "step": last_good[0],
                           "failed_step": step + n_steps,
                           "leaves": list(exc.leaves),
                           "rollbacks": progress.rollbacks})
                raise
            logger.warning(
                "%s: %s; rolling back to iteration %d "
                "(rollback %d/%d)", name, exc, last_good[0], rollbacks,
                max_rollbacks)
            obs_sink.event("rollback", estimator=name,
                           from_step=step + n_steps,
                           to_step=last_good[0],
                           leaves=list(exc.leaves), attempt=rollbacks,
                           fit_id=progress.fit_id)
            obs_metrics.counter(
                "rollback_total",
                help="non-finite-guard rollbacks").inc(estimator=name)
            step, state = last_good
            done = False
            continue
        rollbacks = 0
        step += n_steps
        state = new_state
        last_good = (step, state)
        obs_metrics.counter(
            "fit_steps_total",
            help="iterations advanced by guarded fit loops").inc(
                n_steps, estimator=name)
        if mngr is not None:
            to_save = {k: _host(v) for k, v in state.items()}
            if fingerprint is not None:
                to_save["fingerprint"] = np.asarray(fingerprint,
                                                    dtype=float)
            to_save["fit_id"] = _encode_fit_id(progress.fit_id)
            # host-side floats, not device state: no sync happens
            to_save["fit_wall"] = np.array(
                [progress.fit_wall_s, progress.chunk], dtype=float)
            t_save = time.perf_counter()
            mngr.save(step, to_save)
            dt_save = time.perf_counter() - t_save
            obs_metrics.histogram(
                "checkpoint_seconds", unit="s",
                help="checkpoint save wall time").observe(
                    dt_save, estimator=name)
            obs_sink.event("checkpoint", estimator=name, step=step,
                           seconds=dt_save, fit_id=progress.fit_id)
        faults.preempt_point(step, site=name)
        # park check: once per persisted chunk, checkpointed loops
        # only (the predicate fires after the save, so the raised
        # FitParked always has a durable resume point behind it);
        # a finished fit is never parked — it returns normally below
        if mngr is not None and step < n_iter and not done \
                and _should_park():
            obs_sink.event("parked", estimator=name, step=step,
                           fit_id=progress.fit_id)
            obs_metrics.counter(
                "fit_parked_total",
                help="resilient fits parked at a chunk boundary "
                     "by a park_scope predicate").inc(estimator=name)
            progress.finish("parked")
            raise FitParked(step, fit_id=progress.fit_id, name=name)
    progress.finish("converged" if done else "completed")
    return state, step
