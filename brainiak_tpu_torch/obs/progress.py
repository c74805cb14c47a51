"""Fit-progress and convergence telemetry of the port's resilient loops.

A copy of ``brainiak_tpu.obs.progress``: the same records, events,
gauges and registry snapshots.  Every chunked fit driven by
:func:`brainiak_tpu_torch.resilience.guards.run_resilient_loop` owns a
:class:`FitProgress` tracker.  The tracker mints a stable ``fit_id``
(the loop persists it in the checkpoint, so a resumed fit continues
the same id), and on every chunk:

- emits one schema-v4 ``progress`` record (fit_id, estimator, chunk
  i-of-N, step, objective value and delta, cumulative rollback count,
  chunk wall, EWMA iteration rate, ETA) to the sinks while obs is
  enabled — and ALWAYS into the flight-recorder ring
  (:mod:`brainiak_tpu_torch.obs.flight`) and the in-process registry;
- maintains convergence telemetry: a bounded objective-trace ring,
  plateau detection (:data:`PLATEAU_CHUNKS` consecutive chunks moving
  less than :data:`PLATEAU_RTOL` relative), and a divergence-precursor
  signal — a non-finite objective, or the EWMA of *worsening*
  objective deltas turning positive — that fires one typed
  ``divergence_precursor`` event strictly BEFORE the loop's non-finite
  guard can trip;
- keeps the ``fit_progress_ratio{fit_id,estimator}`` and
  ``fit_eta_seconds{fit_id,estimator}`` gauges current.

Obs disabled adds **zero records and zero device syncs**: the
tracker's work is host arithmetic on state leaves that are host (NumPy)
arrays by the resilient-loop contract.

Objective extraction (``objective=`` hint): None (cadence/ETA only), a
state-leaf name (reduced with ``np.mean``, so one poisoned element
makes the extracted value non-finite and trips the precursor), or a
callable ``state -> float``.  Extraction errors are swallowed —
telemetry must never break the fit.
"""

import contextlib
import math
import os
import threading
import time

import numpy as np

from . import flight, metrics, sink

__all__ = [
    "EWMA_ALPHA",
    "OBJECTIVE_RING",
    "PLATEAU_CHUNKS",
    "PLATEAU_RTOL",
    "FitProgress",
    "active_fits",
    "add_finish_listener",
    "clear_registry",
    "current_context",
    "fit_context",
    "new_fit_id",
    "remove_finish_listener",
]

#: Smoothing for the chunk-rate and objective-delta EWMAs.
EWMA_ALPHA = 0.3

#: Objective-trace ring length carried per fit (the postmortem tail).
OBJECTIVE_RING = 32

#: Consecutive chunks with relative objective movement below
#: :data:`PLATEAU_RTOL` before the ``plateau`` event fires.
PLATEAU_CHUNKS = 5
PLATEAU_RTOL = 1e-4

#: Deltas observed before the EWMA trend may fire the precursor (a
#: single noisy first step must not cry divergence).
_TREND_WARMUP = 3

#: Finished fits retained in the registry for ``/jobs`` history.
_MAX_FINISHED = 32


def new_fit_id():
    """Mint a fit id: 16 hex chars, the trace-id idiom."""
    return os.urandom(8).hex()


def _finite_or_none(value):
    """Non-finite telemetry values are OMITTED from records, not
    serialized: ``json.dumps`` would write a bare ``NaN`` token,
    breaking every strict-JSON consumer of the sink files and the
    chrome-trace export (the precursor ``reason`` already names the
    non-finite objective)."""
    if value is None or not math.isfinite(value):
        return None
    return value


# -- ambient fit context (job/tenant attribution) ---------------------

_context_local = threading.local()


def current_context():
    """The ambient fit-context attrs for this thread (``{}`` outside
    any :func:`fit_context`)."""
    return dict(getattr(_context_local, "attrs", None) or {})


@contextlib.contextmanager
def fit_context(**attrs):
    """Attribute every fit started on this thread to ``attrs``.

    A scheduler wraps each fit invocation in
    ``fit_context(job_id=..., tenant=...)``; :class:`FitProgress`
    captures the ambient attrs at construction and carries them on
    every progress record (``attrs``), every fit event, and every
    registry snapshot, so a fit joins back to the job that
    scheduled it.
    ``None`` values are dropped; scopes nest (inner keys shadow
    outer ones) and restore on exit.
    """
    prev = getattr(_context_local, "attrs", None)
    merged = dict(prev or {})
    merged.update({k: v for k, v in attrs.items() if v is not None})
    _context_local.attrs = merged
    try:
        yield
    finally:
        _context_local.attrs = prev


# -- finish listeners (job-record feedback) ---------------------------

_listeners_lock = threading.Lock()
_finish_listeners = []  # guarded-by: _listeners_lock


def add_finish_listener(fn):
    """Register ``fn(snapshot)`` to run whenever any fit finishes.

    The snapshot is the final registry dict (fit_id, estimator,
    terminal ``status`` — ``converged``/``completed``/``diverged``/
    ``parked`` — plus any :func:`fit_context` attrs such as
    ``job_id``/``tenant``).  Listener exceptions are swallowed:
    telemetry must never break the fit.  Listeners run on the fit
    thread.
    """
    with _listeners_lock:
        if fn not in _finish_listeners:
            _finish_listeners.append(fn)


def remove_finish_listener(fn):
    """Unregister a :func:`add_finish_listener` callback (no-op if
    absent)."""
    with _listeners_lock:
        if fn in _finish_listeners:
            _finish_listeners.remove(fn)


def _notify_finish(snapshot):
    with _listeners_lock:
        listeners = list(_finish_listeners)
    for fn in listeners:
        try:
            fn(dict(snapshot))
        except Exception:
            pass


# -- in-process registry (feeds /jobs and the watch CLI) --------------

_registry_lock = threading.Lock()
_registry = {}   # guarded-by: _registry_lock (fit_id -> snapshot)
_order = []      # guarded-by: _registry_lock (fit_id insertion order)


def _publish(snapshot):
    fit_id = snapshot["fit_id"]
    with _registry_lock:
        if fit_id not in _registry:
            _order.append(fit_id)
        _registry[fit_id] = snapshot
        finished = [f for f in _order
                    if _registry[f]["status"] != "running"]
        for stale in finished[:-_MAX_FINISHED]:
            _order.remove(stale)
            del _registry[stale]


def active_fits():
    """Snapshots of every registered fit, oldest first — running
    fits plus the :data:`_MAX_FINISHED` most recent finished ones
    (each a plain JSON-serializable dict; the ``/jobs`` payload)."""
    with _registry_lock:
        return [dict(_registry[f]) for f in _order]


def clear_registry():
    """Drop every registered fit (test isolation)."""
    with _registry_lock:
        _registry.clear()
        del _order[:]


class FitProgress:
    """Per-fit progress/convergence tracker (one fit thread writes;
    readers see snapshots through :func:`active_fits`).

    Parameters
    ----------
    estimator : str
        The loop label (``SRM.fit``, ``stats``, ...).
    n_iter : int
        Total iteration budget of the fit.
    fit_id : str, optional
        Resume an existing id (from a checkpoint); default mints one.
    objective, direction
        Objective hint (see module docstring) and whether it should
        ``"min"``imize or ``"max"``imize.
    n_chunks : int, optional
        Planned chunk count (ceil(n_iter / checkpoint_every)).
    wall0, chunks0 : float, int
        Cumulative fit wall seconds / chunk count carried over from a
        resumed checkpoint, so post-resume rate and ETA estimates
        account for the work the previous process already did.
    """

    def __init__(self, estimator, n_iter, *, fit_id=None,
                 objective=None, direction="min", n_chunks=None,
                 wall0=0.0, chunks0=0):
        if direction not in ("min", "max"):
            raise ValueError(
                f"direction must be 'min' or 'max', got {direction!r}")
        self.estimator = estimator
        self.n_iter = max(int(n_iter), 0)
        self.fit_id = fit_id or new_fit_id()
        self.objective_spec = objective
        self.direction = direction
        self.n_chunks = int(n_chunks) if n_chunks else None
        self.context = current_context()
        self.chunk = int(chunks0)       # monotone observation count
        self.fit_wall_s = float(wall0)
        self.rollbacks = 0
        self.status = "running"
        self.objectives = []            # (step, value) tail, bounded
        self.last_objective = None
        self.rate = None                # EWMA iterations / second
        self.eta_s = None
        self.ratio = 0.0
        self.plateaued = False
        self.precursor_fired = False
        self._worsen_ewma = None
        self._n_deltas = 0
        self._plateau_run = 0

    # -- telemetry fan-out (sink when enabled; flight/registry always)

    def _emit_record(self, rec):
        # sink.emit already mirrors into the flight ring; tap it
        # directly ONLY when sinks are off, or every record would
        # land in incident snapshots twice
        if sink.enabled():
            sink.emit(rec)
        else:
            flight.record(rec)

    def _event(self, name, **attrs):
        merged = dict(self.context, **attrs)
        rec = sink.make_record("event", name, attrs=merged or None,
                               fit_id=self.fit_id)
        self._emit_record(rec)
        return rec

    # -- objective extraction -----------------------------------------

    def _extract(self, state):
        spec = self.objective_spec
        if spec is None:
            return None
        try:
            if callable(spec):
                value = spec(state)
            else:
                leaf = state[spec]
                arr = np.asarray(leaf, dtype=float)
                if arr.size == 0:
                    return None
                # mean: one poisoned element -> non-finite extract
                value = np.mean(arr)
            return None if value is None else float(value)
        except Exception:
            return None

    # -- the per-chunk observation ------------------------------------

    def note_rollback(self):
        """Count one guard-triggered rollback against this fit."""
        self.rollbacks += 1

    def observe(self, state, step, n_steps, chunk_s):
        """Record one completed chunk: ``state`` is the chunk's output
        (pre-guard), ``step`` the iteration it reached, ``n_steps``
        the iterations it advanced, ``chunk_s`` its wall seconds.
        Returns the progress record dict.

        Called by the loop BEFORE the non-finite guard, so the
        divergence precursor (non-finite or trend-worsening
        objective) is timestamped before any rollback/abort event.
        """
        self.chunk += 1
        self.fit_wall_s += float(chunk_s)
        denom = max(float(chunk_s), 1e-9)
        sample_rate = n_steps / denom
        self.rate = sample_rate if self.rate is None else \
            EWMA_ALPHA * sample_rate + (1 - EWMA_ALPHA) * self.rate
        self.ratio = min(step / self.n_iter, 1.0) \
            if self.n_iter else 1.0
        remaining = max(self.n_iter - step, 0)
        self.eta_s = remaining / self.rate if self.rate and \
            self.rate > 0 else None

        value = self._extract(state)
        delta = None
        precursor = None
        if value is not None:
            if not math.isfinite(value):
                precursor = "non_finite_objective"
            elif self.last_objective is not None:
                delta = value - self.last_objective
                worsening = delta if self.direction == "min" \
                    else -delta
                self._worsen_ewma = worsening \
                    if self._worsen_ewma is None else \
                    EWMA_ALPHA * worsening \
                    + (1 - EWMA_ALPHA) * self._worsen_ewma
                self._n_deltas += 1
                if self._n_deltas >= _TREND_WARMUP \
                        and self._worsen_ewma > 0:
                    precursor = "worsening_trend"
                scale = max(abs(value), abs(self.last_objective), 1.0)
                if abs(delta) <= PLATEAU_RTOL * scale:
                    self._plateau_run += 1
                else:
                    self._plateau_run = 0
            if math.isfinite(value):
                self.last_objective = value
                self.objectives.append((int(step), value))
                del self.objectives[:-OBJECTIVE_RING]

        if precursor and not self.precursor_fired:
            self.precursor_fired = True
            self._event(
                "divergence_precursor", estimator=self.estimator,
                chunk=self.chunk, step=int(step), reason=precursor,
                objective=_finite_or_none(value),
                ewma_worsening=_finite_or_none(self._worsen_ewma))
        if not self.plateaued and self._plateau_run >= PLATEAU_CHUNKS:
            self.plateaued = True
            self._event("plateau", estimator=self.estimator,
                        chunk=self.chunk, step=int(step),
                        objective=value, window=PLATEAU_CHUNKS,
                        rtol=PLATEAU_RTOL)

        rec = sink.make_record(
            "progress", "fit_progress", fit_id=self.fit_id,
            estimator=self.estimator, chunk=self.chunk,
            n_chunks=self.n_chunks, step=int(step),
            n_iter=self.n_iter, ratio=float(self.ratio),
            objective=_finite_or_none(value),
            delta=_finite_or_none(delta), rollbacks=self.rollbacks,
            chunk_s=float(chunk_s), fit_wall_s=self.fit_wall_s,
            rate=self.rate, eta_s=self.eta_s,
            plateaued=self.plateaued or None,
            attrs=self.context or None)
        self._emit_record(rec)
        # gauges update the in-process registry regardless (host-only
        # work); they emit metric records only while obs is enabled
        metrics.gauge(
            "fit_progress_ratio",
            help="fraction of the iteration budget a resilient fit "
                 "has completed").set(
                self.ratio, fit_id=self.fit_id,
                estimator=self.estimator)
        if self.eta_s is not None:
            metrics.gauge(
                "fit_eta_seconds", unit="s",
                help="EWMA-rate estimate of seconds until a "
                     "resilient fit completes").set(
                    self.eta_s, fit_id=self.fit_id,
                    estimator=self.estimator)
        self._publish_snapshot(rec["ts"], int(step))
        return rec

    def finish(self, status):
        """Mark the fit finished (``converged`` / ``completed`` /
        ``diverged`` / ``parked``), emit the ``fit_finished`` event,
        publish the final registry snapshot, and notify any
        :func:`add_finish_listener` callbacks with it — the hook the
        jobs scheduler uses to fold the fit outcome back into the
        owning job record (never a zombie "running" entry)."""
        self.status = status
        self._event("fit_finished", estimator=self.estimator,
                    status=status, chunk=self.chunk,
                    rollbacks=self.rollbacks,
                    fit_wall_s=self.fit_wall_s)
        snap = self._publish_snapshot(time.time(),
                                      self.objectives[-1][0]
                                      if self.objectives else None)
        _notify_finish(snap)

    def _publish_snapshot(self, ts, step):
        snap = dict(self.context)
        snap.update({
            "fit_id": self.fit_id,
            "estimator": self.estimator,
            "status": self.status,
            "chunk": self.chunk,
            "n_chunks": self.n_chunks,
            "step": step,
            "n_iter": self.n_iter,
            "ratio": self.ratio,
            "objective": self.last_objective,
            "rollbacks": self.rollbacks,
            "rate": self.rate,
            "eta_s": self.eta_s,
            "fit_wall_s": self.fit_wall_s,
            "plateaued": self.plateaued,
            "precursor": self.precursor_fired,
            "objective_tail": [v for _, v in self.objectives[-5:]],
            "ts": ts,
        })
        _publish(snap)
        return snap
