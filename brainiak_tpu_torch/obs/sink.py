"""Observability sinks of the port: where span/event/metric records go.

A copy of ``brainiak_tpu.obs.sink``: the same record schema
(:data:`SCHEMA_VERSION`, :func:`validate_record`), the same
environment variables and the same file names, so a record either
package emits passes the other's :func:`validate_record` and one
report reads both.  Two sinks exist:

- :class:`JsonlSink` — one JSON-lines file per process
  (``obs-<rank>.jsonl``), append-mode, flushed on every write and
  closed atexit.  Activated automatically when the
  ``BRAINIAK_TPU_OBS_DIR`` environment variable names a directory.
- :class:`MemorySink` — an in-process record list for tests and for
  ``chip_smoke.py``'s span checks.

The module-level dispatch (:func:`emit`) fans a record out to every
active sink.  **Disabled is the default**: with no sink registered and
no ``BRAINIAK_TPU_OBS_DIR``, :func:`enabled` is False and every
instrumentation site of the port short-circuits to a no-op — in
particular no CUDA synchronize is introduced in instrumented paths.

Two probes of the JAX package ask torch here: :func:`process_rank`
reads ``torch.distributed`` and :func:`backend_initialized` reads
``torch.cuda.is_initialized()``.  Neither creates a CUDA context.
"""

import atexit
import contextlib
import io
import json
import logging
import os
import threading
import time

import torch

logger = logging.getLogger(__name__)

__all__ = [
    "ACCEPTED_VERSIONS",
    "OBS_DIR_ENV",
    "OBS_MAX_MB_ENV",
    "OBS_RANK_ENV",
    "SCHEMA_VERSION",
    "JsonlSink",
    "MemorySink",
    "add_sink",
    "all_sinks",
    "backend_initialized",
    "close_all",
    "emit",
    "enabled",
    "event",
    "make_record",
    "process_rank",
    "remove_sink",
    "suspended",
    "validate_record",
]

OBS_DIR_ENV = "BRAINIAK_TPU_OBS_DIR"
OBS_RANK_ENV = "BRAINIAK_TPU_OBS_RANK"

#: Version stamped into every record as ``"v"``: the JAX package's.
#: v2 added the ``cost`` kind (program cost attribution), v3 the
#: optional request-tracing fields ``trace_id``/``span_id``/
#: ``parent_id`` on span and event records, v4 the ``progress`` kind
#: (per-chunk fit progress, :mod:`brainiak_tpu_torch.obs.progress`)
#: and the optional ``fit_id`` field on span and event records.
#: v1–v3 records remain valid.  The port emits no ``cost`` records
#: yet; the schema accepts them so both packages validate alike.
SCHEMA_VERSION = 4
ACCEPTED_VERSIONS = (1, 2, 3, 4)

KINDS = ("span", "event", "metric", "cost", "progress")
METRIC_TYPES = ("counter", "gauge", "histogram")

OBS_MAX_MB_ENV = "BRAINIAK_TPU_OBS_MAX_MB"

# backend-derived process rank, cached once resolvable (see
# process_rank: a process's rank never changes after distributed init)
_cached_rank = None

_NUM = (int, float)
_REQUIRED = {
    "span": {"dur_s": _NUM, "path": str},
    "event": {},
    "metric": {"mtype": str, "value": _NUM},
    "cost": {"site": str},
    # progress (schema v4): one record per resilient-loop chunk
    # (obs.progress) — the fit_id joins a fit's records across
    # process restarts (it rides in the checkpoint)
    "progress": {"fit_id": str, "estimator": str, "chunk": _NUM,
                 "step": _NUM, "ratio": _NUM},
}
_OPTIONAL = {
    # trace_id/span_id/parent_id (schema v3): request-scoped tracing
    # (obs.trace) — a span/event may belong to one request's
    # end-to-end trace, with parent_id naming the causally-preceding
    # span so the export CLI reconstructs per-request flows;
    # fit_id (schema v4): the owning fit's progress stream
    "span": {"attrs": dict, "trace_id": str, "span_id": str,
             "parent_id": str, "fit_id": str},
    "event": {"attrs": dict, "trace_id": str, "span_id": str,
              "parent_id": str, "fit_id": str},
    "metric": {"labels": dict, "unit": str},
    # cost: FLOPs/bytes may be absent (backend without cost_analysis
    # reports `unavailable` instead); span/estimator are join hints
    # for the report CLI's roofline computation
    "cost": {"flops": _NUM, "bytes_accessed": _NUM,
             "transcendentals": _NUM, "compile_s": _NUM,
             "hlo_bytes": int, "hlo_lines": int, "peak_flops": _NUM,
             "level": str, "backend": str, "span": str,
             "estimator": str, "unavailable": str, "attrs": dict},
    # objective / ETA telemetry may be absent: a fit without a
    # progress_objective hint still reports chunk cadence and ratio
    "progress": {"n_chunks": _NUM, "n_iter": _NUM, "epoch": _NUM,
                 "objective": _NUM, "delta": _NUM, "rollbacks": _NUM,
                 "chunk_s": _NUM, "fit_wall_s": _NUM, "rate": _NUM,
                 "eta_s": _NUM, "plateaued": bool, "attrs": dict},
}


def validate_record(rec):
    """Return a list of schema-violation strings (empty = valid).

    Checked: the common envelope (``v``/``kind``/``ts``/``rank``/
    ``name``), kind-specific required keys with their types, optional
    keys with their types, and that no unknown keys are present.
    """
    errors = []
    if not isinstance(rec, dict):
        return ["record is not an object"]
    v = rec.get("v")
    if v not in ACCEPTED_VERSIONS:
        errors.append(f"v={v!r} (expected one of {ACCEPTED_VERSIONS})")
    kind = rec.get("kind")
    if kind not in KINDS:
        errors.append(f"kind={kind!r} (expected one of {KINDS})")
        return errors
    if kind == "cost" and isinstance(v, int) and v < 2:
        errors.append("cost records require schema v>=2")
    if kind == "progress" and isinstance(v, int) and v < 4:
        errors.append("progress records require schema v>=4")
    if not isinstance(rec.get("ts"), (int, float)):
        errors.append("ts missing or not a number")
    if not isinstance(rec.get("rank"), int):
        errors.append("rank missing or not an int")
    if not isinstance(rec.get("name"), str) or not rec.get("name"):
        errors.append("name missing or empty")
    required = _REQUIRED[kind]
    optional = _OPTIONAL[kind]
    for key, typ in required.items():
        val = rec.get(key)
        if not isinstance(val, typ) or isinstance(val, bool):
            errors.append(f"{kind}.{key}={val!r} (expected {typ})")
    for key, typ in optional.items():
        if key in rec and not isinstance(rec[key], typ):
            errors.append(
                f"{kind}.{key}={rec[key]!r} (expected {typ})")
    if kind == "metric" and rec.get("mtype") not in METRIC_TYPES:
        errors.append(f"metric.mtype={rec.get('mtype')!r} "
                      f"(expected one of {METRIC_TYPES})")
    known = {"v", "kind", "ts", "rank", "name"}
    known.update(required)
    known.update(optional)
    unknown = sorted(set(rec) - known)
    if unknown:
        errors.append(f"unknown key(s): {', '.join(unknown)}")
    return errors


def process_rank():
    """This process's rank for record attribution and sink filenames.

    ``BRAINIAK_TPU_OBS_RANK`` wins; otherwise
    ``torch.distributed.get_rank()`` once a process group is
    initialized; otherwise 0.  Records emitted before the process
    group exists therefore report rank 0; :class:`JsonlSink`
    re-resolves its filename per write, so later records land in the
    correct per-rank file.  Reading the rank touches no device.
    """
    global _cached_rank
    env = os.environ.get(OBS_RANK_ENV)
    if env is not None:
        try:
            return int(env)
        except ValueError:
            pass
    if _cached_rank is not None:
        # immutable once the process group exists — skip the
        # per-record probe on instrumented paths
        return _cached_rank
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    _cached_rank = int(dist.get_rank())
    return _cached_rank


def backend_initialized():
    """True when this process has a CUDA context already
    (``torch.cuda.is_initialized()``), checked without creating one:
    :func:`brainiak_tpu_torch.obs.profile.memory_watermark` reads
    device memory only then, so telemetry is never the first device
    touch (a checkpointed fit can resume to completion, and the CPU
    tests run, without one)."""
    return torch.cuda.is_initialized()


def make_record(kind, name, **fields):
    """Build a :data:`SCHEMA_VERSION` record envelope around
    ``fields``."""
    rec = {"v": SCHEMA_VERSION, "kind": kind, "ts": time.time(),
           "rank": process_rank(), "name": name}
    rec.update({k: v for k, v in fields.items() if v is not None})
    return rec


class MemorySink:
    """In-process sink: records accumulate in ``self.records``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.records = []   # guarded-by: _lock

    def write(self, record):
        with self._lock:
            self.records.append(record)

    def flush(self):
        pass

    def close(self):
        pass

    def clear(self):
        with self._lock:
            self.records.clear()


class JsonlSink:
    """Append records to ``<directory>/obs-<rank>.jsonl``.

    One file per host process (rank-suffixed) so multi-process runs
    never interleave writes; the report CLI aggregates the directory.
    The file opens lazily, flushes after every record (a crash must
    not lose the trace that explains it), and closes atexit through
    :func:`close_all`.  The rank is re-resolved per write: records
    emitted before ``torch.distributed`` initialization (when every
    process still reports rank 0) go to ``obs-0.jsonl``, and once the
    process group is up the sink reopens under the process's real
    rank — so steady-state records never interleave across processes.

    ``max_mb`` (default: the ``BRAINIAK_TPU_OBS_MAX_MB`` env var)
    caps the bytes this sink will write across all its rank files: a
    multi-day fit with per-chunk spans must not fill the disk.  On
    reaching the cap the sink writes ONE ``obs_truncated`` event (so
    the trace records its own incompleteness) and drops every later
    record — but keeps COUNTING them: :meth:`close` stamps one final
    ``obs_dropped`` event carrying ``dropped_total`` (the one record
    allowed past the cap), so ``obs report`` can state exactly how
    incomplete a truncated trace is instead of implying the run went
    quiet.  The in-process metric registry keeps aggregating
    regardless.
    """

    def __init__(self, directory, rank=None, max_mb=None):
        self.directory = directory
        self._rank = rank
        self._lock = threading.Lock()
        self._fh = None          # guarded-by: _lock
        self._open_path = None   # guarded-by: _lock
        if max_mb is None:
            env = os.environ.get(OBS_MAX_MB_ENV)
            try:
                max_mb = float(env) if env else None
            except ValueError:
                logger.warning("ignoring non-numeric %s=%r",
                               OBS_MAX_MB_ENV, env)
                max_mb = None
        self.max_bytes = None if not max_mb or max_mb <= 0 \
            else int(max_mb * 1024 * 1024)
        self._written = 0        # guarded-by: _lock
        self._truncated = False  # guarded-by: _lock
        self._dropped = 0        # guarded-by: _lock
        self._drop_stamped = False  # guarded-by: _lock

    @property
    def dropped_total(self):
        """Records dropped after the ``max_mb`` cap hit (0 while the
        sink is under the cap)."""
        with self._lock:
            return self._dropped

    @property
    def path(self):
        rank = self._rank if self._rank is not None else process_rank()
        return os.path.join(self.directory, f"obs-{rank}.jsonl")

    def _ensure_open(self):
        path = self.path
        if self._fh is None or self._open_path != path:
            if self._fh is not None:
                self._fh.close()
            os.makedirs(self.directory, exist_ok=True)
            self._fh = io.open(path, "a", encoding="utf-8")
            self._open_path = path
        return self._fh

    def write(self, record):
        with self._lock:
            if self._truncated:
                self._dropped += 1
                return
            line = json.dumps(record, default=_json_default) + "\n"
            if self.max_bytes is not None \
                    and self._written + len(line) > self.max_bytes:
                self._truncated = True
                # the record whose write tripped the cap is dropped
                # too (the marker takes its slot)
                self._dropped += 1
                line = json.dumps(make_record(
                    "event", "obs_truncated",
                    attrs={"limit_mb":
                           self.max_bytes / (1024 * 1024),
                           "written_bytes": self._written}),
                    default=_json_default) + "\n"
                logger.warning(
                    "obs sink reached %s cap (%.1f MB); dropping "
                    "further records", OBS_MAX_MB_ENV,
                    self.max_bytes / (1024 * 1024))
            fh = self._ensure_open()
            fh.write(line)
            fh.flush()
            self._written += len(line)

    def flush(self):
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self):
        with self._lock:
            # a truncated sink owes the trace its own drop count:
            # ONE final event past the cap (stamped once even across
            # repeated close() calls), so `obs report` renders
            # dropped_total instead of implying the run went quiet
            if self._truncated and self._dropped \
                    and not self._drop_stamped:
                self._drop_stamped = True
                line = json.dumps(make_record(
                    "event", "obs_dropped",
                    attrs={"dropped_total": self._dropped}),
                    default=_json_default) + "\n"
                try:
                    fh = self._ensure_open()
                    fh.write(line)
                    fh.flush()
                except OSError:  # disk full is how we got here
                    pass
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def _json_default(obj):
    """Serialize numpy scalars/arrays (and tensors) that leak into
    span attrs."""
    for attr in ("tolist", "item"):
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                continue
    return repr(obj)


# -- module-level dispatch --------------------------------------------

_sinks = []          # guarded-by: _lock
_env_sink = None     # guarded-by: _lock
_env_dir_seen = None  # guarded-by: _lock
# env sink disabled after a write failure
_env_broken = False  # guarded-by: _lock
# nesting depth of active suspended() blocks (see below)
_suspend_depth = 0   # guarded-by: _lock
_lock = threading.Lock()


@contextlib.contextmanager
def suspended():
    """Temporarily force :func:`enabled` False (nests; thread-wide).

    The obs-off reference lane for overhead measurement: the same
    work runs once with telemetry live and once under this block,
    without tearing down (and thereby closing) the registered sinks.
    Instrumented sites see plain disabled behavior — no records, no
    syncs."""
    global _suspend_depth
    with _lock:
        _suspend_depth += 1
    try:
        yield
    finally:
        with _lock:
            _suspend_depth -= 1


def add_sink(sink):
    """Register ``sink`` to receive every emitted record; returns it."""
    with _lock:
        _sinks.append(sink)
    return sink


def remove_sink(sink):
    """Unregister (and close) a sink added with :func:`add_sink`."""
    with _lock:
        if sink in _sinks:
            _sinks.remove(sink)
    sink.close()


def _configure_from_env():
    """Keep the env-var-driven JSONL sink in step with the current
    value of ``BRAINIAK_TPU_OBS_DIR`` (tests monkeypatch it)."""
    global _env_sink, _env_dir_seen, _env_broken
    directory = os.environ.get(OBS_DIR_ENV) or None
    if directory == _env_dir_seen:
        return
    with _lock:
        if directory == _env_dir_seen:
            return
        if _env_sink is not None:
            _env_sink.close()
        _env_sink = JsonlSink(directory) if directory else None
        _env_dir_seen = directory
        _env_broken = False  # a NEW dir gets a fresh chance


def enabled():
    """True when at least one sink is (or will be) active.

    This is the gate every instrumentation site checks first; it costs
    one list check plus one environ lookup, and instrumented code paths
    do no timing, no attribute building, and — critically — no CUDA
    synchronize when it returns False.

    An env-configured sink that was disabled by a write failure turns
    this False again, so instrumentation stops paying for records
    nobody can receive; pointing the env var at a DIFFERENT directory
    re-enables (it gets a fresh sink).  An active :func:`suspended`
    block wins over everything.
    """
    if _suspend_depth:
        return False
    if _sinks:
        return True
    directory = os.environ.get(OBS_DIR_ENV)
    if not directory:
        return False
    return not _env_broken or directory != _env_dir_seen


def all_sinks():
    """The currently-active sinks (explicit + env-configured);
    empty under an active :func:`suspended` block."""
    _configure_from_env()
    with _lock:
        if _suspend_depth:
            return []
        sinks = list(_sinks)
        if _env_sink is not None:
            sinks.append(_env_sink)
    return sinks


def emit(record):
    """Dispatch ``record`` to every active sink; returns the record.

    Telemetry must never break the instrumented application: a sink
    whose write raises (unwritable ``BRAINIAK_TPU_OBS_DIR``, disk
    full) is logged once and DISABLED for the rest of the process
    instead of propagating into the fit/retry/fetch call that
    happened to emit the record.

    Every emitted record is additionally mirrored into the
    flight-recorder ring (:mod:`brainiak_tpu_torch.obs.flight`) so an
    incident snapshot carries the records that led up to it.
    """
    from . import flight
    flight.record(record)
    for sink in all_sinks():
        try:
            sink.write(record)
        except Exception as exc:
            logger.warning(
                "obs sink %s failed (%s: %s); disabling it",
                type(sink).__name__, type(exc).__name__, exc)
            _disable_sink(sink)
    return record


def _disable_sink(sink):
    global _env_sink, _env_broken
    with _lock:
        if sink in _sinks:
            _sinks.remove(sink)
        if sink is _env_sink:
            # keep _env_dir_seen so the broken dir is not re-created
            # on the next emit, and mark it broken so enabled()
            # reverts to False (instrumentation stops paying)
            _env_sink = None
            _env_broken = True
    try:
        sink.close()
    except Exception:
        pass


def event(name, **attrs):
    """Emit an ``event`` record (no-op while obs is disabled).

    The one-liner instrumentation sites use: attribute values must be
    JSON-serializable (numpy scalars and tensors are coerced).  A ``fit_id``
    attribute is promoted to the record's top-level schema-v4 field so
    the event joins that fit's progress stream."""
    if not enabled():
        return None
    fit_id = attrs.pop("fit_id", None)
    return emit(make_record("event", name, attrs=attrs or None,
                            fit_id=fit_id))


def close_all():
    """Flush and close every sink (registered atexit)."""
    global _env_sink, _env_dir_seen, _env_broken
    with _lock:
        sinks = list(_sinks)
        if _env_sink is not None:
            sinks.append(_env_sink)
        _env_sink = None
        _env_dir_seen = None
        _env_broken = False
        del _sinks[:]
    for sink in sinks:
        try:
            sink.close()
        except Exception:  # never let telemetry mask an exit path
            pass


atexit.register(close_all)
