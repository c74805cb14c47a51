"""Flight recorder of the port: an always-on ring of recent records.

A copy of ``brainiak_tpu.obs.flight``.  A long fit that dies leaves
nothing behind unless something was already recording when it died.
This module keeps a bounded in-memory ring
(``BRAINIAK_TPU_OBS_FLIGHT_RECORDS`` cap, default
:data:`DEFAULT_CAPACITY`) of the most recent spans / events / metrics /
progress records — fed by every
:func:`brainiak_tpu_torch.obs.sink.emit` and, independently of any
sink, by the fit-progress tracker
(:mod:`brainiak_tpu_torch.obs.progress`).

Appends are O(1) under the module lock and never block the emitting
thread on I/O.  :func:`dump` writes an incident snapshot —
``records.jsonl`` plus a ``manifest.json`` naming the trigger, the
implicated ``fit_id`` / ``trace_id`` and the caller's last-known
state — into (first match wins) an explicit directory argument,
``$BRAINIAK_TPU_OBS_FLIGHT_DIR``, or ``$BRAINIAK_TPU_OBS_DIR/incidents``;
with none of those set it is a silent no-op.  The port's dump
triggers are ``divergence_abort`` (resilience/guards), sanitizer trips
(obs/sanitize) and ``retry_exhausted`` (resilience/retry).  The
snapshot layout is the JAX package's, so its ``postmortem`` renders
either package's snapshots.
"""

import json
import logging
import os
import threading
import time
from collections import deque

logger = logging.getLogger(__name__)

__all__ = [
    "DEFAULT_CAPACITY",
    "FLIGHT_DIR_ENV",
    "FLIGHT_RECORDS_ENV",
    "capacity",
    "clear",
    "dump",
    "last_dump",
    "record",
    "records",
]

#: Ring capacity when ``BRAINIAK_TPU_OBS_FLIGHT_RECORDS`` is unset.
DEFAULT_CAPACITY = 512

FLIGHT_RECORDS_ENV = "BRAINIAK_TPU_OBS_FLIGHT_RECORDS"
FLIGHT_DIR_ENV = "BRAINIAK_TPU_OBS_FLIGHT_DIR"

_lock = threading.Lock()
_ring = None       # guarded-by: _lock (deque, maxlen = capacity)
_ring_cap = None   # guarded-by: _lock (capacity _ring was built with)
_seq = 0           # guarded-by: _lock (snapshot filename uniquifier)
_last_dump = None  # guarded-by: _lock ((path, ts, fit_id, trigger))


def capacity():
    """The configured ring capacity (env override, else default)."""
    env = os.environ.get(FLIGHT_RECORDS_ENV)
    if env:
        try:
            cap = int(env)
            if cap > 0:
                return cap
        except ValueError:
            pass
        logger.warning("ignoring invalid %s=%r", FLIGHT_RECORDS_ENV,
                       env)
    return DEFAULT_CAPACITY


def _ring_locked():
    """The ring, (re)built at the current capacity.  Callers hold
    ``_lock``."""
    global _ring, _ring_cap
    cap = capacity()
    if _ring is None or _ring_cap != cap:
        old = list(_ring) if _ring is not None else []
        _ring = deque(old[-cap:], maxlen=cap)
        _ring_cap = cap
    return _ring


def record(rec):
    """Append one record dict to the ring (O(1); oldest evicted)."""
    with _lock:
        _ring_locked().append(rec)


def records():
    """A snapshot list of the ring's records, oldest first."""
    with _lock:
        return list(_ring_locked())


def clear():
    """Empty the ring (test isolation)."""
    with _lock:
        if _ring is not None:
            _ring.clear()


def _resolve_dir(directory):
    if directory:
        return directory
    env = os.environ.get(FLIGHT_DIR_ENV)
    if env:
        return env
    obs_dir = os.environ.get("BRAINIAK_TPU_OBS_DIR")
    if obs_dir:
        return os.path.join(obs_dir, "incidents")
    return None


def dump(trigger, *, fit_id=None, trace_id=None, state=None,
         directory=None):
    """Write an incident snapshot of the ring; returns its path.

    ``trigger`` names the incident kind (``divergence_abort``,
    ``sanitizer``, ``retry_exhausted``, ...);
    ``fit_id``/``trace_id`` implicate the fit or request; ``state`` is
    the caller's last-known state — a small JSON-serializable dict
    (failing step, leaves, site) stamped into the manifest verbatim.
    With no resolvable target directory (see module docstring)
    returns None without writing anything.
    Dump failures are logged and swallowed: the flight recorder must
    never turn an incident into a second incident.
    """
    global _seq
    target = _resolve_dir(directory)
    if target is None:
        return None
    with _lock:
        ring = list(_ring_locked())
        cap = _ring_cap
        _seq += 1
        seq = _seq
    now = time.time()
    name = "incident-{}-{}-{}-{}".format(
        trigger, int(now * 1000), os.getpid(), seq)
    path = os.path.join(target, name)
    try:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "records.jsonl"), "w",
                  encoding="utf-8") as fh:
            for rec in ring:
                fh.write(json.dumps(rec, default=_json_default) + "\n")
        manifest = {
            "trigger": trigger,
            "ts": now,
            "fit_id": fit_id,
            "trace_id": trace_id,
            "n_records": len(ring),
            "capacity": cap,
            "state": state or {},
        }
        with open(os.path.join(path, "manifest.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=2, default=_json_default)
    except OSError as exc:
        logger.warning("flight dump for %s failed: %s", trigger, exc)
        return None
    global _last_dump
    with _lock:
        _last_dump = (path, now, fit_id, trigger)
    from . import sink
    if sink.enabled():
        sink.event("flight_dump", trigger=trigger, path=path,
                   n_records=len(ring), fit_id=fit_id)
    logger.info("flight recorder dumped %d records to %s (trigger: "
                "%s)", len(ring), path, trigger)
    return path


def last_dump(fit_id=None, since=None):
    """The most recent snapshot written by :func:`dump` (in this
    process) as ``{"path", "ts", "fit_id", "trigger"}``, or None.

    ``fit_id`` restricts the answer to a snapshot implicating that
    fit; ``since`` (epoch seconds) to one written at/after that time.
    """
    with _lock:
        hit = _last_dump
    if hit is None:
        return None
    path, ts, hit_fit, trigger = hit
    if fit_id is not None and hit_fit is not None and hit_fit != fit_id:
        return None
    if since is not None and ts < since:
        return None
    return {"path": path, "ts": ts, "fit_id": hit_fit,
            "trigger": trigger}


def _json_default(obj):
    for attr in ("tolist", "item"):
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                continue
    return repr(obj)
