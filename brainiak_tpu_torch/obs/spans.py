"""Hierarchical trace spans of the port, with a stream-aware stop.

A copy of ``brainiak_tpu.obs.spans``.  A span times a named region of
work.  Spans nest: each thread keeps a stack of active spans, and a
completed span's record carries its full ``path``
(``"fit/fit_chunk"``), so the span tree can be rebuilt per process.
Because a CUDA launch returns before the card has run it (work is
queued on a stream), a wall clock alone measures enqueue time, not
compute — :func:`span` accepts a ``sync`` target (a tensor, or a
dict / list / tuple of them; or one set on the yielded frame) whose
CUDA devices are synchronized before the clock stops.

Obs disabled (the default), every ``with span(...)`` is a no-op that
skips the sync entirely, so instrumented paths keep the card's queue
full (it is never drained for telemetry nobody is collecting).

:func:`stage_timer`/:func:`stage_times` are the legacy stage-timer
API; unlike :func:`span` it ALWAYS records into the in-process stage
registry (and always honors ``sync``).
"""

import contextlib
import functools
import logging
import threading
import time
from collections import defaultdict

import torch

from . import sink

logger = logging.getLogger(__name__)

__all__ = [
    "current_span",
    "reset_stage_times",
    "span",
    "stage_timer",
    "stage_times",
    "traced",
]

_registry_lock = threading.RLock()
_stage_times = defaultdict(list)
_local = threading.local()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Frame:
    """Mutable handle for an active span: set attributes or a late
    sync target from inside the ``with`` block."""

    __slots__ = ("name", "attrs", "sync")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.sync = None

    def set(self, key, value):
        self.attrs[key] = value
        return self


class _NullFrame:
    """Inert frame yielded when obs is disabled: attribute writes
    (``frame.sync = y``, per the documented late-sync pattern) are
    silently discarded — storing them would pin the last sync target
    in memory for nothing."""

    __slots__ = ()
    name = None
    attrs = None
    sync = None

    def set(self, key, value):
        return self

    def __setattr__(self, key, value):
        pass


_NULL = _NullFrame()


def current_span():
    """Name path of the innermost active span, or '' (this thread)."""
    return "/".join(f.name for f in _stack())


@contextlib.contextmanager
def span(name, sync=None, attrs=None):
    """Trace a named region; yields a frame for attrs / late sync.

    Parameters
    ----------
    name : str
        Span name; the emitted record's ``path`` prefixes it with the
        names of the enclosing active spans.
    sync : tensor, or dict / list / tuple of tensors, optional
        Each distinct CUDA device among its tensors is synchronized
        once (:func:`_block_until_ready`) before the clock stops, so
        queued device work is charged to this span instead of
        whichever later operation first touches the result.  Only
        honored while obs is enabled — a disabled span introduces no
        host sync.
    attrs : dict, optional
        Attributes stamped into the span record; the yielded frame's
        ``set(key, value)`` adds more from inside the block, and
        assigning ``frame.sync`` supplies a sync target computed
        inside the block.
    """
    if not sink.enabled():
        yield _NULL
        return
    frame = _Frame(name, attrs)
    stack = _stack()
    stack.append(frame)
    t0 = time.perf_counter()
    try:
        yield frame
    finally:
        # pop BEFORE syncing: a sync target whose computation failed
        # re-raises out of this block (recording a bogus unsynced
        # time would be worse), and a caller that catches and
        # continues (run_resilient_loop's rollback) must not inherit
        # a corrupted span stack / wrong paths
        path = "/".join(f.name for f in stack)
        if stack and stack[-1] is frame:
            stack.pop()
        else:  # pragma: no cover - unbalanced exit (generator abuse)
            try:
                stack.remove(frame)
            except ValueError:
                pass
        target = frame.sync if frame.sync is not None else sync
        if target is not None:
            _block_until_ready(target)
        dt = time.perf_counter() - t0
        # a fit_id attr is promoted to the top-level schema-v4 field
        # (same contract as sink.event) so fit_chunk spans join their
        # fit's progress stream
        fit_id = frame.attrs.pop("fit_id", None)
        sink.emit(sink.make_record(
            "span", name, path=path, dur_s=dt,
            attrs=frame.attrs or None, fit_id=fit_id))


def _cuda_devices(target, found):
    """Collect the CUDA devices of the tensors in ``target``."""
    if isinstance(target, torch.Tensor):
        if target.is_cuda:
            found.add(target.device)
    elif isinstance(target, dict):
        for value in target.values():
            _cuda_devices(value, found)
    elif isinstance(target, (list, tuple)):
        for value in target:
            _cuda_devices(value, found)
    return found


def _block_until_ready(target):
    """Synchronize every CUDA device that holds a tensor of
    ``target``, once each; CPU tensors, numpy arrays and other objects
    need none.  A failed launch surfaces here and propagates (a
    swallowed failure would record a bogus, unsynced time)."""
    for device in _cuda_devices(target, set()):
        torch.cuda.synchronize(device)


def traced(name=None, sync_result=False):
    """Decorator form of :func:`span`.

    ``@traced`` / ``@traced("label")`` wraps the function in a span
    (default label: the qualified name); ``sync_result=True``
    additionally synchronizes the devices of the return value before
    the span closes, for functions returning CUDA tensors.
    """
    if callable(name):  # bare @traced
        fn, name = name, None
        return traced()(fn)

    def decorate(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not sink.enabled():
                return fn(*args, **kwargs)
            with span(label) as frame:
                out = fn(*args, **kwargs)
                if sync_result:
                    frame.sync = out
                return out

        return wrapper

    return decorate


# -- legacy stage-timer API ------------------------------------------

@contextlib.contextmanager
def stage_timer(name, sync=None):
    """Time a pipeline stage; ``sync`` may be a tensor (or a dict /
    list / tuple of them) whose CUDA devices are synchronized before
    the clock stops (a launch returns before the card runs it).

    Results accumulate in a process-wide registry readable with
    :func:`stage_times` (thread-safe).  Deprecated in favor of
    :func:`span` — kept as a working alias because it always records
    locally (no sink required) and always syncs, which :func:`span`
    deliberately does not do while obs is disabled.

    Non-nesting: the emitted span record is prefixed with the path of
    the enclosing :func:`span`\\ s, but a stage does NOT become a
    parent for spans opened inside its block (they attach to the
    nearest real span).  Code that needs hierarchy should use
    :func:`span`.
    """
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        target = holder.get("sync", sync)
        if target is not None:
            _block_until_ready(target)
        dt = time.perf_counter() - t0
        with _registry_lock:
            _stage_times[name].append(dt)
        logger.debug("stage %s took %.3fs", name, dt)
        if sink.enabled():
            sink.emit(sink.make_record(
                "span", name, path=_span_path(name), dur_s=dt))


def _span_path(name):
    prefix = current_span()
    return f"{prefix}/{name}" if prefix else name


def stage_times():
    """Mapping of stage name -> list of durations (seconds)."""
    with _registry_lock:
        return {k: list(v) for k, v in _stage_times.items()}


def reset_stage_times():
    with _registry_lock:
        _stage_times.clear()
