"""Retry with exponential backoff for transient failures (the port's).

A copy of ``brainiak_tpu.resilience.retry``.  The I/O edges of the
port retry with exponential backoff and structured logging, and give
up with the original exception once the budget is exhausted: wired
into ``CheckpointManager.save``/``restore``
(:mod:`brainiak_tpu_torch.utils.checkpoint`).

With :mod:`brainiak_tpu_torch.obs` enabled, each retry emits a
``retry`` event and a ``retry_total{site=...}`` increment, and
exhausting the budget emits ``retry_exhausted`` and dumps the flight
recorder.
"""

import functools
import logging
import random
import time

from ..obs import metrics as obs_metrics
from ..obs import sink as obs_sink

logger = logging.getLogger(__name__)

__all__ = ["retry"]

# Test seam: monkeypatch to avoid real sleeping in unit tests.
_sleep = time.sleep


def retry(fn=None, *, retries=3, backoff=0.5, jitter=0.1,
          retriable=(OSError,), retry_if=None, name=None):
    """Retry ``fn`` on transient exceptions with exponential backoff.

    Usable bare (``@retry``), configured (``@retry(retries=5)``), or
    inline (``retry(fn, ...)``) — the last form returns the wrapped
    callable, it does not call it.

    Parameters
    ----------
    retries : int, default 3
        Additional attempts after the first failure (so up to
        ``retries + 1`` calls).
    backoff : float, default 0.5
        Base delay in seconds; attempt ``i`` (0-based) sleeps
        ``backoff * 2**i``, scaled by jitter.  ``0`` disables sleeping.
    jitter : float, default 0.1
        Each delay is multiplied by ``1 + uniform(0, jitter)`` so
        simultaneously-preempted hosts do not retry in lockstep.
    retriable : tuple of exception types, default ``(OSError,)``
        Only these are retried; anything else propagates immediately.
    retry_if : callable, optional
        Extra predicate over a type-matched exception; returning False
        propagates it immediately.  Lets a caller retry only the
        transient subset of a broad type (e.g. connection-shaped
        ``RuntimeError`` but not deterministic misconfiguration).
    name : str, optional
        Label used in log records (default: the function's name).
    """

    def decorate(func):
        label = name or getattr(func, "__name__", repr(func))

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            for attempt in range(retries + 1):
                try:
                    return func(*args, **kwargs)
                except retriable as exc:
                    if retry_if is not None and not retry_if(exc):
                        raise
                    if attempt >= retries:
                        logger.error(
                            "retry[%s]: giving up after %d attempts "
                            "(%s: %s)", label, attempt + 1,
                            type(exc).__name__, exc)
                        obs_sink.event(
                            "retry_exhausted", site=label,
                            attempts=attempt + 1,
                            error=type(exc).__name__)
                        from ..obs import flight
                        flight.dump(
                            "retry_exhausted",
                            state={"site": label,
                                   "attempts": attempt + 1,
                                   "error": f"{type(exc).__name__}: "
                                            f"{exc}"})
                        raise
                    delay = backoff * (2.0 ** attempt)
                    if jitter:
                        delay *= 1.0 + random.random() * jitter
                    logger.warning(
                        "retry[%s]: attempt %d/%d failed (%s: %s); "
                        "retrying in %.2fs", label, attempt + 1,
                        retries + 1, type(exc).__name__, exc, delay)
                    obs_sink.event(
                        "retry", site=label, attempt=attempt + 1,
                        error=type(exc).__name__, delay_s=delay)
                    obs_metrics.counter(
                        "retry_total",
                        help="transient-failure retries").inc(
                            site=label)
                    if delay > 0:
                        _sleep(delay)
            raise AssertionError("unreachable")  # pragma: no cover

        return wrapper

    if fn is not None:
        return decorate(fn)
    return decorate
