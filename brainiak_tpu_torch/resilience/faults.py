"""Deterministic fault injection for the port's resilience tests.

A copy of ``brainiak_tpu.resilience.faults``: the same kinds, the same
``BRAINIAK_TPU_FAULT="kind@step[xtimes]"`` variable and the same
``fault`` events, so one setting drives either package.  A long fit
dies in three characteristic ways: the scheduler preempts the host,
an iterative state diverges to NaN/Inf, and shared-filesystem I/O
fails transiently.  This module injects each of those at an exact,
reproducible point, so the recovery paths (checkpoint resume, guard
rollback, retry) are exercised by fast tests.

Usage::

    from brainiak_tpu_torch.resilience import faults

    with faults.inject("preempt", at_step=4):
        run_resilient_loop(..., checkpoint_dir=d)  # PreemptionError
    run_resilient_loop(..., checkpoint_dir=d)      # resumes at 4

Kinds
-----
``"preempt"``
    :func:`preempt_point` raises :class:`PreemptionError` at the first
    guarded-loop step ``>= at_step`` — *after* that step's checkpoint
    was persisted (dying mid-save is covered by the checkpoint
    writer's atomic rename).
``"nan"``
    :func:`corrupt_state` poisons one leaf of the loop state (a host
    copy) at the first step ``>= at_step``, exercising the non-finite
    guard's rollback (:mod:`brainiak_tpu_torch.resilience.guards`).
``"io_error"``
    :func:`io_point` raises :class:`InjectedIOError` (an ``OSError``)
    from inside retry-wrapped I/O (checkpoint save or restore).  Here
    ``at_step`` counts I/O calls to let through first.
``"replica_crash"`` and ``"slow_replica"``
    Accepted, so that a fault spec parses alike in both packages; the
    port has no serving loop to call their hooks yet.

Every fault fires ``times`` times (default 1) and is inert afterwards,
so a retry or rollback that re-runs the failed operation succeeds.
"""

import logging
import os
from contextlib import contextmanager

import numpy as np

from ..obs import sink as obs_sink

logger = logging.getLogger(__name__)

__all__ = [
    "FAULT_ENV_VAR",
    "InjectedIOError",
    "PreemptionError",
    "corrupt_state",
    "inject",
    "io_point",
    "preempt_point",
]

FAULT_ENV_VAR = "BRAINIAK_TPU_FAULT"

#: The JAX package's kinds, so that a fault spec parses alike in both
#: packages; the serving kinds have no hook in the port yet.
KINDS = ("preempt", "nan", "io_error", "replica_crash",
         "slow_replica")


class PreemptionError(RuntimeError):
    """Injected preemption: the fit process was 'killed' at a step."""


class InjectedIOError(OSError):
    """Injected transient I/O failure (retriable)."""


class _Fault:
    def __init__(self, kind, at_step=0, times=1, leaf=None):
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}; expected one of {KINDS}")
        self.kind = kind
        self.at_step = int(at_step)
        self.times = int(times)
        self.leaf = leaf
        self.fired = 0
        self.seen = 0  # io_error: calls observed so far

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"_Fault({self.kind!r}, at_step={self.at_step}, "
                f"times={self.times}, fired={self.fired})")


# Innermost-wins stack of active context-manager faults, plus at most
# one env-var fault (parsed once per distinct spec so it fires once per
# process, like a real environmental failure).
_active = []
_env_fault = None
_env_spec_seen = None


@contextmanager
def inject(kind, at_step=0, times=1, leaf=None):
    """Activate a fault for the dynamic extent of the ``with`` block.

    Yields the fault record; ``fault.fired`` afterwards tells a test
    whether the fault actually triggered."""
    fault = _Fault(kind, at_step=at_step, times=times, leaf=leaf)
    _active.append(fault)
    try:
        yield fault
    finally:
        _active.remove(fault)


def _from_env():
    """Parse ``BRAINIAK_TPU_FAULT="kind@step[xtimes]"`` lazily, once per
    distinct spec value."""
    global _env_fault, _env_spec_seen
    spec = os.environ.get(FAULT_ENV_VAR)
    if not spec:
        return None
    if spec != _env_spec_seen:
        _env_spec_seen = spec
        kind, _, rest = spec.partition("@")
        step_s, _, times_s = rest.partition("x")
        try:
            _env_fault = _Fault(kind.strip(),
                                at_step=int(step_s or 0),
                                times=int(times_s or 1))
        except ValueError:
            logger.warning("ignoring malformed %s=%r (expected "
                           "'kind@step[xtimes]')", FAULT_ENV_VAR, spec)
            _env_fault = None
    return _env_fault


def _match(kind):
    for fault in reversed(_active):
        if fault.kind == kind and fault.fired < fault.times:
            return fault
    env = _from_env()
    if env is not None and env.kind == kind and env.fired < env.times:
        return env
    return None


def preempt_point(step, site="fit"):
    """Hook called by guarded fit loops after persisting ``step``'s
    checkpoint; raises :class:`PreemptionError` when a ``"preempt"``
    fault has reached its trigger step."""
    fault = _match("preempt")
    if fault is not None and step >= fault.at_step:
        fault.fired += 1
        obs_sink.event("fault", kind="preempt", site=site, step=step)
        raise PreemptionError(
            f"injected preemption in {site} at step {step}")


def corrupt_state(state, step, site="fit"):
    """Hook called by guarded fit loops on each new chunk state; returns
    the state with one leaf poisoned with NaN when a ``"nan"`` fault has
    reached its trigger step.  ``state`` is a flat dict of arrays; the
    poisoned leaf is ``fault.leaf`` or the first floating-point leaf."""
    fault = _match("nan")
    if fault is None or step < fault.at_step:
        return state
    name = fault.leaf
    if name is None:
        for key, leaf in state.items():
            if np.asarray(leaf).dtype.kind == "f":
                name = key
                break
    if name is None or name not in state:
        logger.warning("nan fault at step %d: no such leaf %r", step,
                       fault.leaf)
        return state
    fault.fired += 1
    logger.info("injecting NaN into leaf %r of %s at step %d", name,
                site, step)
    obs_sink.event("fault", kind="nan", site=site, step=step,
                   leaf=name)
    # C order: a transposed tensor's host view is F-ordered, and
    # reshape(-1) of that is a copy, which would drop the NaN
    poisoned = np.array(np.asarray(state[name]), dtype=float, copy=True,
                        order="C")
    poisoned.reshape(-1)[0] = np.nan
    out = dict(state)
    out[name] = poisoned
    return out


def io_point(path="", site="io"):
    """Hook called at the top of retry-wrapped I/O operations; raises
    :class:`InjectedIOError` while an ``"io_error"`` fault is armed.
    ``at_step`` counts calls to let through before firing."""
    fault = _match("io_error")
    if fault is None:
        return
    fault.seen += 1
    if fault.seen > fault.at_step:
        fault.fired += 1
        obs_sink.event("fault", kind="io_error", site=site,
                       path=str(path))
        raise InjectedIOError(
            f"injected io_error in {site} for {path!r}")
