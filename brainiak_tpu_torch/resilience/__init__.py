"""Resilience of the port: preemption-safe fits, retry, and guards.

The JAX package's ``brainiak_tpu.resilience`` for the port's iterative
fits, with the same contract (``checkpoint_dir=`` /
``checkpoint_every=``), the same events and the same
``BRAINIAK_TPU_FAULT`` variable:

- :mod:`~brainiak_tpu_torch.resilience.retry` — exponential-backoff
  retry for transient failures (checkpoint I/O);
- :mod:`~brainiak_tpu_torch.resilience.guards` — non-finite-state
  guards with checkpoint rollback, and :func:`run_resilient_loop`,
  the chunked fit-loop driver;
- :mod:`~brainiak_tpu_torch.resilience.faults` — deterministic fault
  injection (``preempt`` / ``nan`` / ``io_error``) so the recovery
  paths are exercised in tests.
"""

from . import faults  # noqa: F401
from .faults import (  # noqa: F401
    InjectedIOError,
    PreemptionError,
    inject,
)
from .guards import (  # noqa: F401
    DivergenceError,
    FitParked,
    check_state,
    park_scope,
    run_resilient_loop,
)
from .retry import retry  # noqa: F401

__all__ = [
    "DivergenceError",
    "FitParked",
    "InjectedIOError",
    "PreemptionError",
    "check_state",
    "faults",
    "inject",
    "park_scope",
    "retry",
    "run_resilient_loop",
]
