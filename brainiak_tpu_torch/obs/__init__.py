"""brainiak_tpu_torch.obs: structured tracing, metrics and telemetry.

The core of ``brainiak_tpu.obs`` that the port's resilient fits and
instrumented paths call, with the JAX package's record schema, event
and metric names, and environment variables
(``BRAINIAK_TPU_OBS_DIR``, ``BRAINIAK_TPU_OBS_RANK``,
``BRAINIAK_TPU_OBS_MAX_MB``, ``BRAINIAK_TPU_SANITIZE``), so one
setting configures either package and one report reads both:

- :mod:`~brainiak_tpu_torch.obs.sink` — schema-versioned record
  dispatch: per-process JSON-lines files and an in-memory sink;
- :mod:`~brainiak_tpu_torch.obs.spans` — hierarchical spans whose
  ``sync`` target synchronizes the CUDA devices it names;
- :mod:`~brainiak_tpu_torch.obs.metrics` with
  :mod:`~brainiak_tpu_torch.obs.sketch` — typed counter / gauge /
  histogram registry with mergeable quantile sketches;
- :mod:`~brainiak_tpu_torch.obs.progress` — per-chunk fit progress
  and convergence telemetry (schema-v4 ``progress`` records);
- :mod:`~brainiak_tpu_torch.obs.flight` — the always-on flight
  recorder and its incident snapshots;
- :mod:`~brainiak_tpu_torch.obs.profile` — ``memory_watermark``, the
  CUDA allocator's and the host's high-water marks around fit chunks;
- :mod:`~brainiak_tpu_torch.obs.sanitize` — ``call_checked``, a
  finiteness check of chunk outputs.

Disabled by default: with no sink configured every instrumentation
site is a no-op (no records, no CUDA synchronize).

Not ported yet (ROADMAP item 13): the program collectors
(``obs.runtime``), ``profile_program`` with its cost records and
``profiling``, and ``report``, ``export``, ``regress``, ``trace``,
``http``, ``slo``, ``watch``, ``postmortem``, ``livecheck`` and
``fitcheck``.
"""

from .flight import (  # noqa: F401
    FLIGHT_DIR_ENV,
    FLIGHT_RECORDS_ENV,
)
from .flight import dump as flight_dump  # noqa: F401
from .flight import records as flight_records  # noqa: F401
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    collect,
    counter,
    default_registry,
    gauge,
    histogram,
)
from .profile import memory_watermark  # noqa: F401
from .progress import (  # noqa: F401
    FitProgress,
    active_fits,
    new_fit_id,
)
from .sketch import QuantileSketch  # noqa: F401
from .sink import (  # noqa: F401
    OBS_DIR_ENV,
    OBS_MAX_MB_ENV,
    SCHEMA_VERSION,
    JsonlSink,
    MemorySink,
    add_sink,
    emit,
    enabled,
    event,
    make_record,
    remove_sink,
    suspended,
    validate_record,
)
from .spans import (  # noqa: F401
    current_span,
    reset_stage_times,
    span,
    stage_timer,
    stage_times,
    traced,
)

__all__ = [
    "FLIGHT_DIR_ENV",
    "FLIGHT_RECORDS_ENV",
    "OBS_DIR_ENV",
    "OBS_MAX_MB_ENV",
    "SCHEMA_VERSION",
    "Counter",
    "FitProgress",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "MemorySink",
    "MetricsRegistry",
    "QuantileSketch",
    "active_fits",
    "add_sink",
    "collect",
    "counter",
    "current_span",
    "default_registry",
    "emit",
    "enabled",
    "event",
    "flight_dump",
    "flight_records",
    "gauge",
    "histogram",
    "make_record",
    "memory_watermark",
    "new_fit_id",
    "remove_sink",
    "reset_stage_times",
    "span",
    "stage_timer",
    "stage_times",
    "suspended",
    "traced",
    "validate_record",
]
