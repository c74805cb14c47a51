"""Memory watermarks of the port's fit chunks.

The part of ``brainiak_tpu.obs.profile`` that the resilient loop
calls: :func:`memory_watermark`, a snapshot of the device's and the
host's memory high-water marks, emitted as delta gauges around each
``fit_chunk`` in
:func:`brainiak_tpu_torch.resilience.guards.run_resilient_loop`.  The
snapshot keys and the gauge names are the JAX package's.

The device figures are PyTorch's CUDA caching allocator's
(``torch.cuda.max_memory_allocated`` / ``memory_allocated`` on the
current device), read only once the process has a CUDA context: a
watermark never creates one.
"""

import sys

import torch

from . import metrics, sink

__all__ = ["memory_watermark"]


def _device_peaks():
    """(peak bytes allocated, bytes allocated) of the current CUDA
    device, or (None, None) while the process has no CUDA context
    (``sink.backend_initialized``): ``max_memory_allocated`` on an
    uninitialized device would create one, and a watermark read must
    never be the thing that first touches the card (a checkpointed fit
    can resume to completion without any device call)."""
    if not sink.backend_initialized():
        return None, None
    return (int(torch.cuda.max_memory_allocated()),
            int(torch.cuda.memory_allocated()))


def _host_rss_bytes():
    try:
        import resource
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except Exception:  # pragma: no cover - non-unix
        return None
    # linux reports kilobytes (macOS bytes; both monotonic peaks)
    return int(rss) * (1 if sys.platform == "darwin" else 1024)


def memory_watermark(estimator=None, before=None):
    """Snapshot device / host-memory high-water marks.

    With no arguments, returns ``{"hbm_peak", "hbm_in_use",
    "host_rss"}`` (device entries None without a CUDA context) —
    cheap enough to take before every fit chunk: two counter reads of
    the allocator, no synchronize.  With ``estimator`` and a
    ``before`` snapshot, additionally sets the delta gauges:

    - ``hbm_peak_bytes{estimator=}`` — growth of the device
      high-water mark across the chunk (the first chunk of a fit is
      where the working set peaks; later chunks read ~0);
    - ``hbm_bytes_in_use{estimator=}`` — absolute allocated bytes
      after the chunk;
    - ``host_peak_rss_bytes{estimator=}`` — absolute host peak RSS.

    Never creates a CUDA context and never raises: on the CPU only the
    host gauge is set.
    """
    peak, in_use = _device_peaks()
    snap = {"hbm_peak": peak, "hbm_in_use": in_use,
            "host_rss": _host_rss_bytes()}
    if estimator is None:
        return snap
    if peak is not None:
        prev = (before or {}).get("hbm_peak") or 0
        metrics.gauge(
            "hbm_peak_bytes", unit="bytes",
            help="device high-water-mark growth per fit chunk").set(
                max(peak - prev, 0), estimator=estimator)
    if in_use is not None:
        metrics.gauge(
            "hbm_bytes_in_use", unit="bytes",
            help="live device bytes after a fit chunk").set(
                in_use, estimator=estimator)
    if snap["host_rss"] is not None:
        metrics.gauge(
            "host_peak_rss_bytes", unit="bytes",
            help="host peak RSS").set(
                snap["host_rss"], estimator=estimator)
    return snap
