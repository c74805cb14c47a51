"""Runtime sanitizer of the port: a finiteness check of chunk outputs.

``BRAINIAK_TPU_SANITIZE=1`` (the JAX package's variable) routes the
chunks of :func:`~brainiak_tpu_torch.resilience.guards.run_resilient_loop`
through :func:`call_checked`.  A non-finite value in a chunk's output
surfaces as the JAX package's typed ``sanitizer`` obs event (``site``,
``scope``, ``error``, ``codes``), a ``sanitizer_errors_total``
increment and a flight-recorder dump, and feeds the loop's rollback.

torch has no counterpart of ``jax.experimental.checkify``, which
instruments the traced program itself.  So :func:`call_checked` runs
``fn`` once, as it is, and then checks every floating tensor and
ndarray of its output for NaN and Inf, with one host read for all the
tensors.  checkify's division-by-zero and out-of-bounds index checks,
and its report of the operation that first made a NaN, have no
counterpart here.  The check never runs another version of ``fn``.

Off (the default), every caller takes its original call path
untouched — zero extra syncs, zero extra records.  On, each checked
call pays one host read; the mode is a debugging lane.
"""

import os

import numpy as np
import torch

from . import metrics, sink

__all__ = ["call_checked", "enabled", "reset"]

_ENV = "BRAINIAK_TPU_SANITIZE"

#: The JAX package's cross-references of a trip: the static rules of
#: its numeric-discipline and index audits, kept so the ``sanitizer``
#: events of both packages carry the same codes.
_CHECK_CODES = ("JP301", "JP305")


def enabled():
    """Whether the sanitizer lane is on (``BRAINIAK_TPU_SANITIZE=1``)."""
    return os.environ.get(_ENV, "").strip() == "1"


def reset():
    """Drop the sanitizer's memoized state.  The port's check keeps
    none (nothing is traced or cached), so this does nothing; it
    stands for the JAX package's ``reset``."""


def _float_leaves(out, path, found):
    """Collect ``(path, leaf)`` for the floating tensors and ndarrays
    in ``out`` (nested dicts, lists and tuples)."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() or out.is_complex():
            found.append((path, out))
    elif isinstance(out, np.ndarray):
        if out.dtype.kind in "fc":
            found.append((path, out))
    elif isinstance(out, dict):
        for key, value in out.items():
            _float_leaves(value, f"{path}[{key!r}]", found)
    elif isinstance(out, (list, tuple)):
        for i, value in enumerate(out):
            _float_leaves(value, f"{path}[{i}]", found)
    return found


def _non_finite(leaves):
    """Paths of the leaves holding a NaN or an Inf.  The tensors'
    verdicts are formed on their devices and read in one copy."""
    bad = [path for path, leaf in leaves if isinstance(leaf, np.ndarray)
           and not np.all(np.isfinite(leaf))]
    tensors = [(path, leaf) for path, leaf in leaves
               if isinstance(leaf, torch.Tensor)]
    if tensors:
        home = tensors[0][1].device
        flags = torch.stack([torch.isfinite(t).all().to(home)
                             for _, t in tensors])
        ok = flags.cpu().tolist()  # the lane's one host read
        bad += [path for (path, _), fine in zip(tensors, ok) if not fine]
    return bad


def _emit(name, **attrs):
    if sink.enabled():
        sink.emit(sink.make_record("event", name, attrs=attrs))


def call_checked(fn, args, site, scope, codes=_CHECK_CODES):
    """Run ``fn(*args)`` and check its output; returns ``(error, out)``.

    ``error`` is a message string naming the output leaves that hold a
    NaN or an Inf (also emitted as a typed ``sanitizer`` obs event
    carrying ``site``, ``scope`` and the cross-referenced ``codes``,
    counted in ``sanitizer_errors_total{site,scope}``, and dumped by
    the flight recorder), else None.  ``fn`` runs exactly once.
    """
    out = fn(*args)
    bad = _non_finite(_float_leaves(out, "out", []))
    if not bad:
        return None, out
    message = f"non-finite values in {site} output: {', '.join(bad)}"
    _emit("sanitizer", site=site, scope=scope, error=message,
          codes=list(codes))
    metrics.counter(
        "sanitizer_errors_total",
        help="non-finite outputs caught by the sanitizer "
             "lane").inc(site=site, scope=scope)
    from . import flight
    flight.dump("sanitizer",
                state={"site": site, "scope": scope,
                       "error": message.splitlines()[0].strip(),
                       "codes": list(codes)})
    return message, out
