"""Obs isolation for the port's tests that import both packages.

Sinks, the metric registry, the flight ring and the fit-progress
registry are module globals in each package; :func:`clean_obs` starts
and ends every test with both packages' cleared and the obs
environment variables unset, as ``tests/obs/conftest.py`` does for the
JAX package alone.  Import the fixture into a test module to use it.
"""

import pytest

from brainiak_tpu.obs import flight as jflight
from brainiak_tpu.obs import metrics as jmetrics
from brainiak_tpu.obs import progress as jprogress
from brainiak_tpu.obs import sink as jsink
from brainiak_tpu_torch.obs import flight, metrics, progress, sink

ENV = (sink.OBS_DIR_ENV, sink.OBS_RANK_ENV, sink.OBS_MAX_MB_ENV,
       flight.FLIGHT_DIR_ENV, flight.FLIGHT_RECORDS_ENV,
       "BRAINIAK_TPU_SANITIZE", "BRAINIAK_TPU_FAULT")


def reset_obs():
    for snk, met, fl, prog in ((sink, metrics, flight, progress),
                               (jsink, jmetrics, jflight, jprogress)):
        snk.close_all()
        met.reset()
        fl.clear()
        prog.clear_registry()


@pytest.fixture
def clean_obs(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    reset_obs()
    yield
    reset_obs()


def span_tree(records):
    """``[(name, parent path, attrs)]`` of the span records, in order:
    the span tree with the times left out."""
    out = []
    for rec in records:
        if rec["kind"] != "span":
            continue
        parent = rec["path"].rpartition("/")[0]
        out.append((rec["name"], parent, rec.get("attrs")))
    return out
