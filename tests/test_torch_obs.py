"""The port's obs core (``brainiak_tpu_torch.obs``) on the CPU: the
cases of ``tests/obs/`` that need no jax, run on the port, and the
port held to the JAX package on the same calls.

Parity means: the same sketch buckets and quantiles bit for bit, the
same ``metrics.collect()``, records that both packages'
``validate_record`` accept and that are equal in kind, name and
attributes (times aside), the same span tree, the same flight ring
and snapshot layout, and the same ``FitProgress`` records.
"""

import json
import logging
import math
import os
import threading

import numpy as np
import pytest
import torch

from brainiak_tpu import obs as jobs
from brainiak_tpu.obs import flight as jflight
from brainiak_tpu.obs import postmortem as jpostmortem
from brainiak_tpu.obs import progress as jprogress
from brainiak_tpu.obs.report import aggregate, load_records, render_text
from brainiak_tpu.obs.sketch import QuantileSketch as JaxSketch
from brainiak_tpu_torch import obs
from brainiak_tpu_torch.obs import (flight, metrics, progress, sanitize,
                                    spans)
from brainiak_tpu_torch.obs import sink as obs_sink
from brainiak_tpu_torch.obs.progress import FitProgress
from brainiak_tpu_torch.obs.sketch import (DEFAULT_RELATIVE_ACCURACY,
                                           QuantileSketch)
from torch_obs_state import clean_obs, span_tree  # noqa: F401

# both packages, for the parity cases
PKGS = {"torch": obs, "jax": jobs}
PROGRESS = {"torch": progress, "jax": jprogress}
FLIGHT = {"torch": flight, "jax": jflight}


@pytest.fixture(autouse=True)
def _clean(clean_obs):  # noqa: F811
    yield


def _mem(pkg=obs):
    return pkg.add_sink(pkg.MemorySink())


def _spans(mem):
    return [r for r in mem.records if r["kind"] == "span"]


def _untimed(rec):
    """A record without its clock readings (and the rank)."""
    drop = {"ts", "dur_s", "chunk_s", "fit_wall_s", "rate", "eta_s",
            "rank"}
    return {k: v for k, v in rec.items() if k not in drop}


def _valid_in_both(rec):
    assert obs.validate_record(rec) == [], rec
    assert jobs.validate_record(rec) == [], rec


# -- sink ------------------------------------------------------------

def test_disabled_by_default():
    assert not obs.enabled()
    assert obs_sink.all_sinks() == []


def test_env_dir_enables_and_writes_rank_file(tmp_path, monkeypatch):
    d = str(tmp_path / "trace")
    monkeypatch.setenv(obs.OBS_DIR_ENV, d)
    assert obs.enabled()
    obs.emit(obs.make_record("event", "hello", attrs={"a": 1}))
    obs_sink.close_all()
    path = os.path.join(d, "obs-0.jsonl")
    (rec,) = [json.loads(line) for line in open(path)]
    assert rec["name"] == "hello" and rec["kind"] == "event"
    assert rec["v"] == obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION == 4
    _valid_in_both(rec)


def test_rank_env_override(tmp_path, monkeypatch):
    monkeypatch.setenv(obs_sink.OBS_RANK_ENV, "3")
    monkeypatch.setenv(obs.OBS_DIR_ENV, str(tmp_path))
    obs.emit(obs.make_record("event", "x"))
    obs_sink.close_all()
    assert os.path.exists(str(tmp_path / "obs-3.jsonl"))


def test_rank_from_torch_distributed(monkeypatch):
    """Without the env override the rank is the process group's, once
    one is initialized, and 0 before."""
    dist = torch.distributed
    monkeypatch.setattr(obs_sink, "_cached_rank", None)
    assert obs_sink.process_rank() == 0
    assert obs_sink._cached_rank is None  # not cached before init
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    assert obs_sink.process_rank() == 2
    assert obs.make_record("event", "x")["rank"] == 2
    monkeypatch.setenv(obs_sink.OBS_RANK_ENV, "5")
    assert obs_sink.process_rank() == 5


def test_rank_and_watermark_never_initialize_cuda(monkeypatch):
    """Neither probe creates a CUDA context: the device counters are
    read only once the process has one."""
    def boom(*args, **kwargs):
        raise AssertionError("would create a CUDA context")

    monkeypatch.setattr(obs_sink, "_cached_rank", None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", boom)
    monkeypatch.setattr(torch.cuda, "memory_allocated", boom)
    monkeypatch.setattr(torch.cuda, "init", boom)
    assert not obs_sink.backend_initialized()
    assert obs_sink.process_rank() == 0
    snap = obs.memory_watermark()
    assert snap["hbm_peak"] is None and snap["hbm_in_use"] is None
    assert snap["host_rss"] > 0
    assert not torch.cuda.is_initialized()


def test_event_helper_noop_when_disabled(tmp_path, monkeypatch):
    assert obs_sink.event("nothing") is None
    monkeypatch.setenv(obs.OBS_DIR_ENV, str(tmp_path))
    rec = obs_sink.event("something", k="v")
    assert rec["attrs"] == {"k": "v"}


def test_memory_sink_add_remove():
    mem = _mem()
    assert obs.enabled()
    obs_sink.event("ping")
    obs_sink.remove_sink(mem)
    assert not obs.enabled()
    assert [r["name"] for r in mem.records] == ["ping"]


def test_numpy_and_tensor_attrs_serialize(tmp_path, monkeypatch):
    monkeypatch.setenv(obs.OBS_DIR_ENV, str(tmp_path))
    obs_sink.event("np", value=np.float32(1.5), arr=np.arange(3),
                   t=torch.tensor([1.0, 2.0]), s=torch.tensor(3))
    obs_sink.close_all()
    (rec,) = [json.loads(line)
              for line in open(str(tmp_path / "obs-0.jsonl"))]
    assert rec["attrs"] == {"value": 1.5, "arr": [0, 1, 2],
                            "t": [1.0, 2.0], "s": 3}


def test_validate_record_rejects_bad_shapes():
    assert obs.validate_record([]) != []
    assert obs.validate_record({"v": 99}) != []
    good = obs.make_record("span", "s", path="s", dur_s=0.1)
    assert obs.validate_record(good) == []
    bad = dict(good, dur_s="fast")
    assert any("dur_s" in e for e in obs.validate_record(bad))
    bad = dict(good, extra=1)
    assert any("unknown" in e for e in obs.validate_record(bad))
    bad = obs.make_record("metric", "m", mtype="timer", value=1.0)
    assert any("mtype" in e for e in obs.validate_record(bad))


def test_validate_record_agrees_with_jax_package():
    """The two validators give the same verdict, message for message,
    on good and bad records of every kind."""
    cases = [
        [], {"v": 99}, {"v": 1, "kind": "span", "ts": 1.0, "rank": 0,
                        "name": "s", "path": "s", "dur_s": 0.1},
        {"v": 2, "kind": "cost", "ts": 1.0, "rank": 0, "name": "c",
         "site": "c", "flopz": 1.0},
        {"v": 1, "kind": "cost", "ts": 1.0, "rank": 0, "name": "c",
         "site": "c"},
        {"v": 3, "kind": "progress", "ts": 1.0, "rank": 0, "name": "p",
         "fit_id": "f", "estimator": "e", "chunk": 1, "step": 2,
         "ratio": 0.5},
        obs.make_record("metric", "m", mtype="timer", value=1.0),
        obs.make_record("span", "s", path="s", dur_s="slow"),
        obs.make_record("event", "e", attrs={"a": 1}, trace_id=5),
        obs.make_record("progress", "fit_progress", fit_id="ab" * 8,
                        estimator="fit", chunk=1, step=2, ratio=True),
    ]
    for rec in cases:
        assert obs.validate_record(rec) == jobs.validate_record(rec)


def test_unwritable_dir_disables_sink_without_raising(tmp_path,
                                                      monkeypatch,
                                                      caplog):
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    monkeypatch.setenv(obs.OBS_DIR_ENV, str(blocker / "trace"))
    assert obs.enabled()
    with caplog.at_level(logging.WARNING,
                         logger="brainiak_tpu_torch.obs.sink"):
        obs_sink.event("survives")
        obs_sink.event("also survives")
    assert "disabling" in caplog.text
    assert not obs.enabled()
    monkeypatch.setenv(obs.OBS_DIR_ENV, str(tmp_path / "ok"))
    assert obs.enabled()
    obs_sink.event("works now")
    obs_sink.close_all()
    assert (tmp_path / "ok" / "obs-0.jsonl").exists()


def test_jsonl_sink_reopens_when_rank_changes(tmp_path, monkeypatch):
    snk = obs.JsonlSink(str(tmp_path))
    monkeypatch.setenv(obs_sink.OBS_RANK_ENV, "0")
    snk.write(obs.make_record("event", "early"))
    monkeypatch.setenv(obs_sink.OBS_RANK_ENV, "2")
    snk.write(obs.make_record("event", "late"))
    snk.close()
    assert "early" in open(str(tmp_path / "obs-0.jsonl")).read()
    assert "late" in open(str(tmp_path / "obs-2.jsonl")).read()


def test_jsonl_sink_concurrent_writes(tmp_path):
    snk = obs.JsonlSink(str(tmp_path), rank=0)

    def work(tag):
        for i in range(100):
            snk.write(obs.make_record("event", f"{tag}-{i}"))

    threads = [threading.Thread(target=work, args=(f"t{j}",))
               for j in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    snk.close()
    lines = open(str(tmp_path / "obs-0.jsonl")).read().splitlines()
    assert len(lines) == 400
    for line in lines:
        assert obs.validate_record(json.loads(line)) == []


def test_schema_versions_and_cost_kind():
    rec = {"v": 1, "kind": "span", "ts": 1.0, "rank": 0,
           "name": "s", "path": "s", "dur_s": 0.1}
    assert obs.validate_record(rec) == []
    cost = {"v": 2, "kind": "cost", "ts": 1.0, "rank": 0,
            "name": "site", "site": "site", "flops": 1.0,
            "unavailable": "x"}
    for v, ok in ((2, True), (1, False), (3, True), (4, True),
                  (5, False)):
        errors = obs.validate_record(dict(cost, v=v))
        assert (errors == []) == ok, (v, errors)


def test_max_mb_cap_truncates_with_one_marker(tmp_path, monkeypatch):
    monkeypatch.setenv(obs_sink.OBS_MAX_MB_ENV, "0.001")  # ~1 KB
    snk = obs.JsonlSink(str(tmp_path), rank=0)
    for i in range(100):
        snk.write(obs.make_record("event", f"e{i}",
                                  attrs={"pad": "x" * 64}))
    snk.close()
    lines = open(str(tmp_path / "obs-0.jsonl")).read().splitlines()
    assert len(lines) < 50
    marker = json.loads(lines[-2])
    assert marker["name"] == "obs_truncated"
    assert abs(marker["attrs"]["limit_mb"] - 0.001) < 1e-5
    dropped = json.loads(lines[-1])
    assert dropped["name"] == "obs_dropped"
    assert dropped["attrs"]["dropped_total"] == 100 - (len(lines) - 2)
    assert os.path.getsize(str(tmp_path / "obs-0.jsonl")) < 2 * 1024


def test_max_mb_env_activated_sink_truncates(tmp_path, monkeypatch):
    monkeypatch.setenv(obs.OBS_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(obs_sink.OBS_MAX_MB_ENV, "0.0005")
    for _ in range(50):
        obs_sink.event("spam", pad="y" * 64)
    obs_sink.close_all()
    lines = open(str(tmp_path / "obs-0.jsonl")).read().splitlines()
    assert json.loads(lines[-2])["name"] == "obs_truncated"
    assert json.loads(lines[-1])["name"] == "obs_dropped"
    assert len(lines) < 50


def test_bad_max_mb_env_is_ignored(tmp_path, monkeypatch):
    monkeypatch.setenv(obs_sink.OBS_MAX_MB_ENV, "lots")
    snk = obs.JsonlSink(str(tmp_path), rank=0)
    assert snk.max_bytes is None
    snk.write(obs.make_record("event", "ok"))
    snk.close()


def test_truncated_port_trace_renders_in_jax_report(tmp_path,
                                                    monkeypatch):
    """A truncated JSONL trace of the port loads in the JAX package's
    report, which states how many records were dropped."""
    monkeypatch.setenv(obs_sink.OBS_MAX_MB_ENV, "0.0005")
    snk = obs.JsonlSink(str(tmp_path), rank=0)
    for i in range(80):
        snk.write(obs.make_record("event", f"e{i}",
                                  attrs={"pad": "z" * 48}))
    n_dropped = snk.dropped_total
    assert n_dropped > 0
    snk.close()
    snk.close()  # a second close stamps nothing more
    records, errors = load_records([str(tmp_path / "obs-0.jsonl")])
    assert errors == []
    assert sum(r["name"] == "obs_dropped" for r in records) == 1
    summary = aggregate(records)
    assert summary["dropped_records"] == n_dropped
    assert str(n_dropped) in render_text(summary)


def test_dropped_total_zero_below_cap(tmp_path):
    snk = obs.JsonlSink(str(tmp_path), rank=0, max_mb=10)
    snk.write(obs.make_record("event", "fine"))
    assert snk.dropped_total == 0
    snk.close()
    lines = open(str(tmp_path / "obs-0.jsonl")).read().splitlines()
    assert [json.loads(line)["name"] for line in lines] == ["fine"]


def test_suspended_disables_and_restores(tmp_path, monkeypatch):
    monkeypatch.setenv(obs.OBS_DIR_ENV, str(tmp_path))
    assert obs.enabled()
    with obs_sink.suspended():
        assert not obs.enabled()
        assert obs_sink.all_sinks() == []
        obs_sink.event("invisible")
        with obs_sink.suspended():
            assert not obs.enabled()
        assert not obs.enabled()
    assert obs.enabled()
    obs_sink.event("visible")
    obs_sink.close_all()
    lines = open(str(tmp_path / "obs-0.jsonl")).read().splitlines()
    assert [json.loads(line)["name"] for line in lines] == ["visible"]


def test_trace_fields_validate_as_v3():
    rec = obs.make_record("span", "s", path="s", dur_s=0.001,
                          trace_id="a" * 16, span_id="b" * 8,
                          parent_id="c" * 8)
    _valid_in_both(rec)
    assert obs.validate_record(dict(rec, trace_id=123))
    old = {k: v for k, v in rec.items()
           if k not in ("trace_id", "span_id", "parent_id")}
    assert obs.validate_record(dict(old, v=1)) == []


def test_same_calls_give_the_same_records_in_both_packages():
    """Events, nested spans, metrics and progress records from the same
    calls: each accepted by both validators, and equal record for
    record in kind, name and attributes, times aside."""
    got = {}
    for name, pkg in PKGS.items():
        mem = _mem(pkg)
        pkg.event("resume", estimator="fit", step=4, fit_id="ab" * 8)
        with pkg.span("outer", attrs={"estimator": "SRM"}):
            with pkg.span("inner") as frame:
                frame.set("step", 3)
        pkg.counter("fit_steps_total").inc(5, estimator="fit")
        pkg.gauge("hbm_bytes_in_use", unit="bytes").set(7, estimator="e")
        pkg.histogram("checkpoint_seconds", unit="s").observe(
            0.25, estimator="fit")
        fp = PROGRESS[name].FitProgress("fit", 10, fit_id="cd" * 8,
                                        objective="obj", n_chunks=5)
        fp.observe({"obj": np.full(3, 2.0)}, 2, 2, 0.5)
        fp.finish("completed")
        pkg.remove_sink(mem)
        got[name] = mem.records
    assert len(got["torch"]) == len(got["jax"]) > 6
    for t, j in zip(got["torch"], got["jax"]):
        _valid_in_both(t)
        _valid_in_both(j)
        assert _untimed(t) == _untimed(j)


# -- metrics ---------------------------------------------------------

def test_counter_accumulates_by_labelset():
    c = obs.counter("fit_steps_total")
    c.inc(5, estimator="SRM")
    c.inc(3, estimator="SRM")
    c.inc(2, estimator="TFA")
    assert c.value(estimator="SRM") == 8
    assert c.value(estimator="TFA") == 2
    assert c.value(estimator="HTFA") == 0.0
    with pytest.raises(ValueError):
        c.inc(-1)


def test_gauge_and_histogram():
    g = obs.gauge("g", unit="bytes")
    g.set(5)
    g.set(7)
    assert g.value() == 7
    h = obs.histogram("h", unit="s")
    for v in (0.1, 0.3, 0.2):
        h.observe(v)
    summary = h.summary()
    assert summary["count"] == 3
    assert summary["min"] == pytest.approx(0.1)
    assert summary["max"] == pytest.approx(0.3)
    assert summary["sum"] == pytest.approx(0.6)


def test_type_conflict_raises():
    obs.counter("conflicted")
    with pytest.raises(ValueError):
        obs.gauge("conflicted")


def test_get_or_create_returns_same_object():
    assert obs.counter("same") is obs.counter("same")


def test_collect_shape():
    obs.counter("a_total").inc(2, site="x")
    obs.gauge("b").set(1.5)
    obs.histogram("c_seconds", unit="s").observe(0.5)
    by_name = {s["name"]: s for s in obs.collect()}
    assert by_name["a_total"]["value"] == 2
    assert by_name["a_total"]["labels"] == {"site": "x"}
    assert by_name["b"]["value"] == 1.5
    assert by_name["c_seconds"]["value"]["count"] == 1


def test_updates_emit_records_only_when_enabled():
    obs.counter("quiet_total").inc()
    mem = _mem()
    obs.counter("loud_total").inc(2, estimator="SRM")
    obs.histogram("loud_seconds", unit="s").observe(0.25)
    recs = [r for r in mem.records if r["kind"] == "metric"]
    assert [r["name"] for r in recs] == ["loud_total", "loud_seconds"]
    assert recs[0]["value"] == 2.0
    assert recs[0]["labels"] == {"estimator": "SRM"}
    assert recs[1]["unit"] == "s"
    for rec in recs:
        _valid_in_both(rec)


def test_counter_thread_safe():
    c = obs.counter("threaded_total")

    def work():
        for _ in range(1000):
            c.inc(site="x")

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert c.value(site="x") == 4000


def test_registry_reset_isolates():
    obs.counter("ephemeral_total").inc()
    metrics.reset()
    assert obs.collect() == []


def test_histogram_quantiles_from_sketch():
    h = obs.histogram("q_seconds", unit="s")
    for i in range(1, 101):
        h.observe(i / 100.0, kind="x")
    summary = h.summary(kind="x")
    assert summary["count"] == 100
    assert summary["p50"] == pytest.approx(0.51, rel=0.02)
    assert summary["p90"] == pytest.approx(0.90, rel=0.02)
    assert summary["p99"] == pytest.approx(0.99, rel=0.02)
    assert h.quantile(0.99, kind="x") == summary["p99"]
    assert h.quantile(0.5, kind="nope") is None


def test_histogram_sketch_copy_is_mergeable():
    h = obs.histogram("m_seconds", unit="s")
    for v in (0.1, 0.2, 0.3):
        h.observe(v, shard="a")
    for v in (1.0, 2.0):
        h.observe(v, shard="b")
    a, b = h.sketch(shard="a"), h.sketch(shard="b")
    assert h.sketch(shard="zzz") is None
    a.merge(b)
    assert a.count == 5
    assert h.summary(shard="a")["count"] == 3
    assert a.quantile(1.0) == pytest.approx(2.0, rel=0.02)


def test_collect_carries_help_text():
    obs.counter("helped_total", help="the help line").inc()
    (sample,) = [s for s in obs.collect()
                 if s["name"] == "helped_total"]
    assert sample["help"] == "the help line"


def test_collect_equals_jax_package_after_the_same_calls():
    rng = np.random.RandomState(0)
    values = rng.lognormal(-2.0, 1.0, 200)
    out = {}
    for name, pkg in PKGS.items():
        pkg.counter("retry_total", help="retries").inc(site="a")
        pkg.counter("retry_total", help="retries").inc(3, site="b")
        pkg.gauge("fit_progress_ratio").set(0.25, fit_id="x")
        pkg.gauge("fit_progress_ratio").set(0.5, fit_id="x")
        hist = pkg.histogram("checkpoint_seconds", unit="s")
        for v in values:
            hist.observe(float(v), estimator="fit")
        out[name] = pkg.collect()
    assert out["torch"] == out["jax"]


# -- sketch ----------------------------------------------------------

def _exact(values, q):
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1,
                       int(round(q * (len(ordered) - 1))))]


def test_relative_error_bound_lognormal():
    rng = np.random.RandomState(0)
    values = rng.lognormal(mean=-3.0, sigma=1.5, size=20000)
    sketch = QuantileSketch()
    for v in values:
        sketch.observe(float(v))
    for q in (0.01, 0.1, 0.5, 0.9, 0.99, 0.999):
        true = _exact(values, q)
        assert abs(sketch.quantile(q) - true) <= \
            DEFAULT_RELATIVE_ACCURACY * true + 1e-12


def test_relative_error_bound_across_scales():
    rng = np.random.RandomState(1)
    values = np.concatenate([rng.uniform(1e-6, 1e-5, 500),
                             rng.uniform(0.01, 0.1, 500),
                             rng.uniform(100.0, 5000.0, 500)])
    rng.shuffle(values)
    sketch = QuantileSketch()
    for v in values:
        sketch.observe(float(v))
    for q in (0.1, 0.5, 0.9):
        true = _exact(values, q)
        assert abs(sketch.quantile(q) - true) <= \
            DEFAULT_RELATIVE_ACCURACY * true + 1e-15


def test_merge_is_exact():
    rng = np.random.RandomState(2)
    pooled, a, b = QuantileSketch(), QuantileSketch(), QuantileSketch()
    for v in rng.exponential(0.05, 5000):
        a.observe(float(v))
        pooled.observe(float(v))
    for v in rng.exponential(0.5, 3000):
        b.observe(float(v))
        pooled.observe(float(v))
    a.merge(b)
    assert a.count == pooled.count == 8000
    assert a.sum == pytest.approx(pooled.sum)
    for q in (0.05, 0.5, 0.95, 0.99):
        assert a.quantile(q) == pooled.quantile(q)


def test_merged_pooled_p99_within_documented_bound():
    rng = np.random.RandomState(3)
    rep1 = rng.lognormal(-2.5, 1.0, 4000)
    rep2 = rng.lognormal(-1.5, 0.7, 6000)
    s1, s2 = QuantileSketch(), QuantileSketch()
    for v in rep1:
        s1.observe(float(v))
    for v in rep2:
        s2.observe(float(v))
    merged = QuantileSketch.from_dict(s1.to_dict()).merge(s2)
    true_p99 = _exact(np.concatenate([rep1, rep2]), 0.99)
    assert abs(merged.quantile(0.99) - true_p99) <= \
        DEFAULT_RELATIVE_ACCURACY * true_p99


def test_merge_rejects_mismatched_accuracy_and_type():
    a = QuantileSketch(relative_accuracy=0.01)
    with pytest.raises(ValueError, match="relative"):
        a.merge(QuantileSketch(relative_accuracy=0.05))
    with pytest.raises(TypeError):
        a.merge([1, 2, 3])


def test_json_round_trip():
    sketch = QuantileSketch()
    for v in (0.0, 1e-6, 0.25, 0.25, 7.5, -3.0):
        sketch.observe(v)
    back = QuantileSketch.from_dict(
        json.loads(json.dumps(sketch.to_dict())))
    assert (back.count, back.min, back.max) == \
        (sketch.count, sketch.min, sketch.max)
    assert back.sum == pytest.approx(sketch.sum)
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert back.quantile(q) == sketch.quantile(q)


def test_zero_negative_and_edge_quantiles():
    sketch = QuantileSketch()
    for v in (-2.0, -1.0, 0.0, 0.0, 1.0, 2.0):
        sketch.observe(v)
    assert sketch.quantile(0.0) == pytest.approx(-2.0, rel=0.02)
    assert sketch.quantile(0.5) == 0.0
    assert sketch.quantile(1.0) == pytest.approx(2.0, rel=0.02)
    assert (sketch.min, sketch.max) == (-2.0, 2.0)


def test_empty_and_invalid_inputs():
    sketch = QuantileSketch()
    assert sketch.quantile(0.5) is None
    assert sketch.quantiles((0.5, 0.99)) == [None, None]
    for bad in (float("nan"), float("inf")):
        with pytest.raises(ValueError):
            sketch.observe(bad)
    with pytest.raises(ValueError):
        sketch.quantile(1.5)
    with pytest.raises(ValueError):
        QuantileSketch(relative_accuracy=0.0)
    with pytest.raises(ValueError):
        QuantileSketch(max_buckets=1)


def test_memory_bound_collapses_low_buckets():
    rng = np.random.RandomState(4)
    values = rng.uniform(1.0, 100.0, 30000)
    sketch = QuantileSketch(max_buckets=64)
    for v in values:
        sketch.observe(float(v))
    assert len(sketch._buckets) <= 64
    boundary = sketch._bucket_value(min(sketch._buckets))
    for q in (0.8, 0.9, 0.99):
        true = _exact(values, q)
        assert true > boundary
        assert abs(sketch.quantile(q) - true) <= \
            DEFAULT_RELATIVE_ACCURACY * true
    assert sketch.quantile(0.01) <= boundary * 1.02


def test_observe_is_o1_state():
    sketch = QuantileSketch()
    values = [0.003, 0.5, 0.0021, 12.0, 0.5]
    for v in values:
        sketch.observe(v)
    assert sketch.count == 5
    assert sketch.sum == pytest.approx(sum(values))
    assert (sketch.min, sketch.max) == (0.0021, 12.0)


@pytest.mark.parametrize("max_buckets", [2048, 64])
def test_sketch_bit_identical_to_jax_package(max_buckets):
    """The same stream gives the same buckets, quantiles and merges in
    both packages, bit for bit, and the wire form crosses over."""
    rng = np.random.RandomState(5)
    a_vals = np.concatenate([rng.lognormal(-3, 2, 3000),
                             -rng.exponential(1.0, 200), np.zeros(5)])
    b_vals = rng.uniform(1e-4, 1e3, 2000)
    sketches = {}
    for name, cls in (("torch", QuantileSketch), ("jax", JaxSketch)):
        a, b = cls(max_buckets=max_buckets), cls(max_buckets=max_buckets)
        for v in a_vals:
            a.observe(float(v))
        for v in b_vals:
            b.observe(float(v))
        single = a.to_dict()
        sketches[name] = (single, a.merge(b))
    assert sketches["torch"][0] == sketches["jax"][0]
    t, j = sketches["torch"][1], sketches["jax"][1]
    assert t.to_dict() == j.to_dict()
    qs = np.linspace(0.0, 1.0, 101)
    assert [t.quantile(q) for q in qs] == [j.quantile(q) for q in qs]
    cross = JaxSketch.from_dict(t.to_dict())
    assert [cross.quantile(q) for q in qs] == [t.quantile(q) for q in qs]


# -- spans -----------------------------------------------------------

def test_span_disabled_is_noop_and_emits_nothing():
    assert not obs.enabled()
    with obs.span("outer") as frame:
        frame.set("k", 1)
        frame.sync = [1, 2, 3]
        assert frame.sync is None
        assert obs.current_span() == ""
    assert not obs.enabled()


def test_span_nesting_paths_and_attrs():
    mem = _mem()
    with obs.span("outer", attrs={"estimator": "SRM"}):
        assert obs.current_span() == "outer"
        with obs.span("inner") as frame:
            frame.set("step", 3)
            assert obs.current_span() == "outer/inner"
    recs = _spans(mem)
    assert [r["path"] for r in recs] == ["outer/inner", "outer"]
    assert recs[0]["attrs"] == {"step": 3}
    assert recs[1]["attrs"] == {"estimator": "SRM"}
    for rec in recs:
        _valid_in_both(rec)
        assert rec["dur_s"] >= 0


def test_nested_spans_give_the_jax_package_tree():
    trees = {}
    for name, pkg in PKGS.items():
        mem = _mem(pkg)
        with pkg.span("fit", attrs={"estimator": "SRM"}):
            for step in range(2):
                with pkg.span("fit_chunk", attrs={"step": step}):
                    with pkg.span("leaf"):
                        pass
            with pkg.stage_timer("legacy"):
                pass
        pkg.remove_sink(mem)
        trees[name] = span_tree(mem.records)
    assert trees["torch"] == trees["jax"]
    assert ("leaf", "fit/fit_chunk", None) in trees["torch"]


class _FakeCuda(torch.Tensor):
    """A tensor that says it lies on a CUDA device (the CPU build has
    none)."""

    is_cuda = True
    device = None


def _fake_cuda(index):
    t = torch.Tensor._make_subclass(_FakeCuda, torch.empty(0))
    t.device = torch.device("cuda", index)
    return t


def test_span_sync_synchronizes_cuda_devices_once_each(monkeypatch):
    """A sync target's CUDA devices are synchronized once each; CPU
    tensors and arrays need none."""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    target = {"a": _fake_cuda(0),
              "b": [_fake_cuda(0), (_fake_cuda(1), torch.ones(2))],
              "c": np.ones(2)}
    spans._block_until_ready(target)
    assert sorted(seen, key=str) == [torch.device("cuda", 0),
                                     torch.device("cuda", 1)]
    seen.clear()
    spans._block_until_ready({"x": torch.ones(2), "y": [np.ones(1)]})
    assert seen == []


def test_span_sync_runs_only_while_enabled(monkeypatch):
    calls = []
    monkeypatch.setattr(spans, "_block_until_ready", calls.append)
    x = torch.ones(4)
    with obs.span("quiet", sync=x) as frame:
        frame.sync = x
    assert calls == []
    mem = _mem()
    with obs.span("matmul", sync=x @ x):
        pass
    with obs.span("late") as frame:
        frame.sync = x + 1
    assert len(calls) == 2 and len(_spans(mem)) == 2


def test_failing_sync_propagates_but_stack_stays_clean(monkeypatch):
    mem = _mem()

    def boom(target):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(spans, "_block_until_ready", boom)
    with pytest.raises(RuntimeError):
        with obs.span("doomed", sync=object()):
            pass
    assert obs.current_span() == ""
    monkeypatch.undo()
    with obs.span("after"):
        pass
    assert [r["path"] for r in _spans(mem)] == ["after"]


def test_span_exception_still_recorded():
    mem = _mem()
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("x")
    recs = _spans(mem)
    assert len(recs) == 1 and recs[0]["name"] == "boom"
    assert obs.current_span() == ""


def test_traced_decorator_forms():
    mem = _mem()

    @obs.traced
    def bare():
        return 1

    @obs.traced("labeled", sync_result=True)
    def labeled():
        return torch.zeros(3)

    assert bare() == 1
    assert torch.equal(labeled(), torch.zeros(3))
    names = [r["name"] for r in _spans(mem)]
    assert "bare" in names[0]
    assert names[1] == "labeled"


def test_stage_timer_records_without_sink():
    obs.reset_stage_times()
    for _ in range(2):
        with obs.stage_timer("stage_a"):
            pass
    assert len(obs.stage_times()["stage_a"]) == 2
    obs.reset_stage_times()
    assert obs.stage_times() == {}


def test_stage_timer_emits_span_when_enabled():
    mem = _mem()
    obs.reset_stage_times()
    with obs.span("outer"):
        with obs.stage_timer("legacy"):
            pass
    assert "outer/legacy" in [r["path"] for r in _spans(mem)]
    assert "legacy" in obs.stage_times()
    obs.reset_stage_times()


def test_stage_registry_thread_safe():
    obs.reset_stage_times()

    def work():
        for _ in range(200):
            with obs.stage_timer("shared"):
                pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(obs.stage_times()["shared"]) == 800
    obs.reset_stage_times()


def test_span_stacks_are_thread_local():
    mem = _mem()
    seen = {}

    def work(tag):
        with obs.span(tag):
            seen[tag] = obs.current_span()

    threads = [threading.Thread(target=work, args=(f"t{i}",))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert seen == {f"t{i}": f"t{i}" for i in range(4)}
    assert all(r["path"] == r["name"] for r in _spans(mem))


# -- flight ----------------------------------------------------------

def _rec(i, kind="event", **fields):
    rec = {"v": obs_sink.SCHEMA_VERSION, "kind": kind,
           "name": f"r{i}", "ts": float(i), "rank": 0}
    rec.update(fields)
    return rec


def test_ring_appends_and_snapshots():
    for i in range(5):
        flight.record(_rec(i))
    recs = flight.records()
    assert [r["name"] for r in recs] == [f"r{i}" for i in range(5)]
    recs.append(_rec(99))
    assert len(flight.records()) == 5


def test_ring_overwrites_oldest_at_capacity(monkeypatch):
    monkeypatch.setenv(flight.FLIGHT_RECORDS_ENV, "8")
    for i in range(20):
        flight.record(_rec(i))
    assert [r["name"] for r in flight.records()] == \
        [f"r{i}" for i in range(12, 20)]


def test_ring_capacity_env_validation(monkeypatch):
    assert flight.capacity() == flight.DEFAULT_CAPACITY == \
        jflight.DEFAULT_CAPACITY
    for bad in ("not-a-number", "0"):
        monkeypatch.setenv(flight.FLIGHT_RECORDS_ENV, bad)
        assert flight.capacity() == flight.DEFAULT_CAPACITY
    monkeypatch.setenv(flight.FLIGHT_RECORDS_ENV, "17")
    assert flight.capacity() == jflight.capacity() == 17


def test_concurrent_appends_never_lose_the_lock(monkeypatch):
    monkeypatch.setenv(flight.FLIGHT_RECORDS_ENV, "64")

    def spin(t):
        for i in range(200):
            flight.record(_rec(i, thread=t))

    threads = [threading.Thread(target=spin, args=(t,))
               for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    recs = flight.records()
    assert len(recs) == 64
    assert all(isinstance(r, dict) and "name" in r for r in recs)


def test_sink_emit_taps_the_ring():
    mem = _mem()
    obs_sink.event("ping", x=1)
    obs_sink.remove_sink(mem)
    assert "ping" in [r["name"] for r in flight.records()]


def test_dump_writes_snapshot_and_manifest(tmp_path):
    for i in range(4):
        flight.record(_rec(i, kind="progress", fit_id="f" * 16,
                           estimator="fit", chunk=i + 1, step=2 * i,
                           n_iter=8, ratio=i / 4, objective=10.0 - i))
    path = flight.dump("divergence_abort", fit_id="f" * 16,
                       state={"estimator": "fit", "step": 4},
                       directory=str(tmp_path))
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    assert manifest["trigger"] == "divergence_abort"
    assert manifest["fit_id"] == "f" * 16
    assert manifest["n_records"] == 4
    assert manifest["state"]["estimator"] == "fit"
    with open(os.path.join(path, "records.jsonl")) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    assert len(lines) == 4 and lines[-1]["chunk"] == 4
    assert flight.last_dump(fit_id="f" * 16)["path"] == path
    assert flight.last_dump(fit_id="0" * 16) is None


def test_dump_resolution_order(tmp_path, monkeypatch):
    flight.record(_rec(0))
    assert flight.dump("trigger") is None
    monkeypatch.setenv(obs_sink.OBS_DIR_ENV, str(tmp_path))
    assert flight.dump("trigger").startswith(str(tmp_path / "incidents"))
    override = tmp_path / "elsewhere"
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(override))
    assert flight.dump("trigger").startswith(str(override))


def test_dump_emits_flight_dump_event_when_enabled(tmp_path):
    flight.record(_rec(0))
    mem = _mem()
    flight.dump("sanitizer", directory=str(tmp_path))
    obs_sink.remove_sink(mem)
    events = [r for r in mem.records if r["name"] == "flight_dump"]
    assert len(events) == 1
    assert events[0]["attrs"]["trigger"] == "sanitizer"


def test_flight_snapshot_layout_matches_jax_package(tmp_path, capsys):
    """The same ring and dump give snapshots with the same files,
    manifest keys and records; the JAX package's postmortem renders
    the port's snapshot."""
    snaps = {}
    for name, fl in FLIGHT.items():
        for i in range(3):
            fl.record(_rec(i, kind="progress", fit_id="9" * 16,
                           estimator="fit", chunk=i + 1, step=2 * i,
                           n_iter=6, ratio=i / 3, objective=5.0 - i))
        path = fl.dump("divergence_abort", fit_id="9" * 16,
                       state={"estimator": "fit", "failed_step": 6,
                              "leaves": ["x"]},
                       directory=str(tmp_path / name))
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        with open(os.path.join(path, "records.jsonl")) as fh:
            records = fh.read()
        snaps[name] = (sorted(os.listdir(path)), manifest, records,
                       os.path.basename(path).split("-")[:2])
    t, j = snaps["torch"], snaps["jax"]
    assert t[0] == j[0] and t[2] == j[2] and t[3] == j[3]
    assert {k: v for k, v in t[1].items() if k != "ts"} == \
        {k: v for k, v in j[1].items() if k != "ts"}
    port_path = flight.last_dump()["path"]
    assert jpostmortem.main([port_path]) == 0
    assert "divergence_abort" in capsys.readouterr().out


# -- progress --------------------------------------------------------

def _observe_n(fp, n, objective=None, start=0, n_steps=2, chunk_s=0.1):
    recs = []
    for i in range(n):
        value = objective(i) if callable(objective) else objective
        state = {} if value is None else {"obj": np.full(3, float(value))}
        recs.append(fp.observe(state, start + (i + 1) * n_steps,
                               n_steps, chunk_s))
    return recs


def test_new_fit_id_is_trace_shaped():
    fid = progress.new_fit_id()
    assert len(fid) == 16
    int(fid, 16)
    assert fid != progress.new_fit_id()


def test_progress_records_validate_and_carry_telemetry():
    mem = _mem()
    fp = FitProgress("SRM.fit", 10, objective="obj", n_chunks=5)
    recs = _observe_n(fp, 5, objective=lambda i: 100.0 - i)
    obs_sink.remove_sink(mem)
    assert [r["chunk"] for r in recs] == [1, 2, 3, 4, 5]
    for rec in recs:
        _valid_in_both(rec)
        assert rec["fit_id"] == fp.fit_id
    assert recs[-1]["ratio"] == 1.0
    assert recs[-1]["objective"] == 96.0
    assert recs[1]["delta"] == -1.0
    assert recs[-1]["rate"] > 0
    assert recs[-1]["eta_s"] == 0.0
    assert [r for r in mem.records if r["kind"] == "progress"] == recs


def test_disabled_obs_emits_no_sink_records():
    assert not obs_sink.enabled()
    fp = FitProgress("fit", 4, objective="obj")
    _observe_n(fp, 2, objective=lambda i: 1.0)
    fp.finish("completed")
    assert {r["kind"] for r in flight.records()} == {"progress", "event"}
    (snap,) = progress.active_fits()
    assert snap["fit_id"] == fp.fit_id
    assert snap["status"] == "completed"


def test_enabled_obs_taps_flight_ring_exactly_once():
    mem = _mem()
    fp = FitProgress("fit", 4, objective="obj")
    _observe_n(fp, 2, objective=lambda i: 1.0)
    fp.finish("completed")
    obs_sink.remove_sink(mem)
    assert [r["chunk"] for r in flight.records()
            if r["kind"] == "progress"] == [1, 2]
    assert len([r for r in flight.records()
                if r["name"] == "fit_finished"]) == 1


def test_divergence_precursor_on_non_finite_objective():
    mem = _mem()
    fp = FitProgress("fit", 10, objective="obj")
    _observe_n(fp, 2, objective=lambda i: 5.0)
    fp.observe({"obj": np.array([1.0, np.nan, 2.0])}, 6, 2, 0.1)
    obs_sink.remove_sink(mem)
    (event,) = [r for r in mem.records
                if r["name"] == "divergence_precursor"]
    assert event["fit_id"] == fp.fit_id
    assert event["attrs"]["reason"] == "non_finite_objective"
    assert event["attrs"]["objective"] is None
    assert [r for r in mem.records
            if r["kind"] == "progress"][-1].get("objective") is None
    json.dumps(mem.records, allow_nan=False)


def test_divergence_precursor_on_worsening_trend():
    mem = _mem()
    fp = FitProgress("fit", 20, objective="obj", direction="min")
    _observe_n(fp, 6, objective=lambda i: 10.0 + 3.0 * i)
    obs_sink.remove_sink(mem)
    (event,) = [r for r in mem.records
                if r["name"] == "divergence_precursor"]
    assert event["attrs"]["reason"] == "worsening_trend"
    assert event["attrs"]["ewma_worsening"] > 0


def test_improving_objective_fires_no_precursor():
    fp = FitProgress("fit", 20, objective="obj", direction="min")
    _observe_n(fp, 8, objective=lambda i: 10.0 - i)
    assert not fp.precursor_fired
    fp = FitProgress("fit", 20, objective="obj", direction="max")
    _observe_n(fp, 8, objective=lambda i: 10.0 + i)
    assert not fp.precursor_fired


def test_plateau_detection():
    mem = _mem()
    fp = FitProgress("fit", 40, objective="obj")
    _observe_n(fp, 2, objective=lambda i: 50.0 - 10 * i)
    _observe_n(fp, progress.PLATEAU_CHUNKS, objective=lambda i: 40.0,
               start=4)
    obs_sink.remove_sink(mem)
    assert fp.plateaued
    assert len([r for r in mem.records if r["name"] == "plateau"]) == 1
    assert [r for r in mem.records
            if r["kind"] == "progress"][-1]["plateaued"] is True


def test_callable_objective_and_swallowed_errors():
    calls = []

    def objective(state):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("flaky telemetry")
        return 7.0

    fp = FitProgress("fit", 4, objective=objective)
    assert fp.observe({}, 2, 2, 0.1)["objective"] == 7.0
    assert fp.observe({}, 4, 2, 0.1).get("objective") is None
    fp = FitProgress("fit", 4, objective="nope")
    assert fp.observe({"obj": np.ones(2)}, 2, 2, 0.1).get(
        "objective") is None


def test_eta_uses_ewma_rate():
    fp = FitProgress("fit", 100)
    fp.observe({}, 10, 10, 1.0)
    assert fp.eta_s == pytest.approx(9.0)
    fp.observe({}, 20, 10, 1.0)
    assert fp.rate == pytest.approx(10.0)
    assert fp.eta_s == pytest.approx(8.0)


def test_resume_carries_wall_and_chunks():
    fp = FitProgress("fit", 10, fit_id="ab" * 8, wall0=3.0, chunks0=2)
    rec = fp.observe({}, 6, 2, 0.5)
    assert rec["fit_id"] == "ab" * 8
    assert rec["chunk"] == 3
    assert rec["fit_wall_s"] == pytest.approx(3.5)


def test_registry_eviction_keeps_running_fits():
    running = FitProgress("fit", 4)
    running.observe({}, 2, 2, 0.1)
    finished = []
    for _ in range(progress._MAX_FINISHED + 5):
        fp = FitProgress("fit", 2)
        fp.observe({}, 2, 2, 0.1)
        fp.finish("completed")
        finished.append(fp.fit_id)
    ids = [s["fit_id"] for s in progress.active_fits()]
    assert running.fit_id in ids
    assert len(ids) == progress._MAX_FINISHED + 1
    assert finished[0] not in ids and finished[-1] in ids


def test_direction_validated():
    with pytest.raises(ValueError):
        FitProgress("fit", 4, direction="sideways")


def test_gauges_exposed_when_enabled():
    mem = _mem()
    fp = FitProgress("SRM.fit", 10)
    fp.observe({}, 5, 5, 0.5)
    rows = {(m["name"], tuple(sorted((m.get("labels") or {}).items())))
            for m in mem.records if m["kind"] == "metric"}
    obs_sink.remove_sink(mem)
    labels = (("estimator", "SRM.fit"), ("fit_id", fp.fit_id))
    assert ("fit_progress_ratio", labels) in rows
    assert ("fit_eta_seconds", labels) in rows


def test_objective_ring_is_bounded():
    fp = FitProgress("fit", 10_000, objective="obj")
    _observe_n(fp, progress.OBJECTIVE_RING + 20,
               objective=lambda i: float(i) * -1.0)
    assert len(fp.objectives) == progress.OBJECTIVE_RING
    assert math.isfinite(fp.objectives[-1][1])


def test_fit_context_nests_drops_none_and_restores():
    assert progress.current_context() == {}
    with progress.fit_context(job_id="j1", tenant="a", trace_id=None):
        assert progress.current_context() == {"job_id": "j1",
                                              "tenant": "a"}
        with progress.fit_context(tenant="b"):
            assert progress.current_context() == {"job_id": "j1",
                                                  "tenant": "b"}
        assert progress.current_context()["tenant"] == "a"
    assert progress.current_context() == {}


def test_fit_context_attrs_ride_records_and_registry():
    mem = _mem()
    with progress.fit_context(job_id="job-1", tenant="hospital-a"):
        fp = FitProgress("SRM.fit", 4, n_chunks=2)
        _observe_n(fp, 2)
        fp.finish("completed")
    obs_sink.remove_sink(mem)
    recs = [r for r in mem.records if r["kind"] == "progress"]
    assert all(r["attrs"] == {"job_id": "job-1", "tenant": "hospital-a"}
               for r in recs)
    snap = progress.active_fits()[-1]
    assert (snap["fit_id"], snap["job_id"]) == (fp.fit_id, "job-1")


def test_finish_listener_sees_terminal_snapshot_once():
    seen = []
    progress.add_finish_listener(seen.append)
    progress.add_finish_listener(seen.append)
    try:
        fp = FitProgress("SRM.fit", 4, n_chunks=2)
        _observe_n(fp, 2)
        fp.finish("converged")
    finally:
        progress.remove_finish_listener(seen.append)
    assert len(seen) == 1
    assert (seen[0]["status"], seen[0]["fit_id"]) == ("converged",
                                                      fp.fit_id)
    FitProgress("SRM.fit", 2, n_chunks=1).finish("completed")
    assert len(seen) == 1


def test_finish_listener_exceptions_are_swallowed():
    def boom(snapshot):
        raise RuntimeError("telemetry must never break the fit")

    calls = []
    progress.add_finish_listener(boom)
    progress.add_finish_listener(calls.append)
    try:
        FitProgress("SRM.fit", 2, n_chunks=1).finish("completed")
    finally:
        progress.remove_finish_listener(boom)
        progress.remove_finish_listener(calls.append)
    assert len(calls) == 1


def test_progress_records_equal_jax_package_for_the_same_observes():
    """The same observe sequence (objective trend, a NaN, a plateau, a
    rollback) gives records and registry snapshots with the same
    fields and values in both packages."""
    rng = np.random.RandomState(7)
    objectives = list(50.0 - np.cumsum(rng.uniform(0.5, 2.0, 6)))
    objectives += [objectives[-1]] * 6 + [float("nan")]
    out = {}
    for name, pkg in PKGS.items():
        mem = _mem(pkg)
        fp = PROGRESS[name].FitProgress("SRM.fit", 40, fit_id="ef" * 8,
                                        objective="obj", n_chunks=20,
                                        wall0=1.5, chunks0=1)
        for i, value in enumerate(objectives):
            if i == 3:
                fp.note_rollback()
            fp.observe({"obj": np.full(2, value)}, 2 * (i + 2), 2,
                       0.125 * (1 + i % 3))
        fp.finish("diverged")
        pkg.remove_sink(mem)
        snaps = [{k: v for k, v in s.items() if k != "ts"}
                 for s in PROGRESS[name].active_fits()]
        out[name] = ([{k: v for k, v in r.items() if k != "ts"}
                      for r in mem.records], snaps)
    assert out["torch"] == out["jax"]
    names = [r["name"] for r in out["torch"][0] if r["kind"] == "event"]
    assert {"plateau", "divergence_precursor", "fit_finished"} <= \
        set(names)


# -- profile and sanitize --------------------------------------------

def test_memory_watermark_on_the_cpu():
    assert not torch.cuda.is_initialized()
    snap = obs.memory_watermark()
    assert set(snap) == {"hbm_peak", "hbm_in_use", "host_rss"}
    assert snap["hbm_peak"] is None and snap["hbm_in_use"] is None
    assert snap["host_rss"] > 0
    obs.memory_watermark(estimator="fit", before=snap)
    names = {s["name"] for s in obs.collect()}
    assert names == {"host_peak_rss_bytes"}
    assert not torch.cuda.is_initialized()


def test_memory_watermark_gauges_with_a_cuda_context(monkeypatch):
    """With a context, the peak gauge is the growth of
    ``max_memory_allocated`` across the chunk, the in-use gauge the
    allocated bytes after it."""
    readings = iter([(1000, 600), (1500, 700)])
    now = {}

    def peak():
        now.update(zip(("peak", "use"), next(readings)))
        return now["peak"]

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", peak)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda: now["use"])
    before = obs.memory_watermark()
    assert (before["hbm_peak"], before["hbm_in_use"]) == (1000, 600)
    after = obs.memory_watermark(estimator="fit", before=before)
    assert after["hbm_peak"] == 1500
    assert metrics.gauge("hbm_peak_bytes").value(estimator="fit") == 500
    assert metrics.gauge("hbm_bytes_in_use").value(estimator="fit") == 700


def test_sanitizer_enabled_by_the_jax_package_variable(monkeypatch):
    assert not sanitize.enabled()
    monkeypatch.setenv("BRAINIAK_TPU_SANITIZE", "1")
    assert sanitize.enabled()
    sanitize.reset()


def test_call_checked_passes_finite_outputs_through():
    calls = []

    def fn(x):
        calls.append(x)
        return {"v": x * 2, "n": torch.arange(3)}, False

    err, (out, done) = sanitize.call_checked(
        fn, (torch.ones(3),), site="fit", scope="resilient_loop")
    assert err is None and len(calls) == 1
    assert torch.equal(out["v"], torch.full((3,), 2.0))
    assert obs.collect() == []


def test_call_checked_trips_on_non_finite(tmp_path, monkeypatch):
    """An Inf in a tensor or a NaN in an array: the JAX package's
    ``sanitizer`` event, counter and flight dump; the output comes
    back as it was, from one call of fn."""
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    calls = []

    def fn(x):
        calls.append(x)
        bad = x.clone()
        bad[1] = float("inf")
        return ({"v": bad, "w": x, "h": np.array([np.nan])}, False)

    mem = _mem()
    err, (out, _) = sanitize.call_checked(fn, (torch.ones(3),),
                                          site="fit",
                                          scope="resilient_loop")
    obs_sink.remove_sink(mem)
    assert len(calls) == 1
    assert "out[0]['v']" in err and "out[0]['h']" in err
    assert "out[0]['w']" not in err
    assert torch.isinf(out["v"][1])
    (event,) = [r for r in mem.records if r["name"] == "sanitizer"]
    assert event["attrs"] == {"site": "fit", "scope": "resilient_loop",
                              "error": err,
                              "codes": ["JP301", "JP305"]}
    _valid_in_both(event)
    counter = metrics.counter("sanitizer_errors_total")
    assert counter.value(site="fit", scope="resilient_loop") == 1
    manifest = json.load(open(os.path.join(
        flight.last_dump()["path"], "manifest.json")))
    assert manifest["trigger"] == "sanitizer"
    assert manifest["state"]["error"] == err
