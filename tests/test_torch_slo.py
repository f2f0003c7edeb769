"""The port's live metric plane and SLO watchdog against the JAX package's.

One fake clock (``telemetry._monotonic`` of both packages) and one seeded
stream of observations drive both packages' windowed registries, SLO
watchdogs and snapshot exporters; every comparison is exact (the two
implement the same arithmetic on the same Python floats). No test waits
on the wall clock beyond the exporter thread's stop.
"""

import gc
import json
import os
import sys

import numpy as np
import pytest

from sparkdl_tpu.core import health as jax_health
from sparkdl_tpu.core import slo as jax_slo
from sparkdl_tpu.core import telemetry as jax_telemetry
from sparkdl_tpu_torch.core import health, slo, telemetry


class _FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    """One fake clock read by both packages' rings and exporters."""
    c = _FakeClock()
    monkeypatch.setattr(telemetry, "_monotonic", c)
    monkeypatch.setattr(jax_telemetry, "_monotonic", c)
    return c


@pytest.fixture(autouse=True)
def _catalogs():
    """Names declared by a test leave both catalogs as they were."""
    saved = {m: dict(m.CANONICAL_METRIC_KINDS)
             for m in (telemetry, jax_telemetry)}
    yield
    for m, kinds in saved.items():
        m.CANONICAL_METRIC_KINDS.clear()
        m.CANONICAL_METRIC_KINDS.update(kinds)
        m.CANONICAL_METRIC_NAMES = frozenset(kinds)


STREAM_STEPS = 120


def _stream(seed: int = 3):
    """(dt, kind, name, value, exemplar span id) steps: latencies with a
    burst in the middle, counter bumps, gauge sets, time moving on."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(STREAM_STEPS):
        dt = float(rng.choice([0.05, 0.2, 0.7, 1.3]))
        burst = 40 <= i < 70
        lat = float(rng.lognormal(np.log(0.4 if burst else 0.01), 0.5))
        steps.append((dt, "histogram", telemetry.M_QUEUE_WAIT_S, lat,
                      1000 + i))
        if rng.random() < 0.4:
            steps.append((0.0, "counter", telemetry.HEALTH_METRIC_PREFIX
                          + health.EXECUTOR_SHED, int(rng.integers(1, 4)),
                          None))
        if rng.random() < 0.5:
            steps.append((0.0, "gauge", telemetry.M_EXECUTOR_QUEUE_DEPTH,
                          float(rng.integers(0, 30)), None))
    return steps


def _feed(step, registries, clock):
    dt, kind, name, value, span = step
    clock.advance(dt)
    for reg, mod in registries:
        if kind == "histogram":
            ctx = mod.SpanContext("trace-x", span)
            reg.histogram(name).observe(value, ctx)
        elif kind == "counter":
            reg.counter(name).inc(value)
        else:
            reg.gauge(name).set(value)


def _exemplars_as_tuples(snap):
    for h in snap["histograms"].values():
        if "exemplars" in h:
            h["exemplars"] = [(e["value"], e["trace_id"], e["span_id"])
                              for e in h["exemplars"]]
    return snap


@pytest.mark.parametrize("window_s", [2.0, 6.0, None])
def test_window_snapshots_match_under_one_clock(clock, window_s):
    """Windowed counts, rates, gauge envelopes, percentiles and tail
    exemplars of both registries, after every step of the stream."""
    ours = telemetry.MetricsRegistry(window_s=12.0, window_buckets=12,
                                     exemplar_k=3)
    ref = jax_telemetry.MetricsRegistry(window_s=12.0, window_buckets=12,
                                        exemplar_k=3)
    regs = [(ours, telemetry), (ref, jax_telemetry)]
    seen_exemplars = 0
    for step in _stream():
        _feed(step, regs, clock)
        a = _exemplars_as_tuples(ours.window_snapshot(window_s))
        b = _exemplars_as_tuples(ref.window_snapshot(window_s))
        assert a == b
        seen_exemplars += sum(len(h.get("exemplars", ()))
                              for h in a["histograms"].values())
    assert seen_exemplars > 0
    assert ours.snapshot() == ref.snapshot()
    assert ours.export_frame() == ref.export_frame()
    assert ours.prometheus_text().replace("sparkdl_tpu_torch ", "") == \
        ref.prometheus_text().replace("sparkdl_tpu ", "")


def test_ring_free_registry_matches(clock):
    """A registry built without windows answers empty windowed views and
    no frame, in both packages."""
    ours, ref = telemetry.MetricsRegistry(), jax_telemetry.MetricsRegistry()
    for step in _stream()[:20]:
        _feed(step, [(ours, telemetry), (ref, jax_telemetry)], clock)
    assert ours.window_snapshot() == ref.window_snapshot()
    assert ours.export_frame() is None and ref.export_frame() is None
    assert ours.snapshot() == ref.snapshot()


def _serving_rules(mod, window_s, for_s):
    return mod.default_serving_rules({"clf": 0.05}, window_s=window_s,
                                     for_s=for_s)


@pytest.mark.parametrize("for_s", [0.0, 1.5])
def test_watchdogs_emit_the_same_breach_sequence(clock, for_s):
    """Both watchdogs over both registries, evaluated at the same ticks:
    the same verdicts at every tick and the same slo_breach /
    slo_recovered sequence (rule and observed value)."""
    ours = telemetry.MetricsRegistry(window_s=6.0, window_buckets=12)
    ref = jax_telemetry.MetricsRegistry(window_s=6.0, window_buckets=12)
    rules = (slo.default_rules(window_s=3.0, for_s=for_s,
                               queue_wait_p99_s=0.2)
             + _serving_rules(slo, 3.0, for_s))
    jrules = (jax_slo.default_rules(window_s=3.0, for_s=for_s,
                                    queue_wait_p99_s=0.2)
              + _serving_rules(jax_slo, 3.0, for_s))
    dog, jdog = slo.SLOWatchdog(rules), jax_slo.SLOWatchdog(jrules)
    serving = telemetry.serving_request_metric("clf")
    with health.HealthMonitor() as mon, jax_health.HealthMonitor() as jmon:
        for i, step in enumerate(_stream(seed=11)):
            _feed(step, [(ours, telemetry), (ref, jax_telemetry)], clock)
            # the per-model serving latency rides the same stream
            _feed((0.0, "histogram", serving, step[3] * 0.3, 0),
                  [(ours, telemetry), (ref, jax_telemetry)], clock)
            if i % 3 == 0:
                assert dog.evaluate(ours, now=clock.t) == \
                    jdog.evaluate(ref, now=clock.t)
        clock.advance(10.0)  # every window empties: recovery
        assert dog.evaluate(ours, now=clock.t) == \
            jdog.evaluate(ref, now=clock.t)
    events = [(e["event"], e["rule"], e["observed"])
              for e in mon.events() if e["event"].startswith("slo_")]
    jevents = [(e["event"], e["rule"], e["observed"])
               for e in jmon.events() if e["event"].startswith("slo_")]
    assert events == jevents
    kinds = [e[0] for e in events]
    assert health.SLO_BREACH in kinds and health.SLO_RECOVERED in kinds
    assert "serving_request_p99_clf" in {e[1] for e in events}
    assert dog.state() == jdog.state()


def test_rule_builders_match():
    """Every shipped builder makes the reference's rules."""
    def fields(rules):
        return [(r.name, r.metric, r.window_s, r.threshold, r.comparator,
                 r.stat, r.for_s) for r in rules]

    targets = {"b": 0.2, "a": 0.1}
    for name, args in (("default_rules", ()),
                       ("default_serving_rules", (targets,)),
                       ("cluster_serving_rules", (targets,)),
                       ("tenant_queue_wait_rules", ({"t1": 0.3},)),
                       ("federated_default_rules", ()),
                       ("federated_tenant_queue_wait_rules", ({"t": 1.0},)),
                       ("federated_cluster_serving_rules", (targets,))):
        assert fields(getattr(slo, name)(*args, window_s=5.0, for_s=0.5)) \
            == fields(getattr(jax_slo, name)(*args, window_s=5.0,
                                             for_s=0.5)), name
    assert fields(slo.DEFAULT_RULES) == fields(jax_slo.DEFAULT_RULES)


@pytest.mark.parametrize("kwargs", [
    dict(metric="sparkdl.typo", stat="p99"),
    dict(metric=telemetry.M_BATCH_ROWS, stat="p99"),
    dict(metric=telemetry.M_QUEUE_WAIT_S, stat="value"),
    dict(metric=telemetry.M_QUEUE_WAIT_S, comparator="!="),
    dict(metric=telemetry.M_QUEUE_WAIT_S, window_s=0.0),
    dict(metric=telemetry.M_QUEUE_WAIT_S, for_s=-1.0),
    dict(metric="sparkdl.health.not_an_event", stat="count"),
])
def test_rule_validation_matches(kwargs):
    """A rule the reference refuses, the port refuses with the same
    message; the same rule with a declared name is accepted by both."""
    full = dict(name="r", window_s=1.0, threshold=1.0)
    full.update(kwargs)
    with pytest.raises(ValueError) as ours:
        slo.SLORule(**full)
    with pytest.raises(ValueError) as ref:
        jax_slo.SLORule(**full)
    assert str(ours.value) == str(ref.value)
    ok = dict(name="ok", metric=telemetry.HEALTH_METRIC_PREFIX
              + health.SERVING_SHED, window_s=1.0, threshold=1.0,
              stat="rate_per_s")
    assert slo.SLORule(**ok).metric == jax_slo.SLORule(**ok).metric


def test_declare_metric_kinds_match():
    """Dynamic names: idempotent, a second kind refused in both."""
    name = telemetry.serving_request_metric("m-declared")
    assert name == jax_telemetry.serving_request_metric("m-declared")
    for mod in (telemetry, jax_telemetry):
        assert mod.declare_metric(name, "histogram") == name
        assert mod.declare_metric(name, "histogram") == name
        with pytest.raises(ValueError, match="already declared"):
            mod.declare_metric(name, "counter")
        with pytest.raises(ValueError, match="kind must be"):
            mod.declare_metric(name + ".x", "summary")
    assert telemetry.CANONICAL_SPAN_NAMES <= \
        jax_telemetry.CANONICAL_SPAN_NAMES
    for span in (telemetry.SPAN_MODEL_LOAD, telemetry.SPAN_SERVING_SHADOW,
                 telemetry.SPAN_SERVING_WARMUP):
        assert span in telemetry.CANONICAL_SPAN_NAMES


def _isolated_modules(monkeypatch):
    """Both exporters see the state of a fresh process: no cluster plane
    of the reference imported, no live ModelServer of the port."""
    for name in ("sparkdl_tpu.serving.cluster", "sparkdl_tpu.cluster.router"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    gc.collect()


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_exporters_tick_alike_under_one_clock(clock, tmp_path, monkeypatch):
    """Both packages' exporters ticked at the same fake times: the same
    ticks due, the same number of snapshot lines with the same keys
    (windowed and cumulative sections included), the same SLO verdicts,
    a final flush, and a Prometheus file in place of a torn one."""
    _isolated_modules(monkeypatch)
    out = {}
    for label, mod, smod in (("ours", telemetry, slo),
                             ("ref", jax_telemetry, jax_slo)):
        d = tmp_path / label
        rules = smod.default_serving_rules({"clf": 0.05}, window_s=4.0)
        start = clock.t
        with mod.Telemetry(label, window_s=4.0, window_buckets=8,
                           slo_rules=rules) as tel:
            exp = mod.SnapshotExporter(tel, interval_s=0.5, out_dir=str(d),
                                       watchdog=smod.SLOWatchdog(rules))
            due = []
            for step in _stream(seed=5)[:60]:
                _feed(step, [(tel.metrics, mod)], clock)
                mod.observe(mod.serving_request_metric("clf"), step[3])
                due.append(exp.tick_if_due())
            exp.close()
        clock.t = start  # the second package replays the same times
        out[label] = (due, _lines(exp.snapshot_path), exp)
        prom = open(exp.prom_path).read()
        assert "sparkdl_executor_queue_wait_s_bucket" in prom
        assert not os.path.exists(exp.prom_path + ".tmp")
    (due, lines, exp), (jdue, jlines, jexp) = out["ours"], out["ref"]
    assert due == jdue and any(due)
    assert len(lines) == len(jlines) == exp.seq == jexp.seq
    assert [sorted(line) for line in lines] == \
        [sorted(line) for line in jlines]
    assert lines[-1]["final"] is True
    for a, b in zip(lines, jlines):
        assert a["seq"] == b["seq"] and a["uptime_s"] == b["uptime_s"]
        assert a["slo"] == b["slo"]
        assert a["windowed"] == b["windowed"]
        assert a["cumulative"]["histograms"] == \
            b["cumulative"]["histograms"]
    assert [e for e in exp.timeline_summary()["entries"]] == \
        [e for e in jexp.timeline_summary()["entries"]]


def test_scope_runs_exporter_thread_and_reports_timeline(tmp_path):
    """``Telemetry(export_interval_s=...)`` starts the cadence thread,
    stops it at exit with a final flush, writes the report with its
    ``timeline`` and leaves no exporter thread behind; a crashing tick
    records telemetry_export_error and the thread goes on."""
    import threading

    rules = slo.default_serving_rules({"clf": 0.001}, window_s=2.0)
    with health.HealthMonitor() as mon:
        with telemetry.Telemetry("live", out_dir=str(tmp_path),
                                 window_s=2.0, export_interval_s=0.02,
                                 slo_rules=rules) as tel:
            telemetry.observe(telemetry.serving_request_metric("clf"), 0.5)
            exp = tel.exporter
            assert exp is not None and exp._thread.is_alive()
            deadline = telemetry._monotonic() + 2.0
            while exp.seq < 2 and telemetry._monotonic() < deadline:
                threading.Event().wait(0.01)
            broken = exp._compact
            exp._compact = lambda snap: 1 / 0
            exp.tick()
            exp._compact = broken
        report = json.load(open(tel.report_path))
    assert mon.count(health.TELEMETRY_EXPORT_ERROR) == 1
    assert mon.count(health.SLO_BREACH) == 1
    lines = _lines(exp.snapshot_path)
    assert len(lines) >= 3 and lines[-1]["final"] is True
    timeline = report["timeline"]
    assert timeline["snapshots"] == exp.seq and timeline["errors"] == 1
    assert timeline["entries"] and timeline["entries"][-1]["final"]
    assert "serving_request_p99_clf" in timeline["entries"][-1][
        "slo_breached"]
    assert not any(t.name.startswith("sparkdl-telemetry-export")
                   for t in threading.enumerate())
    prom = open(exp.prom_path).read()
    assert "sparkdl_serving_request_s_clf_count 1" in prom


def test_rule_window_past_ring_refused():
    for mod, smod in ((telemetry, slo), (jax_telemetry, jax_slo)):
        with pytest.raises(ValueError, match="ring capacity"):
            mod.Telemetry("x", window_s=2.0,
                          slo_rules=smod.default_rules(window_s=5.0))
        with pytest.raises(ValueError, match="export_interval_s"):
            mod.Telemetry("x", export_interval_s=0.0)
