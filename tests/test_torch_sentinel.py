"""Recall sentinel, flight recorder and exporters: ``repro_torch.obs``
against ``repro.obs``.

Both fleets hold the same numpy shards at the reference's ``small_cfg()``
size (the port with ``test_torch_fleet.JaxDraws``, so the shards are the
same), on the CPU.

Tolerances: the sentinels sample the same query indices (the same
``np.random.default_rng(seed)``), the audited recalls agree within 1e-6,
the recalibrated thresholds are equal and the routing traces' hit counts
exact; served answers are bit-equal with the sentinel on and off.  The
Prometheus page, the JSON snapshot and ``spans_jsonl`` are byte-equal for
equal registry contents and spans.  The flight recorders retain the same
traces for the same reasons under an explicit ``threshold_ms`` and under
error triggers (quantile-gated timings are not compared).
"""
import doctest
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.eval import metrics as j_metrics  # noqa: E402
from repro.fleet import FleetConfig as JFleetConfig  # noqa: E402
from repro.fleet import IndexFleet as JIndexFleet  # noqa: E402
from repro.obs import RecallSentinel as JRecallSentinel  # noqa: E402
from repro.obs import export as j_export  # noqa: E402
from repro.obs import flight as j_flight  # noqa: E402
from repro.obs import registry as j_registry  # noqa: E402
from repro.obs import tracer as j_tracer  # noqa: E402
from repro.utils.config import ClimberConfig as JConfig  # noqa: E402
from repro_torch.eval import metrics as t_metrics  # noqa: E402
from repro_torch.fleet import FleetConfig, FleetEngine, IndexFleet  # noqa: E402
from repro_torch.obs import (FLIGHT, REGISTRY, TRACER, FlightRecorder,  # noqa: E402
                             RecallSentinel, snapshot, spans_jsonl,
                             to_prometheus)
from repro_torch.obs import export as t_export  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402
from repro_torch.obs import tracer as t_tracer  # noqa: E402
from repro_torch.serve import QueryRequest  # noqa: E402
from repro_torch.utils.config import ClimberConfig  # noqa: E402
from test_torch_fleet import CFG, K, TOL, JaxDraws, random_walks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_fleet(data):
    fleet = IndexFleet(FleetConfig(shard_cfg=ClimberConfig(**CFG), fanout=1,
                                   delta_capacity=4096, auto_compact=False),
                       device="cpu", draws=JaxDraws())
    for i in range(3):
        fleet.add_shard(f"tenant{i}", data[i * 500:(i + 1) * 500])
    return fleet


@pytest.fixture(scope="module")
def corpus():
    data = random_walks(0, 1500, CFG["series_len"])
    rng = np.random.default_rng(5)
    queries = data[rng.choice(len(data), 24, replace=False)]
    queries += 0.3 * rng.standard_normal(queries.shape).astype(np.float32)
    return data, queries


@pytest.fixture(scope="module")
def fleets(corpus):
    data, _ = corpus
    ref = JIndexFleet(JFleetConfig(shard_cfg=JConfig(**CFG), fanout=1,
                                   delta_capacity=4096, auto_compact=False))
    for i in range(3):
        ref.add_shard(f"tenant{i}", data[i * 500:(i + 1) * 500])
    return ref, port_fleet(data)


def recording(monkeypatch, module):
    """Record every recall the sentinel's lazy ``recall_at_k`` returns."""
    seen, inner = [], module.recall_at_k

    def wrapped(*a, **kw):
        seen.append(inner(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(module, "recall_at_k", wrapped)
    return seen


# ---------------------------------------------------------------------------
# the recall sentinel
# ---------------------------------------------------------------------------
def test_sentinel_matches_reference(fleets, corpus, monkeypatch):
    ref, port = fleets
    _, queries = corpus
    kw = dict(sample_rate=0.5, seed=3, recalibrate_every=4, target_recall=0.9,
              registry=None)
    sentinels = JRecallSentinel(ref, **kw), RecallSentinel(port, **kw)
    try:
        # exhaustive routing and one batch shape: the reference compiles once
        for batch in (queries[:12], queries[12:]):
            ref.query(batch, K, routing="exhaustive", placement="host")
            port.query(batch, K, routing="exhaustive")
        j_pending, t_pending = (list(s._pending) for s in sentinels)
        assert len(t_pending) == len(j_pending) > 4
        for j, t in zip(j_pending, t_pending):
            np.testing.assert_array_equal(t.query, j.query)
            np.testing.assert_array_equal(t.gid, j.gid)
            np.testing.assert_allclose(t.dist.astype(np.float64) ** 2,
                                       j.dist.astype(np.float64) ** 2, atol=TOL)
        j_seen = recording(monkeypatch, j_metrics)
        t_seen = recording(monkeypatch, t_metrics)
        assert sentinels[1].drain() == sentinels[0].drain() == len(j_pending)
        np.testing.assert_allclose(t_seen, j_seen, atol=1e-6)
        assert len(t_seen) == len(j_pending)
        j_snap, t_snap = (s.snapshot() for s in sentinels)
        assert t_snap["audits"] == j_snap["audits"] and t_snap["pending"] == 0
        assert abs(t_snap["online_recall"] - j_snap["online_recall"]) <= 1e-6
        assert t_snap["last_threshold"] is not None
        assert t_snap["last_threshold"] == j_snap["last_threshold"]
        assert port.router.threshold == ref.router.threshold
        assert len(port.routing_traces) == len(ref.routing_traces)
        for (ts, th), (js, jh) in zip(port.routing_traces, ref.routing_traces):
            np.testing.assert_array_equal(th, jh)
            np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
    finally:
        for fleet in (ref, port):
            fleet.sentinel = None
            fleet.routing_traces.clear()
            fleet.router.threshold = None


def test_each_audit_equals_an_independent_scan(fleets, corpus, monkeypatch):
    _, port = fleets
    _, queries = corpus
    sentinel = RecallSentinel(port, sample_rate=1.0, seed=1, registry=None)
    try:
        port.query(queries[:6], K, routing="signature")
        samples = list(sentinel._pending)
        seen = recording(monkeypatch, t_metrics)
        assert sentinel.drain() == 6
        audited = list(seen)
        assert len(audited) == 6
        for sample, got in zip(samples, audited):
            exact_d, exact_g = port.scan_exact(sample.query[None], K)
            assert got == t_metrics.recall_at_k(
                sample.gid[None], exact_g, K, approx_dist=sample.dist[None],
                exact_dist=exact_d)
        assert sentinel.online_recall == pytest.approx(float(np.mean(audited)))
    finally:
        port.sentinel = None
        port.routing_traces.clear()


def test_served_answers_bit_identical_with_sentinel(corpus):
    data, queries = corpus
    plain, watched = port_fleet(data), port_fleet(data)
    sentinel = RecallSentinel(watched, sample_rate=1.0, seed=3, registry=None)
    for routing in ("signature", "adaptive", "exhaustive"):
        d0, g0, _ = plain.query(queries, K, routing=routing)
        d1, g1, _ = watched.query(queries, K, routing=routing)
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(g0, g1)
    assert sentinel.pending() == 3 * len(queries)


def test_engine_builds_and_drains_the_sentinel(corpus):
    data, queries = corpus
    fleet = port_fleet(data)
    engine = FleetEngine(fleet, batch_size=4, k=K, sentinel_rate=1.0,
                         sentinel_recalibrate_every=4)
    assert engine.sentinel is fleet.sentinel
    assert engine.sentinel.recalibrate_every == 4
    tickets = [engine.submit_request(QueryRequest(series=q, k=K, request_id=i))
               for i, q in enumerate(queries[:8])]
    assert engine.step() == 4 and engine.step() == 4   # each tick drains 2
    assert all(t.ok for t in tickets)
    snap = engine.sentinel.snapshot()
    assert (snap["audits"], snap["pending"]) == (4, 4)
    assert snap["last_threshold"] == fleet.router.threshold is not None
    assert FleetEngine(port_fleet(data), batch_size=4).sentinel is None


def test_stale_bounded_and_rate_zero(corpus):
    data, queries = corpus
    fleet = port_fleet(data)
    sentinel = RecallSentinel(fleet, sample_rate=1.0, max_pending=16,
                              registry=None)
    for _ in range(2):
        fleet.query(queries, K)
    assert sentinel.pending() == 16          # oldest dropped, never grows
    fleet.insert(data[:4])                   # contents moved since serve time
    assert sentinel.drain() == 0 and sentinel.pending() == 0
    assert sentinel.online_recall == 1.0
    off = RecallSentinel(fleet, sample_rate=0.0, registry=None)
    fleet.query(queries, K)
    assert off.pending() == 0
    with pytest.raises(ValueError):
        RecallSentinel(fleet, sample_rate=1.5, registry=None)


def test_gauge_and_worker_thread(corpus):
    data, queries = corpus
    fleet = port_fleet(data)
    sentinel = RecallSentinel(fleet, sample_rate=1.0, seed=2)
    fleet.query(queries[:8], K)
    sentinel.start(interval_s=0.01)
    try:
        deadline = time.monotonic() + 30
        while sentinel.pending() and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        sentinel.stop()
    assert sentinel._worker is None and sentinel.snapshot()["audits"] == 8
    page = to_prometheus(REGISTRY)
    assert f'repro_fleet_online_recall{{fleet="{fleet.obs_label}"}}' in page
    assert f'repro_sentinel_audits_total{{fleet="{fleet.obs_label}"}} 8' in page


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
def fill(reg):
    reg.counter("serve.queries", loop="e0").inc(12)
    reg.counter("net.frames_in", conn="c1").inc()
    reg.gauge("serve.queue_depth", loop="e0").set(3)
    reg.gauge("fleet.online_recall", fleet="f0").set(0.8125)
    reg.gauge("weird-name.x", a="1", b="two").set(1e20)
    rng = np.random.default_rng(1)
    for v in rng.lognormal(1.0, 1.2, 300):
        reg.histogram("serve.latency_ms", loop="e0").observe(float(v))
    reg.histogram("net.rtt_ms", client="c").observe(0.25)
    reg.histogram("empty.ms")
    reg.add_collector(lambda: {"fleet.shards": 2.0, "fleet.queries": 7},
                      fleet="f0")
    return reg


def test_prometheus_and_snapshot_byte_equal():
    t_reg, j_reg = fill(t_registry.MetricsRegistry()), fill(j_registry.MetricsRegistry())
    page = to_prometheus(t_reg)
    assert page == j_export.to_prometheus(j_reg)
    assert page.encode() == j_export.to_prometheus(j_reg).encode()
    assert to_prometheus(t_reg, prefix="x") == j_export.to_prometheus(j_reg, prefix="x")
    assert json.dumps(snapshot(t_reg), sort_keys=True) == \
        json.dumps(j_export.snapshot(j_reg), sort_keys=True)
    for name in ("serve.latency_ms", "a-b.c", "span.compact.seal"):
        assert t_export.prom_name(name) == j_export.prom_name(name)


def test_spans_jsonl_byte_equal():
    fields = [("serve.tick", 5, 4, 9, 1.0, 1.25, 1700000000.123456789, "t",
               {"live": 3, "loop": "e0"}),
              ("fleet.query", 6, None, 6, 2.0, 2.0009, 0.5, "exec", {})]
    t_spans = [t_tracer.Span(*f) for f in fields]
    j_spans = [j_tracer.Span(*f) for f in fields]
    assert spans_jsonl(t_spans) == j_export.spans_jsonl(j_spans)
    tr = t_tracer.SpanTracer()
    with tr.span("root", n=2):
        with tr.span("leaf"):
            pass
    lines = [json.loads(x) for x in spans_jsonl(tr.spans()).strip().splitlines()]
    assert [x["name"] for x in lines] == ["leaf", "root"]
    snap = snapshot(t_registry.MetricsRegistry(), tracer=tr)
    assert snap["traces"][0]["name"] == "root"
    assert snap["traces"][0]["children"][0]["name"] == "leaf"


def test_export_doctests():
    result = doctest.testmod(t_export)
    assert result.attempted > 0 and result.failed == 0


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
def _request(tracer, flight, *, trigger="serve.tick", error=None, fail=False):
    """One synthetic request trace: admission, then a trigger span (or a
    noted error and, for an executor fault, the ``net.fail`` marker)."""
    tid = tracer.mint_trace_id()
    with tracer.adopt(tid):
        with tracer.span("net.admit"):
            if error is not None and not fail:
                flight.note_error(tid, error)
        if error is None:
            with tracer.span(trigger):
                with tracer.span("fleet.query"):
                    pass
        elif fail:
            with tracer.span("serve.tick"):
                pass
            flight.note_error(tid, error)
            with tracer.span("net.fail", code=error):
                pass
    return tid


SCENARIO = [dict(), dict(error="RETRY_LATER"), dict(trigger="other.span"),
            dict(error="INTERNAL", fail=True), dict(), dict(error="QUOTA_EXCEEDED")]


def run_scenario(obs_tracer, obs_flight, obs_registry, threshold_ms, **kw):
    reg = obs_registry.MetricsRegistry()
    tracer = obs_tracer.SpanTracer(capacity=1024, registry=reg)
    flight = obs_flight.FlightRecorder(tracer, threshold_ms=threshold_ms,
                                       registry=reg, **kw)
    tids = [_request(tracer, flight, **s) for s in SCENARIO]
    recs = [(tids.index(r["trace_id"]), r["reason"], r["trigger"],
             [s["name"] for s in r["spans"]]) for r in flight.records()]
    counts = (reg.counter("flight.retained").value,
              reg.counter("flight.dropped").value)
    flight.close()
    return recs, counts, flight


@pytest.mark.parametrize("threshold_ms", [1e6, 0.0])
def test_flight_recorder_retains_as_the_reference(threshold_ms):
    want = run_scenario(j_tracer, j_flight, j_registry, threshold_ms)
    got = run_scenario(t_tracer, t_flight_module(), t_registry, threshold_ms)
    assert got[:2] == want[:2]
    reasons = {r[1] for r in got[0]}
    assert {"error:RETRY_LATER", "error:INTERNAL", "error:QUOTA_EXCEEDED"} <= reasons
    assert ("latency>0ms" in reasons) == (threshold_ms == 0.0)
    lines = got[2].jsonl().strip().splitlines()
    assert [json.loads(x)["reason"] for x in lines] == [r[1] for r in got[0]]


def t_flight_module():
    from repro_torch.obs import flight
    return flight


def test_flight_recorder_bounds_and_warmup():
    recs, counts, _ = run_scenario(t_tracer, t_flight_module(), t_registry, None,
                                   min_samples=32)
    assert all(r[1].startswith("error:") for r in recs)   # gate not armed yet
    tracer = t_tracer.SpanTracer(capacity=4096)
    flight = FlightRecorder(tracer, threshold_ms=0.0, capacity=8,
                            max_open_traces=4, registry=None)
    for _ in range(32):
        _request(tracer, flight)
    assert len(flight.records()) == 8 and len(flight.records(limit=3)) == 3
    for _ in range(32):
        _request(tracer, flight, trigger="not.a.trigger")
    assert len(flight._open) <= 4
    flight.clear()
    assert flight.records() == []
    flight.close()
    assert FLIGHT.tracer is TRACER
