"""The serve loop's spans and what they cost (CPU).

One tick is one ``serve.tick`` span covering all of it — the upload, the
three stages, the answers' download and the per-row work — and ``run``
wraps its ticks in ``serve.run``.  The engine's stage seconds are the
stage spans' durations, the latency histogram takes one observe per
``run`` tick with the buckets that one observe per row gave, and the
stats take sums per tick.  Spans open profiler ranges only inside the
program's own capture (``device_trace``); under the benchmark's capture,
which mirrors the spans itself, each span is one range.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import query as tq  # noqa: E402
from repro_torch.core.index import build_index  # noqa: E402
from repro_torch.obs import REGISTRY, TRACER, device_trace  # noqa: E402
from repro_torch.obs.registry import Histogram  # noqa: E402
from repro_torch.serve import ClimberEngine, QueryRequest  # noqa: E402
from repro_torch.utils.config import ClimberConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
K = 10
BATCH = 4
CFG = dict(series_len=64, paa_segments=8, num_pivots=32, prefix_len=5,
           capacity=128, sample_frac=0.3, max_centroids=12, k=K,
           candidate_groups=4, adaptive_factor=4)
TICK = ["serve.upload", "query.featurize", "query.plan", "query.refine",
        "serve.download", "serve.rows"]
STAGES = {"featurize_s": "query.featurize", "plan_s": "query.plan",
          "refine_s": "query.refine"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep the port's small CPU tests to one thread: the suite runs beside
    timing-sensitive socket tests in other worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_walks(seed, num, length):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((num, length)), axis=-1)
    return ((x - x.mean(-1, keepdims=True))
            / (x.std(-1, keepdims=True) + 1e-8)).astype(np.float32)


@pytest.fixture(scope="module")
def index():
    data = torch.as_tensor(random_walks(0, 3000, CFG["series_len"]))
    return build_index(data, ClimberConfig(**CFG), device="cpu",
                       generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def queries():
    return random_walks(1, 10, CFG["series_len"])     # ticks of 4, 4, 2


def engine(index):
    eng = ClimberEngine(index, batch_size=BATCH, k=K, variant="adaptive",
                        plan_cache_size=0)
    TRACER.clear()
    return eng


def shape(tree):
    return {"name": tree["name"], "children": [shape(c) for c in tree["children"]]}


def spans_named(name):
    return [s for s in TRACER.spans() if s.name == name]


def test_run_and_step_give_the_whole_tick_tree(index, queries):
    eng = engine(index)
    eng.run(queries)
    tree = TRACER.last_trace("serve.run")
    assert tree["attrs"]["queries"] == 10 and tree["attrs"]["ticks"] == 3
    tick = {"name": "serve.tick",
            "children": [{"name": n, "children": []} for n in TICK]}
    assert shape(tree) == {"name": "serve.run", "children": [tick] * 3}

    for i, q in enumerate(queries[:3]):
        eng.submit_request(QueryRequest(series=q, k=K, request_id=i))
    eng.step()
    tree = TRACER.last_trace("serve.tick")
    assert shape(tree) == tick
    rows = next(c for c in tree["children"] if c["name"] == "serve.rows")
    assert rows["duration_ms"] <= tree["duration_ms"]


def test_stage_seconds_and_wall_time_are_the_spans(index, queries):
    eng = engine(index)
    eng.run(queries)
    for i, q in enumerate(queries[:3]):
        eng.submit_request(QueryRequest(series=q, k=K, request_id=i))
    eng.step()
    st = eng.stats
    for field, name in STAGES.items():
        total = 0.0
        for sp in spans_named(name):
            total += sp.duration_ms * 1e-3
        assert getattr(st, field) == total, field
    run_s = spans_named("serve.run")[0].duration_ms * 1e-3
    tick_s = spans_named("serve.tick")[-1].duration_ms * 1e-3
    assert st.wall_s == run_s + tick_s
    assert st.queries_per_sec == st.queries / st.wall_s
    # a tick's latency runs from the upload's start to refine's end
    ups, refs = spans_named("serve.upload"), spans_named("query.refine")
    assert st.total_s == pytest.approx(
        sum(r.end - u.start for u, r in zip(ups, refs)), rel=1e-12)
    assert st.featurize_s + st.plan_s + st.refine_s < st.total_s < st.wall_s


def test_latency_histogram_and_stats_take_one_observe_per_tick(index, queries):
    eng = engine(index)
    _, _, metrics = eng.run(queries)
    rowwise = Histogram()
    for m in metrics:
        rowwise.observe(m.latency_s * 1e3)
    h = eng.latency_hist
    assert h._counts == rowwise._counts
    assert (h.count, h.min, h.max) == (rowwise.count, rowwise.min, rowwise.max)
    assert h.sum == pytest.approx(rowwise.sum, rel=1e-9)
    st = eng.stats
    assert (st.ticks, st.queries) == (3, len(queries))
    assert st.partitions_touched == sum(m.partitions_touched for m in metrics)
    assert st.candidates_scanned == sum(m.candidates_scanned for m in metrics)
    assert st.total_s == sum(metrics[i].latency_s for i in (0, BATCH, 2 * BATCH))


def test_histogram_count_argument_equals_repeated_observes():
    once, each = Histogram(), Histogram()
    for v, n in ((0.5, 3), (12.25, 4096), (0.0, 2), (1e9, 1), (7.0, 0)):
        once.observe(v, n)
        for _ in range(n):
            each.observe(v)
    assert once._counts == each._counts
    assert (once.count, once.min, once.max) == (each.count, each.min, each.max)
    assert once.sum == pytest.approx(each.sum, rel=1e-9)
    assert once.percentiles() == each.percentiles()


def test_reset_metrics_empties_the_tick_span_histograms(index, queries):
    eng = engine(index)
    eng.run(queries)
    hists = {n: REGISTRY.histogram(f"span.{n}") for n in eng.TICK_SPANS}
    assert set(eng.TICK_SPANS) == {"serve.run", "serve.tick", *TICK}
    assert all(h.count for h in hists.values())
    eng.reset_metrics()
    assert all(h.count == 0 for h in hists.values())
    eng.run(queries[:BATCH])
    assert hists["serve.rows"].count == hists["serve.tick"].count == 1


def test_answers_and_metrics_are_unchanged(index, queries, tmp_path):
    eng = engine(index)
    dist, gid, metrics = eng.run(queries)
    with device_trace(tmp_path / "trace"):
        traced = eng.run(queries)
    np.testing.assert_array_equal(traced[0], dist)
    np.testing.assert_array_equal(traced[1], gid)
    assert [(m.partitions_touched, m.candidates_scanned, m.batch_fill)
            for m in traced[2]] == [(m.partitions_touched, m.candidates_scanned,
                                     m.batch_fill) for m in metrics]
    for i, m in enumerate(metrics):
        d1, g1, qp = tq.knn_query(index, torch.as_tensor(queries[i:i + 1]), K,
                                  variant="adaptive",
                                  max_slots=eng.max_slots)
        np.testing.assert_array_equal(d1.numpy()[0], dist[i])
        np.testing.assert_array_equal(g1.numpy()[0], gid[i])
        assert m.partitions_touched == int(qp.partitions_touched()[0])
        assert m.candidates_scanned == int(
            tq.candidates_scanned(qp, index.store)[0])
        assert m.batch_fill == (BATCH if i < 8 else 2) / BATCH
    tickets = [eng.submit_request(QueryRequest(series=q, k=K, request_id=i))
               for i, q in enumerate(queries)]
    eng.run_until_drained()
    for t, m in zip(tickets, metrics):
        np.testing.assert_array_equal(t.result.gid, gid[t.request.request_id])
        assert (t.result.partitions_touched, t.result.candidates_scanned) == \
            (m.partitions_touched, m.candidates_scanned)


def _ranges(path):
    events = json.loads(Path(path).read_text())["traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    return {n: names.count(n) for n in set(names)}


def test_device_trace_draws_every_span_once(index, queries, tmp_path):
    eng = engine(index)
    assert TRACER.profiling is False
    with eng.capture_device_trace(tmp_path / "trace"):
        assert TRACER.profiling is True
        eng.run(queries)
    assert TRACER.profiling is False
    ranges = _ranges(tmp_path / "trace" / "trace.json")
    assert ranges.get("serve.run") == 1
    for name in ["serve.tick", *TICK]:
        assert ranges.get(name) == 3, name
    # outside the capture no span opens a range
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run(queries[:BATCH])
    assert not {e.name for e in prof.events()} & {"serve.tick", "query.plan"}


def _climbench_trace():
    path = REPO / "climbench" / "trace.py"
    spec = importlib.util.spec_from_file_location("climbench_trace_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_capture_sees_one_range_per_span(index, queries):
    ctrace = _climbench_trace()
    eng = engine(index)
    with ctrace.mirrored_spans(TRACER), ctrace.capture() as prof:
        eng.run(queries)
    assert TRACER.profiling is False
    summary = ctrace.reduce(prof)
    for stage in ctrace.STAGES:
        assert len(summary["stage_kernels"][stage]) == 3, stage
    host, _, _ = ctrace._events(prof)
    counts = {}
    for name, _, _ in host:
        counts[name] = counts.get(name, 0) + 1
    assert counts == {ctrace.WINDOW: 1, "serve.tick": 3, "query.featurize": 3,
                      "query.plan": 3, "query.refine": 3}


def test_build_seconds_are_the_build_spans(index):
    data = torch.as_tensor(random_walks(2, 2000, CFG["series_len"]))
    TRACER.clear()
    ix = build_index(data, ClimberConfig(**CFG), device="cpu",
                     generator=torch.Generator().manual_seed(1))
    steps = ("sample", "centroids", "skeleton", "route", "store")
    got = {s.name: s.duration_ms * 1e-3 for s in TRACER.spans()}
    assert [s.name for s in TRACER.spans()] == [f"build.{s}" for s in steps]
    for step in steps:
        assert ix.build_seconds[step] == got[f"build.{step}"]
    assert ix.build_seconds["total"] == sum(ix.build_seconds[s] for s in steps)
