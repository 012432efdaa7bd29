"""Observability parity: ``repro_torch.obs`` against ``repro.obs``.

The registry and tracer are copies of the JAX package's pure-Python
modules: the same observations give the same histogram counts and
quantiles, and the same span calls the same trees, trace ids, adoption
and ring behaviour.  The port's engine, fleet, network plane and recall
sentinel open the JAX package's span names and register its metric names
(read from the reference sources).
"""
import re
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import registry as j_registry  # noqa: E402
from repro.obs import tracer as j_tracer  # noqa: E402
from repro_torch.fleet import FleetConfig, FleetEngine, IndexFleet  # noqa: E402
from repro_torch.obs import REGISTRY, TRACER, device_trace  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402
from repro_torch.obs import tracer as t_tracer  # noqa: E402
from repro_torch.serve import QueryRequest  # noqa: E402
from repro_torch.utils.config import ClimberConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
K = 10
CFG = dict(series_len=64, paa_segments=8, num_pivots=32, prefix_len=5,
           capacity=128, sample_frac=0.3, max_centroids=12, k=K,
           candidate_groups=4, adaptive_factor=4)


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


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exp", "spiky"])
def test_histogram_quantiles_and_counts_equal_reference(dist):
    rng = np.random.default_rng(7)
    vals = {"lognormal": rng.lognormal(1.0, 1.5, 5000),
            "uniform": rng.uniform(0.0, 100.0, 5000),
            "exp": rng.exponential(3.0, 5000),
            "spiky": np.r_[np.zeros(10), np.full(100, 4.2), 1e-9, 5e8]}[dist]
    regs = [t_registry.MetricsRegistry(), j_registry.MetricsRegistry()]
    hists = [r.histogram("serve.latency_ms", loop="l0") for r in regs]
    for v in vals:
        for h in hists:
            h.observe(v)
    t, j = hists
    assert t.count == j.count == len(vals)
    assert t.sum == j.sum
    for q in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert t.quantile(q) == j.quantile(q)
    assert t.percentiles() == j.percentiles()
    for r in regs:
        r.counter("fleet.inserts").inc(3)
        r.gauge("serve.queue_depth", loop="l0").set(5)
        r.add_collector(lambda: {"fleet.shards": 2}, fleet="f0")
    assert regs[0].snapshot() == regs[1].snapshot()
    for h in hists:
        with pytest.raises(ValueError):
            h.quantile(1.5)


def _shape(tracer_mod):
    """The same span calls through one tracer module; the trees and ids
    (minus clock readings) as comparable data."""
    tr = tracer_mod.SpanTracer(capacity=16, registry=None)
    with tr.span("serve.tick", live=3):
        with tr.span("fleet.query"):
            with tr.span("fleet.plan", shard="t0"):
                pass
            ctx = tr.current_context()
        with tr.span("fleet.merge"):
            pass
    out = {}

    def worker():                        # a compactor thread joins the trace
        with tr.adopt(ctx):
            with tr.span("compact.seal"):
                with tr.span("compact.build"):
                    pass
        with tr.adopt(None):             # a no-op adoption roots its own trace
            with tr.span("compact.swap"):
                pass
        with tr.adopt(12345, span_id=7):
            with tr.span("net.admit"):
                pass
        out["ctx"] = tr.current_context()

    th = threading.Thread(target=worker, name="fleet-compactor")
    th.start()
    th.join()
    spans = [(s.name, s.span_id, s.parent_id, s.trace_id, s.thread, s.attrs)
             for s in tr.spans()]
    tree = tr.tree(tr.roots()[0].trace_id)
    strip = lambda t: {"name": t["name"], "attrs": t["attrs"],
                       "children": [strip(c) for c in t["children"]]}
    tr.set_capacity(4)
    kept = [s.name for s in tr.spans()]
    with tr.span("after"):
        pass
    kept_after = [s.name for s in tr.spans()]
    with pytest.raises(ValueError):
        tr.set_capacity(0)
    return spans, strip(tree), out["ctx"], kept, kept_after, tr.capacity


def test_span_parenting_adopt_and_set_capacity_equal_reference():
    t, j = _shape(t_tracer), _shape(j_tracer)
    assert t == j
    spans = {name: (sid, parent, trace) for name, sid, parent, trace, _, _ in t[0]}
    assert spans["compact.seal"][1] == spans["fleet.query"][0]   # adopted parent
    assert spans["compact.seal"][2] == spans["serve.tick"][0]    # adopted trace
    assert spans["compact.swap"][1] is None                       # its own root
    assert spans["net.admit"][1:] == (7, 12345)


def test_registry_span_histograms_and_dropped_counter():
    for mod, reg_mod in ((t_tracer, t_registry), (j_tracer, j_registry)):
        reg = reg_mod.MetricsRegistry()
        tr = mod.SpanTracer(capacity=2, registry=reg)
        for _ in range(5):
            with tr.span("stage"):
                pass
        assert reg.histogram("span.stage").count == 5
        assert reg.counter("obs.spans_dropped").value == 3


def _names(paths, pattern):
    found = set()
    for p in paths:
        found |= set(re.findall(pattern, (REPO / p).read_text()))
    return found


SPAN = r'TRACER\.span\(\s*"([a-z_.]+)"'
METRIC = r'REGISTRY\.(?:histogram|gauge|counter)\(\s*"([a-z_.]+)"'
COLLECTED = r'"((?:fleet|serve)\.[a-z_]+)":'
MODULES = ["serve/knn_engine.py", "fleet/fleet.py", "fleet/engine.py",
           "fleet/lifecycle/compactor.py", "serve/net/server.py",
           "serve/net/client.py", "obs/sentinel.py", "obs/flight.py"]
REF = [f"src/repro/{m}" for m in MODULES]
PORT = [f"src/repro_torch/{m}" for m in MODULES]
# the port's own names, beside the reference's: the tick's copies, its
# per-row work and the span around a whole ``run`` call
PORT_ONLY = {SPAN: {"serve.run", "serve.upload", "serve.download",
                    "serve.rows"}}


@pytest.mark.parametrize("pattern", [SPAN, METRIC, COLLECTED],
                         ids=["spans", "metrics", "collected"])
def test_engine_and_fleet_names_match_reference(pattern):
    ref = _names(REF, pattern)
    assert ref and _names(PORT, pattern) == ref | PORT_ONLY.get(pattern, set())


def test_port_emits_the_span_tree_and_metrics():
    data = random_walks(0, 1600, CFG["series_len"])
    fleet = IndexFleet(FleetConfig(shard_cfg=ClimberConfig(**CFG), fanout=1,
                                   auto_compact=False), device="cpu")
    fleet.add_shard("t0", data[:800])
    fleet.add_shard("t1", data[800:])
    fleet.insert(random_walks(1, 40, CFG["series_len"]))
    eng = FleetEngine(fleet, batch_size=2, k=K)
    TRACER.clear()
    for i in range(2):
        eng.submit_request(QueryRequest(series=data[i], k=K, request_id=i))
    eng.step()
    tree = TRACER.last_trace("serve.tick")
    names = lambda t: {t["name"]} | set().union(*(names(c) for c in t["children"]))
    assert {"serve.tick", "fleet.query", "fleet.plan", "fleet.refine",
            "fleet.merge"} <= names(tree)
    assert REGISTRY.histogram("serve.latency_ms", loop=eng.obs_label).count == 2
    assert REGISTRY.gauge("serve.queue_depth", loop=eng.obs_label).value == 0
    assert REGISTRY.histogram("fleet.query_latency_ms", fleet=fleet.obs_label).count == 1
    assert REGISTRY.histogram("fleet.partitions_touched",
                              fleet=fleet.obs_label).count == 2
    snap = REGISTRY.snapshot()["gauges"]
    assert snap[f"fleet.inserts{{fleet={fleet.obs_label}}}"] == 40
    assert snap[f"serve.queries{{loop={eng.obs_label}}}"] == 2
    fleet.compact()
    seal = TRACER.last_trace("compact.seal")
    assert {c["name"] for c in seal["children"]} == {"compact.build", "compact.swap"}
    eng.reset_metrics()
    assert REGISTRY.histogram("fleet.query_latency_ms", fleet=fleet.obs_label).count == 0


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(tmp_path / "trace"):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
