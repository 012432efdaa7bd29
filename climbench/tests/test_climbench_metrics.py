"""Each per-layer metric's reader on its own synthetic case, and silence
(None) where the record holds nothing for it to read.

A reader's case sits beside it, as ``CASE`` in ``metrics/<name>.py``:
``record`` holds the top-level keys of a run's record that override
``RECORD`` below, ``value`` what the reader reads there, ``needs_trace``
whether it reads nothing without a trace, and ``silent`` (optional) more
overrides on which it reads nothing.  So a metric is added with its reader
and its entry, and no file here is edited."""
import importlib.util

import pytest

from climbench import spec

# a whole run record, as ``cell.record`` builds it
RECORD = {
    "window_s": 10.0, "n_sets": 500, "latencies_s": [0.02] * 500,
    "stats": {"ticks": 500, "queries": 512000, "featurize_s": 0.5,
              "plan_s": 3.0, "refine_s": 4.0},
    "build_seconds": {"sample": 2.0, "centroids": 3.0, "skeleton": 4.0,
                      "route": 0.5, "store": 0.25, "total": 9.75},
    "setup_s": 20.0, "peak_bytes": 4e10,
    "trace": {"window_s": 10.0, "busy_s": 4.0,
              "stage_device_s": {"query.featurize": [0.001] * 500,
                                 "query.plan": [0.002] * 500,
                                 "query.refine": [0.004] * 250 + [0.006] * 250},
              "stage_kernels": {"query.featurize": [2] * 500,
                                "query.plan": [150] * 499 + [151],
                                "query.refine": [7] * 500},
              "device_ops": {}, "idle_by_span": {}},
    "registry": {"histograms": {"span.serve.tick": {"count": 500, "sum": 18000.0}},
                 "gauges": {}, "counters": {}},
    "refine_work": {"ticks": [0, 499], "bound_s": [0.001, 0.003]},
}
METRICS = sorted(m["name"] for m in spec.load_benchmark()["per_layer"])


def case(name):
    """``CASE`` of ``metrics/<name>.py``, or None where it has none."""
    path = spec.HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"climbench_case_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return getattr(mod, "CASE", None)


CASES = {n: case(n) or {} for n in METRICS}
NEEDS_TRACE = [n for n in METRICS if CASES[n].get("needs_trace")]
SILENT = [(n, i) for n in METRICS for i in range(len(CASES[n].get("silent", [])))]


def test_every_per_layer_metric_has_a_case():
    for name in METRICS:
        c = case(name)
        assert c is not None, f"metrics/{name}.py has no CASE"
        assert {"record", "value", "needs_trace"} <= set(c), name
        assert set(c) <= {"record", "value", "needs_trace", "silent"}, name


@pytest.mark.parametrize("name", METRICS)
def test_reader(name):
    c = case(name)
    assert c is not None, f"metrics/{name}.py has no CASE"
    assert spec.reader(name)(dict(RECORD, **c["record"])) == pytest.approx(c["value"])


@pytest.mark.parametrize("name", NEEDS_TRACE)
def test_reader_without_a_trace_reads_nothing(name):
    rec = dict(RECORD, **case(name)["record"])
    assert spec.reader(name)(dict(rec, trace=None)) is None


@pytest.mark.parametrize("name, i", SILENT)
def test_reader_reads_nothing_where_the_record_holds_nothing(name, i):
    c = case(name)
    rec = dict(RECORD, **c["record"])
    rec.update(c["silent"][i])
    assert spec.reader(name)(rec) is None
