"""Each per-layer metric's reader on a synthetic run record, and silence
(None) where the record holds nothing for it to read."""
import pytest

from climbench import spec

RECORD = {
    "window_s": 10.0,
    "stats": {"ticks": 500, "queries": 512000, "featurize_s": 0.5,
              "plan_s": 3.0, "refine_s": 4.0},
    "build_seconds": {"sample": 2.0, "centroids": 3.0, "skeleton": 4.0,
                      "route": 0.5, "store": 0.25, "total": 9.75},
    "trace": {"window_s": 10.0, "busy_s": 4.0,
              "stage_device_s": {"query.featurize": [0.001] * 500,
                                 "query.plan": [0.002] * 500,
                                 "query.refine": [0.004] * 250 + [0.006] * 250},
              "stage_kernels": {"query.featurize": [2] * 500,
                                "query.plan": [150] * 499 + [151],
                                "query.refine": [7] * 500},
              "device_ops": {}, "idle_by_span": {}},
    "refine_work": {"ticks": [0, 499], "bound_s": [0.001, 0.003]},
}
EXPECTED = {
    "serve_host_ms": (10.0 - 7.5) / 500 * 1e3,
    "featurize_ms": 1.0,
    "plan_ms": 6.0,
    "refine_ms": 8.0,
    "plan_launches": (150 * 499 + 151) / 500,
    "refine_roofline": (0.001 + 0.003) / (0.004 + 0.006) * 100,
    "build_host_s": 9.0,
    "build_device_s": 0.75,
    "device_idle_share": 60.0,
}
NEEDS_TRACE = {"plan_launches", "refine_roofline", "device_idle_share"}


def test_every_per_layer_metric_has_a_case():
    names = {m["name"] for m in spec.load_benchmark()["per_layer"]}
    assert names == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    assert spec.reader(name)(RECORD) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(NEEDS_TRACE))
def test_reader_without_a_trace_reads_nothing(name):
    assert spec.reader(name)(dict(RECORD, trace=None)) is None


def test_roofline_without_a_peak_reads_nothing():
    rec = dict(RECORD, refine_work={"ticks": [0], "bound_s": [None]})
    assert spec.reader("refine_roofline")(rec) is None
