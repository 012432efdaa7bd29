"""The program's counters in the run record: the registry's delta over the
window by hand, and on a cell at a size the CPU holds, that the window's
observations and only those are counted, with the refine kernel's sharing
counts still in flight landed before each snapshot."""
import gc
import time

import pytest
import torch

from climbench import cell, registry
from climbench.tests.conftest import shrink
from repro_torch.kernels import refine_topk
from repro_torch.obs import REGISTRY

CPU = torch.device("cpu")
SEED = 2**35 + 3


def shrink_through_the_kernel(c):
    """A cell the CPU holds, refined through the kernel's entry (its plain
    version here), which counts the plans' sharing as on the card."""
    shrink(c)
    c["traffic"]["serving"]["use_kernel"] = True


def test_delta_by_hand():
    before = {"histograms": {"a": {"count": 3, "sum": 6.0, "p50": 2.0},
                             "b": {"count": 1, "sum": 1.0}},
              "gauges": {"g": 1.0}, "counters": {"c": 4}}
    after = {"histograms": {"a": {"count": 5, "sum": 16.0, "p50": 3.0},
                            "b": {"count": 1, "sum": 1.0},
                            "new": {"count": 2, "sum": 3.0}},
             "gauges": {"g": 7.0}, "counters": {"c": 9}}
    assert registry.delta(before, after) == {
        "histograms": {"a": {"count": 2, "sum": 10.0}, "b": {"count": 0, "sum": 0.0},
                       "new": {"count": 2, "sum": 3.0}},
        "gauges": {"g": 7.0}, "counters": {"c": 9}}


def test_mean_reads_nothing_where_the_histogram_is_absent_or_empty():
    rec = {"registry": registry.delta(
        {"histograms": {"a": {"count": 2, "sum": 4.0}}, "gauges": {}, "counters": {}},
        {"histograms": {"a": {"count": 2, "sum": 4.0}, "b": {"count": 4, "sum": 2.0}},
         "gauges": {}, "counters": {}})}
    assert registry.mean(rec, "b") == 0.5
    assert registry.mean(rec, "a") is None
    assert registry.mean(rec, "c") is None
    assert registry.mean({}, "b") is None


@pytest.fixture(scope="module")
def state():
    c = cell.load("rand256.adaptive-b4096")
    shrink_through_the_kernel(c)
    st = cell.setup(c, SEED, CPU, time.perf_counter())
    yield c, st
    gc.unfreeze()


def test_the_window_counts_its_own_observations(state):
    c, st = state
    win = cell.window(st, c["traffic"], SEED, 0.2, CPU, False)
    hists, ticks = win["registry"]["histograms"], win["stats"]["ticks"]
    assert ticks > 0
    # reset_metrics empties the span histograms, not the sharing one, which
    # holds the warm-up's calls too: only the window's are counted
    for name in ("span.serve.tick", "span.serve.upload", "span.serve.download",
                 "span.serve.rows", refine_topk.SHARING):
        assert hists[name]["count"] == ticks, name
    assert REGISTRY.histogram(refine_topk.SHARING).count > ticks
    assert registry.mean(win, refine_topk.SHARING) > 1.0


def test_counts_in_flight_land_before_each_snapshot(state, monkeypatch):
    c, st = state
    in_flight = []
    observe = refine_topk.observe_sharing

    def flush():
        while in_flight:
            observe(*in_flight.pop(0))

    # each call's count stays in flight until a flush, as on the card
    monkeypatch.setattr(refine_topk, "observe_sharing", lambda *n: in_flight.append(n))
    monkeypatch.setattr(refine_topk, "flush_sharing", flush)
    # a warm-up call whose count is still in flight as the window opens
    st["engine"].run(st["data"][st["order"][-8:]].cpu().numpy())
    assert len(in_flight) == 1
    win = cell.window(st, c["traffic"], SEED + 1, 0.2, CPU, False)
    # the flush before the window lands the warm-up's count outside it,
    # the one after lands the window's last calls inside it
    assert win["registry"]["histograms"][refine_topk.SHARING]["count"] == \
        win["stats"]["ticks"]
    assert not in_flight


def test_a_traced_run_reports_the_registry_metrics():
    res = cell.run("rand256.spend4-b4096", SEED, 0.2, True, t_start=time.perf_counter(),
                   dev=CPU, adjust=shrink_through_the_kernel)
    assert res["correct"] is True
    for name in ("serve_rows_ms", "serve_copy_ms", "refine_sharing"):
        assert res["metrics"][name]["value"] > 0, name
