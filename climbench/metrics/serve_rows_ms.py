"""The serve loop's per-row work per tick: the mean of the window's
``span.serve.rows`` observations (typed results, ``QueryMetrics``, the
latency observe and the stats sums of one tick), from the program's
registry over the window."""
from climbench.registry import mean


def read(record):
    return mean(record, "span.serve.rows")


CASE = {"record": {"registry": {"histograms": {
            "span.serve.rows": {"count": 500, "sum": 6000.0}},
            "gauges": {}, "counters": {}}},
        "value": 12.0, "needs_trace": False,
        "silent": [{"registry": {"histograms": {}, "gauges": {}, "counters": {}}},
                   {"registry": {"histograms": {
                       "span.serve.rows": {"count": 0, "sum": 0.0}},
                       "gauges": {}, "counters": {}}}]}
