"""The serve loop's copies per tick: the mean of the window's
``span.serve.upload`` observations (the query batch to the card) plus that
of its ``span.serve.download`` observations (the answers to the host),
from the program's registry over the window."""
from climbench.registry import mean


def read(record):
    up, down = mean(record, "span.serve.upload"), mean(record, "span.serve.download")
    return None if up is None or down is None else up + down


CASE = {"record": {"registry": {"histograms": {
            "span.serve.upload": {"count": 500, "sum": 1000.0},
            "span.serve.download": {"count": 500, "sum": 900.0}},
            "gauges": {}, "counters": {}}},
        "value": 2.0 + 1.8, "needs_trace": False,
        "silent": [{"registry": {"histograms": {}, "gauges": {}, "counters": {}}},
                   {"registry": {"histograms": {
                       "span.serve.upload": {"count": 500, "sum": 1000.0}},
                       "gauges": {}, "counters": {}}}]}
