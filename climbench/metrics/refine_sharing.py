"""How many queries share a planned partition in a refine call: the mean
of the window's ``refine.queries_per_partition`` observations (live
(query, partition) pairs over distinct planned partitions, one a call),
from the program's registry over the window, the calls' counts still in
flight landed by ``flush_sharing`` before it is read."""
from climbench.registry import mean


def read(record):
    return mean(record, "refine.queries_per_partition")


CASE = {"record": {"registry": {"histograms": {
            "refine.queries_per_partition": {"count": 500, "sum": 4100.0}},
            "gauges": {}, "counters": {}}},
        "value": 8.2, "needs_trace": False,
        "silent": [{"registry": {"histograms": {}, "gauges": {}, "counters": {}}}]}
