"""How far one work item of the partition-major refine outlasts the grid's
even share of its call: the mean of the window's ``refine.item_tail``
observations (one a partition-major call: the largest item's slots x
queries over the call's total per persistent scoring block; above 1 the
item sets the call's end), from the program's registry over the window,
the calls' counts still in flight landed by ``flush_sharing`` before it is
read."""
from climbench.registry import mean


def read(record):
    return mean(record, "refine.item_tail")


CASE = {"record": {"registry": {"histograms": {
            "refine.item_tail": {"count": 400, "sum": 100.0}},
            "gauges": {}, "counters": {}}},
        "value": 0.25, "needs_trace": False,
        "silent": [{"registry": {"histograms": {}, "gauges": {}, "counters": {}}}]}
