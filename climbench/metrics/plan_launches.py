"""Device kernels started inside the ``query.plan`` spans of the traced
window, per span (one per tick): the planner's launches, a count."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["stage_kernels"]["query.plan"]:
        return None
    counts = tr["stage_kernels"]["query.plan"]
    return sum(counts) / len(counts)


CASE = {"record": {"trace": {"stage_kernels": {"query.plan": [150] * 499 + [151]}}},
        "value": (150 * 499 + 151) / 500, "needs_trace": True}
