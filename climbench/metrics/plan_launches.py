"""Device kernels started inside the ``query.plan`` spans of the traced
window, per span (one per tick): the planner's launches, a count."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["stage_kernels"]["query.plan"]:
        return None
    counts = tr["stage_kernels"]["query.plan"]
    return sum(counts) / len(counts)
