"""Share of the traced window in which no operation ran on the device,
in percent (``busy_s`` is the union of the device operations' intervals)."""


def read(record):
    tr = record["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


CASE = {"record": {"trace": {"window_s": 10.0, "busy_s": 4.0}},
        "value": 60.0, "needs_trace": True}
