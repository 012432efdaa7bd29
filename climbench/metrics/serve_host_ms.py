"""Host time of the serve loop per tick: the window's wall time per tick
less the engine's three stage times (``EngineStats``), i.e. the per-row
results, the copies to the host, the padding and the client's own reading
of its next set."""


def read(record):
    st = record["stats"]
    if not st["ticks"]:
        return None
    stages = st["featurize_s"] + st["plan_s"] + st["refine_s"]
    return (record["window_s"] - stages) / st["ticks"] * 1e3


CASE = {"record": {"window_s": 10.0,
                   "stats": {"ticks": 500, "queries": 512000, "featurize_s": 0.5,
                             "plan_s": 3.0, "refine_s": 4.0}},
        "value": (10.0 - 7.5) / 500 * 1e3, "needs_trace": False}
