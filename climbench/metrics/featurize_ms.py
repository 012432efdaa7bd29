"""Featurize per tick: ``EngineStats.featurize_s`` over the window (wall
time of PAA and pivot rank, ended by a synchronize), per tick."""


def read(record):
    st = record["stats"]
    return st["featurize_s"] / st["ticks"] * 1e3 if st["ticks"] else None


CASE = {"record": {"stats": {"ticks": 500, "queries": 512000, "featurize_s": 0.5,
                             "plan_s": 3.0, "refine_s": 4.0}},
        "value": 1.0, "needs_trace": False}
