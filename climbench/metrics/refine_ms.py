"""Refine per tick: ``EngineStats.refine_s`` over the window, per tick."""


def read(record):
    st = record["stats"]
    return st["refine_s"] / st["ticks"] * 1e3 if st["ticks"] else None
