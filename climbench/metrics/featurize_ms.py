"""Featurize per tick: ``EngineStats.featurize_s`` over the window (wall
time of PAA and pivot rank, ended by a synchronize), per tick."""


def read(record):
    st = record["stats"]
    return st["featurize_s"] / st["ticks"] * 1e3 if st["ticks"] else None
