"""The index build's device steps (route every record, scatter the
store), each ended by a synchronize, from ``ClimberIndex.build_seconds``."""


def read(record):
    b = record["build_seconds"]
    return b["route"] + b["store"]
