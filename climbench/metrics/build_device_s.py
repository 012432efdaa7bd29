"""The index build's device steps (route every record, scatter the
store), each ended by a synchronize, from ``ClimberIndex.build_seconds``."""


def read(record):
    b = record["build_seconds"]
    return b["route"] + b["store"]


CASE = {"record": {"build_seconds": {"sample": 2.0, "centroids": 3.0, "skeleton": 4.0,
                                    "route": 0.5, "store": 0.25, "total": 9.75}},
        "value": 0.75, "needs_trace": False}
