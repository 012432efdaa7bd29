"""The index build's host steps 1-3 (sample, centroids, skeleton), from
``ClimberIndex.build_seconds``."""


def read(record):
    b = record["build_seconds"]
    return b["sample"] + b["centroids"] + b["skeleton"]


CASE = {"record": {"build_seconds": {"sample": 2.0, "centroids": 3.0, "skeleton": 4.0,
                                    "route": 0.5, "store": 0.25, "total": 9.75}},
        "value": 9.0, "needs_trace": False}
