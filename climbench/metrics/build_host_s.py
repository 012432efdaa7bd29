"""The index build's host steps 1-3 (sample, centroids, skeleton), from
``ClimberIndex.build_seconds``."""


def read(record):
    b = record["build_seconds"]
    return b["sample"] + b["centroids"] + b["skeleton"]
