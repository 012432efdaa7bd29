"""The program's counters over the window, as the run's record holds them.

``cell.window`` snapshots ``repro_torch.obs.REGISTRY`` just before the
window and again just after it, outside the timed loop; ``delta`` turns the
two snapshots into ``record["registry"]``, and a reader takes a histogram's
mean over the window with ``mean``.  This module imports nothing of the
program, so a reader that uses it stays a pure function of the record.
"""
from __future__ import annotations

from typing import Optional


def delta(before: dict, after: dict) -> dict:
    """``record["registry"]``: each histogram's ``count`` and ``sum`` after
    less before (a histogram first seen after counts from zero), and each
    gauge and counter at the window's end."""
    hists = {}
    for name, h in after["histograms"].items():
        b = before["histograms"].get(name, {"count": 0, "sum": 0.0})
        hists[name] = {"count": h["count"] - b["count"], "sum": h["sum"] - b["sum"]}
    return {"histograms": hists, "gauges": dict(after["gauges"]),
            "counters": dict(after["counters"])}


def mean(record: dict, name: str) -> Optional[float]:
    """The mean of histogram ``name``'s observations in the window, or None
    where the record holds none (a program that lacks the histogram)."""
    h = (record.get("registry") or {}).get("histograms", {}).get(name)
    return h["sum"] / h["count"] if h and h["count"] > 0 else None
