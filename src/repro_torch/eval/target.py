"""Recall-targeted planning: "spend slots until predicted recall ≥ X".

The port of ``repro/eval/target.py``.  :class:`RecallCalibration` turns
frontier measurements into a monotone partitions-touched → recall curve;
given a live fleet, :func:`install_recall_target` reads the *actual*
per-query touch distribution from the ``fleet.partitions_touched``
histogram (``IndexFleet.touched_hist``), asks the curve how many partitions
the recall target needs, and registers a
:func:`~repro_torch.core.query.make_recall_target_planner` variant (host and
device planners) whose spend factor closes the gap.  Re-installation with a
new target re-registers the variant and bumps the fleet's placement epoch,
so no cached plan of the old variant can serve.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.query import register_recall_target

__all__ = ["RecallCalibration", "install_recall_target"]


@dataclass(frozen=True)
class RecallCalibration:
    """Monotone partitions-touched → recall curve from measured cells."""

    partitions: Tuple[float, ...]   # ascending mean partitions touched
    recalls: Tuple[float, ...]      # non-decreasing recall envelope

    @classmethod
    def from_cells(cls, cells: Sequence[Dict]) -> "RecallCalibration":
        """Fit from cells carrying ``mean_partitions_touched`` and
        ``recall``; the curve keeps the best recall seen at or below each
        cost (an upper envelope)."""
        pts = sorted((float(c["mean_partitions_touched"]),
                      float(c["recall"])) for c in cells
                     if "mean_partitions_touched" in c and "recall" in c)
        if not pts:
            raise ValueError("no cells with partition/recall measurements")
        parts, recs, best = [], [], 0.0
        for p, r in pts:
            best = max(best, r)
            parts.append(p)
            recs.append(best)
        return cls(partitions=tuple(parts), recalls=tuple(recs))

    def predict(self, partitions: float) -> float:
        """Predicted recall at a partitions-touched budget (clamped)."""
        return float(np.interp(partitions, self.partitions, self.recalls))

    def partitions_for(self, target_recall: float) -> float:
        """Smallest measured budget predicted to reach the target (the
        largest measured budget when nothing does)."""
        for p, r in zip(self.partitions, self.recalls):
            if r >= target_recall:
                return p
        return self.partitions[-1]


def install_recall_target(fleet, target_recall: float,
                          calibration: RecallCalibration, *,
                          name: str = "recall_target",
                          max_spend: float = 8.0) -> float:
    """Register a planner variant sized to hit ``target_recall`` on
    ``fleet``; returns the chosen spend factor.

    The current operating point is the fleet's live per-query
    partitions-touched median (``fleet.touched_hist``, fed by every
    ``IndexFleet.query``); with an empty histogram the calibration curve's
    smallest budget stands in.  The spend factor is the ratio of the
    partitions the target needs to the partitions spent now, clamped to
    ``[1, max_spend]``.
    """
    live_p50 = fleet.touched_hist.quantile(0.5)
    current = live_p50 if live_p50 > 0 else calibration.partitions[0]
    needed = calibration.partitions_for(target_recall)
    spend = min(max(needed / max(current, 1e-9), 1.0), max_spend)
    register_recall_target(spend, name=name)
    with fleet._lock:
        fleet._invalidate_placement()   # cached plans key on the epoch
    return spend
