"""Recall-targeted planning: a measured partitions→recall curve.

:class:`RecallCalibration` turns frontier measurements into a monotone
partitions-touched → recall curve and answers how many partitions a recall
target needs; ``repro_torch.core.query.register_recall_target`` registers a
planner that spends that much more.  The JAX package's
``install_recall_target`` reads a fleet's live partitions-touched histogram
and bumps its placement epoch, so it waits for the fleet slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["RecallCalibration"]


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
