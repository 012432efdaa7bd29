"""Configuration of the CLIMBER retrieval plane.

:class:`ClimberConfig` holds the paper's feature-extraction, indexing and
query parameters; the defaults follow Section VII-A of the paper (r=200
pivots, prefix m=10, K=500, CLIMBER-kNN-Adaptive-4X).  Same fields, defaults
and validation as ``repro.utils.config.ClimberConfig``, so a configuration
serialised by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ClimberConfig:
    """Parameters of CLIMBER-FX / CLIMBER-INX / CLIMBER-kNN."""

    # --- feature extraction (CLIMBER-FX, paper §IV) ---
    series_len: int = 256          # n — raw data-series length
    paa_segments: int = 16         # w — PAA word length
    num_pivots: int = 200          # r — pivots in the system (paper default)
    prefix_len: int = 10           # m — pivot-permutation-prefix length
    decay: str = "exp"             # pivot-weight decay: "exp" | "linear"
    decay_lambda: float = 0.5      # λ for exponential decay (paper Example 1)

    # --- indexing (CLIMBER-INX, paper §V) ---
    capacity: int = 3000           # c — partition capacity constraint (Def. 12)
    sample_frac: float = 0.1       # α — skeleton sample fraction
    centroid_min_od: int = 2       # ε — min OD between accepted centroids (Alg. 2)
    max_centroids: int = 64        # optional stopping condition (Alg. 2)

    # --- query processing (paper §VI) ---
    k: int = 500                   # K — kNN answer size (paper default 500)
    candidate_groups: int = 4      # T — groups retained for tie-breaking
    adaptive_factor: int = 4       # 1 => CLIMBER-kNN; 2/4 => Adaptive-2X/4X
    base_partitions: int = 1       # partitions CLIMBER-kNN may touch
    query_max_slots: Optional[int] = None
                                   # static slot budget for compact_plan
                                   # (None => the lossless per-variant default
                                   # from repro_torch.core.query.default_slot_budget)

    # --- store layout ---
    partition_pad: Optional[int] = None  # physical slot count per partition
                                         # (defaults to the fullest partition)

    def __post_init__(self):
        if self.prefix_len > self.num_pivots:
            raise ValueError("prefix_len (m) must be <= num_pivots (r)")
        if self.series_len % self.paa_segments != 0:
            raise ValueError("series_len must be divisible by paa_segments")
        if self.decay not in ("exp", "linear"):
            raise ValueError(f"unknown decay {self.decay!r}")
        if not (0.0 < self.sample_frac <= 1.0):
            raise ValueError("sample_frac must be in (0, 1]")

    @property
    def max_partitions(self) -> int:
        """MaxNumPartitions cap for the adaptive algorithm."""
        return self.base_partitions * self.adaptive_factor

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ClimberConfig":
        return cls(**json.loads(s))

    def replace(self, **kw) -> "ClimberConfig":
        return dataclasses.replace(self, **kw)
