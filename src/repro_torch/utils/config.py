"""Configuration of the port: the retrieval plane and the model plane.

:class:`ClimberConfig` holds the paper's feature-extraction, indexing and
query parameters; the defaults follow Section VII-A of the paper (r=200
pivots, prefix m=10, K=500, CLIMBER-kNN-Adaptive-4X).  :class:`ModelConfig`
describes one architecture of the model zoo (``repro_torch.configs``) and
:class:`ShapeConfig` one input-shape cell.  Same fields, defaults and
validation as ``repro.utils.config``, so a configuration serialised by
either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


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


@dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture from the public pool.

    ``family`` selects the compute graph:
      dense | moe | ssm | hybrid | encdec | vlm
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default d_model // num_heads

    # positional / attention details
    rope_theta: float = 10_000.0
    use_rope: bool = True

    # MLA (minicpm3)
    use_mla: bool = False
    kv_lora_rank: int = 256
    q_lora_rank: int = 768
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    shared_expert_d_ff: int = 0

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # hybrid (zamba2): one shared attention block applied every k layers
    hybrid_attn_every: int = 6

    # enc-dec (whisper)
    num_encoder_layers: int = 0

    # vlm (llama-3.2-vision): cross-attn layer inserted every k layers
    cross_attn_every: int = 0
    num_image_tokens: int = 1024

    # training
    dtype: str = "bfloat16"
    remat: str = "dots"              # "none" | "dots" | "full"
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs run the long_500k cell."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str              # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; valid: {[s.name for s in SHAPES]}")
