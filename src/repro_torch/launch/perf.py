"""§Perf hillclimbing harness (the JAX package's ``repro.launch.perf`` in
PyTorch).

Runs named optimization variants of selected dry-run cells, re-deriving the
roofline terms after each change (:func:`repro_torch.launch.dryrun.run_cell`
on ``meta`` slots), and writes ``artifacts/torch/perf/*.json``.

Variants are combinations of the knobs:
  flash_bf16     — bf16 flash operands (f32 accumulation)
  masked_cache   — one-hot decode-cache write
  decode_shard   — flash-decoding over a sequence-split cache
  serve_weights  — weights replicated over the data axis (no FSDP gathers)
  seq_acts=0     — disable sequence-parallel saved activations
  mu=N           — override gradient-accumulation depth
  pad_heads=N    — zero-pad attention heads to a model-axis-divisible count
  kv_chunk=N     — flash chunk size

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --cell starcoder2-15b:decode_32k \\
      --variant masked_cache --variant masked_cache+flash_bf16
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.utils.config import ModelConfig

ART = Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "perf"


def pad_heads_cfg(cfg: ModelConfig, to: int) -> ModelConfig:
    """Zero-pad q (and kv, when kv == heads) heads so they shard.

    Padding heads with zero-initialised wq/wk/wv/wo rows leaves the function
    mathematically identical while making the head dim divisible by the
    model axis — trades +(to/heads − 1) redundant head FLOPs for full 16-way
    parallelism instead of full replication.
    """
    kv = to if cfg.num_kv_heads == cfg.num_heads else cfg.num_kv_heads
    return cfg.replace(num_heads=to, num_kv_heads=kv)


def apply_variant(cfg: ModelConfig, variant: str):
    """Parse 'knob+knob' into (cfg', kv_chunk, mu); set module flags."""
    L.set_flash_bf16(False)
    L.set_cache_update_masked(False)
    M.set_seq_shard_acts(True)
    kv_chunk = 2048
    mu = None
    for knob in [k for k in variant.split("+") if k and k != "baseline"]:
        if knob == "flash_bf16":
            L.set_flash_bf16(True)
        elif knob == "masked_cache":
            L.set_cache_update_masked(True)
        elif knob == "decode_shard":
            # resolved to the actual mesh in run_variant
            pass
        elif knob == "serve_weights":
            # serving profile: weights replicated over the data axis (no
            # per-token FSDP re-gathers); TP over model stays.  Valid when
            # params/model-shards fit HBM — checked by the memory proof.
            P.DEFAULT_RULES["embed"] = None
        elif knob == "seq_acts=0":
            M.set_seq_shard_acts(False)
        elif knob.startswith("mu="):
            mu = int(knob.split("=")[1])
        elif knob.startswith("pad_heads="):
            cfg = pad_heads_cfg(cfg, int(knob.split("=")[1]))
        elif knob.startswith("kv_chunk="):
            kv_chunk = int(knob.split("=")[1])
        else:
            raise ValueError(f"unknown knob {knob!r}")
    return cfg, kv_chunk, mu


def switches() -> dict:
    """Every module switch a variant may set, as it stands."""
    return {"flash_bf16": L.FLASH_BF16, "cache_update_masked": L.CACHE_UPDATE_MASKED,
            "decode_shard": L.DECODE_SHARD, "seq_shard_acts": M.SEQ_SHARD_ACTS,
            "inner_unroll": L.INNER_SCAN_UNROLL, "embed_rule": P.DEFAULT_RULES["embed"],
            "pick_microbatches": DR.pick_microbatches, "get_config": DR.get_config}


def _restore(saved: dict) -> None:
    L.set_flash_bf16(saved["flash_bf16"])
    L.set_cache_update_masked(saved["cache_update_masked"])
    L.DECODE_SHARD = saved["decode_shard"]
    M.set_seq_shard_acts(saved["seq_shard_acts"])
    L.set_inner_unroll(saved["inner_unroll"])
    P.DEFAULT_RULES["embed"] = saved["embed_rule"]
    DR.pick_microbatches = saved["pick_microbatches"]
    DR.get_config = saved["get_config"]


def run_variant(arch: str, shape_name: str, variant: str,
                *, multi_pod: bool = False) -> dict:
    """One cell under ``variant``'s knobs.  Every switch, ``DEFAULT_RULES
    ["embed"]`` and the dry-run hooks are left as they were found, also
    when the variant or the cell raises."""
    saved = switches()
    try:
        cfg, kv_chunk, mu = apply_variant(get_config(arch), variant)
        if "decode_shard" in variant.split("+"):
            from repro_torch.launch.mesh import make_production_mesh
            n = 512 if multi_pod else 256
            mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
            L.set_decode_shard(mesh, tuple(a for a in mesh.axis_names if a != "model"))
        if mu is not None:
            DR.pick_microbatches = lambda *a, **k: mu
        # run through the standard cell runner with the modified config
        orig_get = saved["get_config"]
        DR.get_config = lambda a: cfg if a == arch else orig_get(a)
        res = DR.run_cell(arch, shape_name, multi_pod=multi_pod,
                          kv_chunk=kv_chunk, verbose=False)
    finally:
        _restore(saved)
    res["variant"] = variant
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    variants = args.variant or ["baseline"]

    ART.mkdir(parents=True, exist_ok=True)
    for v in variants:
        res = run_variant(arch, shape, v, multi_pod=args.multi_pod)
        tag = v.replace("+", "_").replace("=", "")
        out = ART / f"{arch}_{shape}_{tag}.json"
        out.write_text(json.dumps(res, indent=2))
        if res.get("status") == "ok":
            print(f"{arch}×{shape} [{v}]: compute={res['compute_s']:.4f}s "
                  f"memory={res['memory_s']:.4f}s "
                  f"collective={res['collective_s']:.4f}s "
                  f"bottleneck={res['bottleneck']} "
                  f"frac={res['roofline_fraction']:.3f} "
                  f"temp={res['memory']['temp_bytes']/2**30:.1f}GiB")
        else:
            print(f"{arch}×{shape} [{v}]: {res.get('status')} "
                  f"{res.get('error', '')[:100]}")


if __name__ == "__main__":
    main()
