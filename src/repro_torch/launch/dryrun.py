"""Multi-pod dry-run: count every (arch × shape × mesh) cell on ``meta``
slots (the JAX package's ``repro.launch.dryrun`` in PyTorch).

For each cell this module
  1. builds the production mesh (16×16 single-pod / 2×16×16 multi-pod) of
     ``meta`` slots (``make_production_mesh(devices=["meta"] * n)``),
  2. lays the parameters, AdamW state, batch or cache out on it as
     ``meta`` pieces — shapes only, nothing allocated,
  3. runs the right step once (the sharded train step, prefill or
     decode, the port's own mesh forms) under a
     :class:`~repro_torch.utils.roofline.CostCounter`, at 1 and 2 layer
     units, and extends the count to full depth by the reference's
     two-point rule,
  4. prints the memory proof and the counts and writes the roofline terms
     to ``artifacts/torch/dryrun/<arch>_<shape>_<mesh>.json`` (the
     reference's ``artifacts/dryrun/`` is never written).

The reference's compile is the proof that a cell fits: here the proof is
arithmetic, the exact bytes of slot 0's pieces of the step's arguments
(``memory.argument_bytes``); ``memory.temp_bytes`` is the counted peak of
bytes allocated while the step runs, extended to full depth by the same
two-point rule, as a mean over the slots.  ``lower_s`` is the host seconds
to lay the cell out, ``compile_s`` the host seconds the counts took.  The
counts are not XLA's (see :mod:`repro_torch.utils.roofline`).

Skip rules: ``long_500k`` runs only for the sub-quadratic archs (zamba2,
mamba2) — dense-attention archs would need a 500k dense KV per step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both [--force]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import List, Union

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model, count_params, decode_step, prefill
from repro_torch.models.decoding import cache_shapes, init_cache
from repro_torch.models.params import tree_leaves
from repro_torch.train.optimizer import AdamW, constant_lr
from repro_torch.train.train_step import (make_batch_shardings, make_train_step,
                                          shard_train_step)
from repro_torch.utils import roofline as RL
from repro_torch.utils.config import SHAPES, ModelConfig, ShapeConfig, get_shape

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "dryrun"


def _shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return get_shape(shape) if isinstance(shape, str) else shape


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ----------------------------------------------------------------------
# abstract inputs
# ----------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape_name: Union[str, ShapeConfig]):
    """``meta`` stand-ins for every model input of one cell (the
    reference's ``ShapeDtypeStruct`` tree)."""
    shape = _shape(shape_name)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((b, s + 1) if shape.kind == "train" else (b, s),
                                 torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        if cfg.family == "vlm":
            batch["image_embeds"] = _meta((b, cfg.num_image_tokens, cfg.d_model),
                                          torch.bfloat16)
        return batch
    # decode: one new token against a seq_len cache
    enc_len = s if cfg.family == "encdec" else 0
    img_len = cfg.num_image_tokens if cfg.family == "vlm" else 0
    return {
        "token": _meta((b, 1), torch.int32),
        "cache": {k: _meta(v.shape, v.dtype)
                  for k, v in cache_shapes(cfg, b, s, enc_len=enc_len,
                                           img_len=img_len).items()},
    }


def cell_is_skipped(cfg: ModelConfig, shape_name: str) -> str:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention arch: 500k dense KV per decode step is "
                "the quadratic blow-up the long_500k rule exempts")
    return ""


# ----------------------------------------------------------------------
# the cell runner
# ----------------------------------------------------------------------
def unit_scaler(cfg: ModelConfig):
    """(unit_count, make_cfg(units)) — 'unit' = one repeated layer group."""
    if cfg.family == "hybrid":
        per = cfg.hybrid_attn_every
        return cfg.num_layers // per, \
            lambda u: cfg.replace(num_layers=u * per)
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        return cfg.num_layers // per, \
            lambda u: cfg.replace(num_layers=u * per)
    if cfg.family == "encdec":
        return cfg.num_layers, \
            lambda u: cfg.replace(num_layers=u, num_encoder_layers=u)
    return cfg.num_layers, lambda u: cfg.replace(num_layers=u)


def pick_microbatches(cfg: ModelConfig, shape, mesh) -> int:
    """Gradient-accumulation depth so saved activations stay ≤ ~3 GB/device.

    Napkin model: the remat residual set is 2 block outputs per layer,
    [B, S, D] bf16, sharded over batch shards × the model axis (sequence
    parallelism).  µ splits the global batch; capped so each microbatch
    still shards evenly.  ``mesh`` needs ``axis_names`` and
    ``devices.shape`` only.
    """
    if shape.kind != "train":
        return 1
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    shards = int(np.prod([v for k, v in sizes.items() if k != "model"]))
    layers = cfg.num_layers + cfg.num_encoder_layers
    per_layer = (2 * shape.global_batch * shape.seq_len * cfg.d_model * 2
                 / (shards * sizes["model"]))
    total = per_layer * layers
    target = 3 * (1 << 30)
    cap = max(shape.global_batch // shards, 1)
    mu = 1
    while total / mu > target and mu < cap:
        mu *= 2
    return mu


def active_params(cfg: ModelConfig, n_params: int) -> int:
    """MoE: only top-k of the routed experts are active per token
    (MODEL_FLOPS = 6·N_active·D per the roofline spec)."""
    if cfg.family != "moe" or not cfg.num_experts:
        return n_params
    routed = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff * cfg.num_layers
    inactive = routed * (1.0 - cfg.experts_per_token / cfg.num_experts)
    return int(n_params - inactive)


def _bytes(tree) -> List[int]:
    return [t.numel() * t.element_size() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _model(cfg: ModelConfig, mesh) -> Model:
    return Model(cfg) if mesh is None else Model(
        cfg, mesh=mesh, batch_axes=tuple(a for a in mesh.axis_names if a != "model"))


def _cache(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """The decode cell's cache on ``meta`` (one cache per slot on a mesh),
    written next at its last position."""
    enc_len = shape.seq_len if cfg.family == "encdec" else 0
    img_len = cfg.num_image_tokens if cfg.family == "vlm" else 0
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, enc_len, img_len,
                       device="meta", mesh=mesh)
    for c in ([cache] if mesh is None else cache):
        c["len"] = shape.seq_len - 1
    return cache


def _slot0(tree, mesh):
    """Slot 0's pieces of a whole batch tree (the tree itself without a mesh)."""
    return tree if mesh is None else make_batch_shardings(mesh, tree).shard(tree)[0]


def argument_bytes(cfg: ModelConfig, shape_name: Union[str, ShapeConfig], mesh) -> List[int]:
    """The memory proof: the bytes of each tensor of slot 0's arguments —
    its parameter pieces, then its AdamW moments and step and its batch
    rows (train), its batch rows (prefill), or its cache pieces and token
    rows (decode).  Shapes only: everything is laid out on ``meta``."""
    shape = _shape(shape_name)
    model = _model(cfg, mesh)
    params = model.abstract() if mesh is None else model.param_layout().shard(model.abstract())[0]
    out = _bytes(params)
    if shape.kind == "train":
        n = [t.numel() for t in tree_leaves(params)]
        out += [4] + [4 * x for x in n] * 2
        out += _bytes(_slot0(input_specs(cfg, shape), mesh))
    elif shape.kind == "prefill":
        out += _bytes(_slot0(input_specs(cfg, shape), mesh))
    else:
        cache = _cache(cfg, shape, mesh)
        out += _bytes({k: v for k, v in (cache if mesh is None else cache[0]).items()
                       if k != "len"})
        out += _bytes(_slot0({"token": input_specs(cfg, shape)["token"]}, mesh))
    return out


def lower_cell(cfg: ModelConfig, shape_name: Union[str, ShapeConfig], mesh,
               kv_chunk: int, microbatches: int = 0):
    """Lay one cell out on ``mesh``'s slots (``meta``) and run its step once
    under a :class:`~repro_torch.utils.roofline.CostCounter`.  Returns
    ``(counter, meta)``: ``meta`` holds ``n_params``, ``tokens``, ``kind``
    and ``microbatches``.

    ``mesh=None`` counts the one-device step (no mesh forms) on ``meta``.
    ``microbatches``: 0 = derive from this cfg.  Cost counts must pass the
    FULL config's µ so the reduced-depth runs share the real structure.
    """
    shape = _shape(shape_name)
    model = _model(cfg, mesh)
    params = model.abstract() if mesh is None else model.param_layout().shard(model.abstract())
    n_params = count_params(model.infos())
    counter = RL.CostCounter(1 if mesh is None else mesh.size)
    mu = 1
    if shape.kind == "train":
        opt = AdamW(lr=constant_lr(3e-4))
        batch = input_specs(cfg, shape)
        mu = microbatches or (1 if mesh is None else pick_microbatches(cfg, shape, mesh))
        if mesh is None:
            opt_state = opt.init(params)
            step = make_train_step(model, opt, kv_chunk=kv_chunk, microbatches=mu)
        else:
            opt_state = opt.init_slots(params)
            step = shard_train_step(model, opt, mesh, kv_chunk=kv_chunk, microbatches=mu)
        with counter:
            step(params, opt_state, batch)
        tokens = shape.global_batch * shape.seq_len
        kind = "train"
    elif shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        with counter, torch.no_grad():
            prefill(model, params, batch, kv_chunk=kv_chunk)
        tokens = shape.global_batch * shape.seq_len
        kind = "serve"
    else:                                                    # decode
        cache = _cache(cfg, shape, mesh)
        token = input_specs(cfg, shape)["token"]
        with counter, torch.no_grad():
            decode_step(model, params, cache, token)
        tokens = shape.global_batch                           # one token / seq
        kind = "serve"
    return counter, {"n_params": n_params, "tokens": tokens, "kind": kind,
                     "microbatches": mu}


def _cost_of(counter: RL.CostCounter):
    return (counter.flops_per_device, counter.bytes_per_device,
            dict(counter.coll_per_device), counter.peak_per_device)


def measure_scaled_cost(cfg: ModelConfig, shape_name: Union[str, ShapeConfig], mesh,
                        kv_chunk: int):
    """Per-step cost by the reference's two-point rule: count the 1-unit
    and 2-unit configs; the difference is exactly one layer group, and
    ``total = cost(1) + (units - 1) · Δ``.

    Returns ``(flops, bytes, coll, temp_bytes)`` per device; the reference
    returns the first three (its temp bytes come from the full-config
    compile, which the port does not run).  ``set_inner_unroll`` is set as
    in the reference; eager torch counts every chunk either way.
    """
    from repro_torch.models.layers import set_inner_unroll
    units, make_cfg = unit_scaler(cfg)
    # µ comes from the FULL config: the reduced-depth runs must share the
    # real step's microbatch structure
    mu = pick_microbatches(cfg, _shape(shape_name), mesh) if mesh is not None else 1
    set_inner_unroll(True)
    try:
        f1, b1, coll1, p1 = _cost_of(lower_cell(make_cfg(1), shape_name, mesh, kv_chunk,
                                                microbatches=mu)[0])
        f2, b2, coll2, p2 = _cost_of(lower_cell(make_cfg(2), shape_name, mesh, kv_chunk,
                                                microbatches=mu)[0])
    finally:
        set_inner_unroll(False)
    scale = units - 1
    flops = f1 + scale * max(f2 - f1, 0.0)
    byts = b1 + scale * max(b2 - b1, 0.0)
    coll = {k: int(coll1[k] + scale * max(coll2[k] - coll1[k], 0)) for k in coll1}
    temp = p1 + scale * max(p2 - p1, 0.0)
    return flops, byts, coll, temp


def model_bytes(cfg: ModelConfig, shape_name: Union[str, ShapeConfig], n_params: int) -> float:
    """A decode step's mandatory traffic: one read of the bf16 weights and
    of the cache (0 for other kinds)."""
    if _shape(shape_name).kind != "decode":
        return 0.0
    cache = input_specs(cfg, shape_name)["cache"]
    return n_params * 2 + float(sum(t.numel() * t.element_size() for t in cache.values()))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             kv_chunk: int = 2048, verbose: bool = True,
             skip_cost: bool = False) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    skip = cell_is_skipped(cfg, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": skip}

    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    n_dev = mesh.size

    # ---- 1. the memory proof: slot 0's argument bytes (arithmetic) -------
    t0 = time.time()
    n_params = count_params(Model(cfg).infos())
    arg_bytes = sum(argument_bytes(cfg, shape_name, mesh))
    t_lower = time.time() - t0

    # ---- 2. the counted cost, by the two-point rule ----------------------
    t0 = time.time()
    if skip_cost:
        flops = byts = temp = 0.0
        coll = {}
    else:
        flops, byts, coll, temp = measure_scaled_cost(cfg, shape_name, mesh, kv_chunk)
    t_count = time.time() - t0
    kind = "train" if shape.kind == "train" else "serve"
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mflops = RL.model_flops(n_params, tokens, kind,
                            active_params=active_params(cfg, n_params))
    # decode: the mandatory per-token traffic is one read of weights + cache
    mbytes = model_bytes(cfg, shape_name, n_params)
    report = RL.RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name,
        flops_per_device=flops, bytes_per_device=byts,
        coll_bytes_per_device=float(sum(coll.values())),
        coll_breakdown=coll,
        model_flops_per_device=mflops / n_dev,
        model_bytes_per_device=mbytes / n_dev,
        peak_memory_bytes=float(arg_bytes + temp),
    )
    result = {
        "status": "ok", "num_params": n_params, "num_devices": n_dev,
        "lower_s": round(t_lower, 1), "compile_s": round(t_count, 1),
        "microbatches": pick_microbatches(cfg, shape, mesh),
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": 0,
            "temp_bytes": int(temp),
            "code_bytes": 0,
        },
        **report.to_dict(),
    }
    if verbose:
        gb = 1 << 30
        print(f"[{arch} × {shape_name} × {mesh_name}]"
              f" params={n_params/1e9:.2f}B"
              f" args={result['memory']['argument_bytes']/gb:.2f}GiB/dev"
              f" temp={result['memory']['temp_bytes']/gb:.2f}GiB/dev"
              f" flops/dev={report.flops_per_device:.3g}"
              f" coll/dev={report.coll_bytes_per_device/1e6:.1f}MB"
              f" bottleneck={report.bottleneck}"
              f" roofline={report.roofline_fraction:.2f}"
              f" (lay out {t_lower:.0f}s count {t_count:.0f}s)")
        print("  memory:", {k: v for k, v in result["memory"].items()})
        print("  counted: flops=%.4g bytes=%.4g" %
              (report.flops_per_device, report.bytes_per_device))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--kv-chunk", type=int, default=2048)
    ap.add_argument("--skip-cost", action="store_true",
                    help="memory proof only (multi-pod pass); roofline "
                         "terms come from the single-pod artifacts")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = [s.name for s in SHAPES] if args.shape == "all" \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    ART_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                mesh_name = "2x16x16" if multi else "16x16"
                out = ART_DIR / f"{arch}_{shape_name}_{mesh_name}.json"
                if out.exists() and not args.force:
                    print(f"skip existing {out.name}")
                    continue
                try:
                    res = run_cell(arch, shape_name, multi_pod=multi,
                                   kv_chunk=args.kv_chunk,
                                   skip_cost=args.skip_cost)
                except Exception as e:                     # noqa: BLE001
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(out.name)
                out.write_text(json.dumps(res, indent=2))
    if failures:
        print(f"\nFAILED cells: {failures}")
        raise SystemExit(1)
    print("\nall requested cells passed")


if __name__ == "__main__":
    main()
