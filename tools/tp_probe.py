#!/usr/bin/env python3
"""How far the model axis sits from one device, beside how far one device
sits from itself under another rounding.

Two measurements, each at the depths ``--depths`` gives (default: the
arch's full depth; the vlm at ``chip_smoke.LM_DEPTH``), at full width,
seeded as ``chip_smoke.py``'s tp parts (g) and (i) seed them:

1. **forward** (``--archs``, default the families of part (g)): logits of
   ``TP_ROWS`` × ``TP_PROMPT`` tokens on one device in fp32, on one device
   in bf16, and on ``--mesh`` slots of the card in bf16.  Each pair goes
   through ``chip_smoke.logits_rule`` without raising: max |Δ|,
   |Δ|/(1+|logit|), positions whose top-1/top-2 gap exceeds 0.3 and how
   many of them flip the greedy token.  One device's bf16 against its own
   fp32 is the floor of any two bf16 roundings of the model.
2. **step** (``--step-archs``): one fp32 train step of ``TP_GRAD_ROWS`` ×
   ``TP_TRAIN_SEQ`` tokens, AdamW's first moment (the reduced grad) leaf
   by leaf as |Δ| over the leaf's largest entry: ``TP_TRAIN_MESH`` slots
   against one device, and one device in 2 microbatches (the same grads
   summed in another order) against one device — the floor for that
   comparison.

Usage (on the card unless ``--device`` names another): ``python3
tools/tp_probe.py [--archs a,b] [--step-archs a,b] [--depths 48,24,12]
[--mesh 1x4] [--seed 0] [--out PATH] [--device cuda:0]``; prints one JSON
line per measurement and writes them all to PATH when given.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def compare(got, ref):
    """``chip_smoke.logits_rule``'s numbers without its raise, and the
    greedy flips where ``ref``'s top-1/top-2 gap exceeds 0.3."""
    g, r = got.float().reshape(-1, got.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    top2 = r.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0.3
    return {"max_abs_delta": float((g - r).abs().max()),
            "max_abs_logit": float(r.abs().max()),
            "rel_err": float(((g - r).abs() / (1 + r.abs())).max()),
            "gap_over_0.3": int(clear.sum()),
            "flips_over_0.3": int((clear & (g.argmax(-1) != r.argmax(-1))).sum())}


def depth_cfg(cfg, depth):
    return cfg if depth is None else cfg.replace(num_layers=depth)


def forward_row(cs, arch, depth, mesh, dev, seed):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model
    cfg = get_config(arch)
    cfg = depth_cfg(cfg, depth if depth else cs.LM_DEPTH.get(arch))
    one = Model(cfg)
    batch = TokenPipeline(cfg, global_batch=cs.TP_ROWS, seq_len=cs.TP_PROMPT,
                          seed=seed, device=dev).batch_at(0)
    batch["tokens"] = batch["tokens"][:, :cs.TP_PROMPT]
    draw = lambda **kw: one.init(torch.Generator(device=dev).manual_seed(seed + 5), dev, **kw)
    with torch.no_grad():
        p32 = draw(dtype=torch.float32)
        b32 = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
        l32 = one(p32, b32, kv_chunk=cs.PREFILL_CHUNK).float()
        del p32
        torch.cuda.empty_cache()
        pb = draw()              # the same draws, each leaf in its own dtype
        lb = one(pb, batch, kv_chunk=cs.PREFILL_CHUNK)
        tp = Model(cfg, mesh=mesh)
        pieces = tp.param_layout().shard(pb)
        del pb
        torch.cuda.empty_cache()
        mb = tp(pieces, batch, kv_chunk=cs.PREFILL_CHUNK)
        del pieces
        torch.cuda.empty_cache()
    row = {"measure": "forward", "arch": arch, "layers": cfg.num_layers,
           "mesh": list(mesh.shape.values()),
           "mesh_bf16_vs_one_bf16": compare(mb, lb),
           "one_bf16_vs_one_fp32": compare(lb, l32),
           "mesh_bf16_vs_one_fp32": compare(mb, l32)}
    del l32, lb, mb
    torch.cuda.empty_cache()
    return row


def step_row(cs, arch, depth, dev, seed):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.params import named_params
    from repro_torch.train import (AdamW, constant_lr, make_state_shardings, make_train_step,
                                   shard_train_step)
    cfg = depth_cfg(get_config(arch), depth)
    one = Model(cfg)
    opt = AdamW(lr=constant_lr(cs.TRAIN_LR))
    batch = {k: v[:cs.TP_GRAD_ROWS] for k, v in TokenPipeline(
        cfg, cs.TP_TRAIN_BATCH, cs.TP_TRAIN_SEQ, seed=seed, mode="periodic",
        device=dev).batch_at(0).items()}
    init = lambda: one.init(torch.Generator(device=dev).manual_seed(seed + 4), dev,
                            dtype=torch.float32)

    def moment(run):
        params = init()
        m = run(params)
        del params
        torch.cuda.empty_cache()
        return m

    def worst(a, b):
        rel = {n: float((x - y).abs().max() / x.abs().max().clamp_min(1e-30))
               for (n, x), y in zip(named_params(a).items(), named_params(b).values())}
        w = max(rel, key=rel.get)
        return {"rel_err": rel[w], "worst_leaf": w}

    def one_step(micro):
        step = make_train_step(one, opt, kv_chunk=cs.TRAIN_KV_CHUNK, microbatches=micro)
        return lambda p: step(p, opt.init(p), batch)[1].m

    ref = moment(one_step(1))
    micro = moment(one_step(2))
    mesh = make_mesh(cs.TP_TRAIN_MESH, ("data", "model"),
                     [dev] * (cs.TP_TRAIN_MESH[0] * cs.TP_TRAIN_MESH[1]))
    tp = Model(cfg, mesh=mesh)
    p_lay, o_lay = make_state_shardings(mesh, tp)

    def mesh_step(p):
        pieces = p_lay.shard(p)
        states = shard_train_step(tp, opt, mesh, kv_chunk=cs.TRAIN_KV_CHUNK)(
            pieces, opt.init_slots(pieces), batch)[1]
        return o_lay.gather(states).m

    got = moment(mesh_step)
    row = {"measure": "step", "arch": arch, "layers": cfg.num_layers,
           "mesh": list(cs.TP_TRAIN_MESH), "rows": cs.TP_GRAD_ROWS, "seq": cs.TP_TRAIN_SEQ,
           "mesh_vs_one": worst(ref, got), "one_2_microbatches_vs_one": worst(ref, micro)}
    del ref, micro, got
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default=None)
    ap.add_argument("--step-archs", default="")
    ap.add_argument("--depths", default="")
    ap.add_argument("--mesh", default="1x4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda:0", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.launch import make_mesh

    dev = torch.device(args.device)
    shape = tuple(int(v) for v in args.mesh.split("x"))
    mesh = make_mesh(shape, ("data", "model"), [dev] * (shape[0] * shape[1]))
    depths = [int(d) for d in args.depths.split(",") if d] or [None]
    rows = []
    archs = args.archs.split(",") if args.archs else list(cs.TP_FAMILIES)
    for arch in [a for a in archs if a]:
        for depth in depths:
            rows.append(forward_row(cs, arch, depth, mesh, dev, args.seed))
            print(json.dumps(rows[-1]), flush=True)
    for arch in [a for a in args.step_archs.split(",") if a]:
        for depth in depths:
            rows.append(step_row(cs, arch, depth, dev, args.seed))
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
