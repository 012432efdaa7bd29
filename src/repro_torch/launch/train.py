"""End-to-end training (the JAX package's ``repro.launch.train``).

Runs any arch (smoke or full config) for N steps with the whole training
plane engaged: the train step (over a (data, model) mesh when one is
given), the deterministic resumable token pipeline, atomic checkpoints in
the reference's format, watchdog + retry-with-restore recovery.  It runs on
the card unless ``device`` names another; with no card it raises.

CPU example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenDraws, TokenPipeline
from repro_torch.launch.mesh import as_mesh, with_model_axis
from repro_torch.models import Model
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.fault_tolerance import WatchdogPolicy, run_with_recovery
from repro_torch.models.params import tree_map
from repro_torch.train.optimizer import AdamW, AdamWState, warmup_cosine
from repro_torch.train.train_step import (make_train_step, shard_train_step,
                                          state_layout)
from repro_torch.utils.device import DeviceLike, resolve_device, synchronize


def train(arch: str, *, smoke: bool = True, steps: int = 20, batch: int = 4,
          seq: int = 64, ckpt_dir: Optional[str] = None,
          checkpoint_every: int = 10, lr: float = 3e-4, kv_chunk: int = 64,
          mesh=None, microbatches: int = 1, log_every: int = 5,
          seed: int = 0, data_mode: str = "uniform", device: DeviceLike = None,
          draws: Optional[TokenDraws] = None,
          on_event: Optional[Callable[[str, dict], None]] = None):
    """Train ``arch`` for ``steps`` steps from the latest checkpoint under
    ``ckpt_dir`` (or from ``Model.init`` with a generator seeded by
    ``seed``).  Returns (the parameters, the losses of the steps run).

    ``mesh`` (a DeviceMesh or a device list; e.g. ``make_mesh((4, 2),
    ("data", "model"))``, or ``make_mesh(2)``, a (data, model) mesh with one
    model slot) runs :func:`shard_train_step` with the state laid out on its
    slots and the batch over its non-model axes, as the reference's
    ``train(mesh=...)``; else the state lies on ``device``.
    ``draws`` replaces the pipeline's token draws.  ``on_event(kind,
    info)`` receives the recovery loop's events (``checkpoint``,
    ``failure``, ``restored``, ``straggler``) and one ``step`` event per
    completed step: its loss, grad norm, lr, and host seconds for the batch
    (``data_s``) and for forward, backward and update (``step_s``).  A
    ``checkpoint`` or ``restored`` event also carries ``state``, the live
    tree ``{"params", "opt"}`` just saved or restored, for a caller that
    audits it.  A step whose loss is not finite leaves the parameters and
    the optimizer state as they were (the train step checks the loss
    before its in-place update), so its retry starts from the last good
    state, as the reference's driver discards such a step's new state."""
    cfg = get_config(arch, smoke=smoke)
    mesh = with_model_axis(as_mesh(mesh))
    model = Model(cfg) if mesh is None else Model(
        cfg, mesh=mesh, batch_axes=tuple(a for a in mesh.axis_names if a != "model"))
    dev = mesh.lead if mesh is not None else resolve_device(device)
    emit = on_event or (lambda kind, info: None)
    opt = AdamW(lr=warmup_cosine(lr, max(steps // 10, 1), steps))
    pipe = TokenPipeline(cfg, batch, seq, seed=seed, mode=data_mode, device=dev,
                         **({"draws": draws} if draws is not None else {}))

    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    start_step = 0
    if mesh is not None:
        layout = state_layout(mesh, model)
        state = {"params": model.param_layout().shard(params)}
        state["opt"] = opt.init_slots(state["params"])
        step_fn = shard_train_step(model, opt, mesh, kv_chunk=kv_chunk,
                                   microbatches=microbatches)
    else:
        state = {"params": params, "opt": opt.init(params)}
        step_fn = make_train_step(model, opt, kv_chunk=kv_chunk,
                                  microbatches=microbatches)
    del params

    def saved_tree():
        if mesh is not None:           # whole leaves, gathered to the host
            return layout.gather([{"params": a, "opt": b}
                                  for a, b in zip(state["params"], state["opt"])],
                                 device="cpu")
        return {"params": state["params"], "opt": state["opt"]}

    def restore() -> int:
        if not ckpt_dir:
            return start_step
        if mesh is None:
            tree, step, _ = ckpt_mod.restore_checkpoint(ckpt_dir, saved_tree(), device=dev)
            state["params"], state["opt"] = tree["params"], tree["opt"]
            return step
        like = {"params": model.abstract(),
                "opt": AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                                  m=tree_map(_meta_fp32, model.abstract()),
                                  v=tree_map(_meta_fp32, model.abstract()))}
        tree, step, _ = ckpt_mod.restore_checkpoint(ckpt_dir, like, device=layout)
        state["params"], state["opt"] = [t["params"] for t in tree], [t["opt"] for t in tree]
        return step

    if ckpt_dir and ckpt_mod.latest_step(ckpt_dir) is not None:
        start_step = restore()
        print(f"restored checkpoint at step {start_step}")

    losses = []

    def one_step(step: int) -> dict:
        t0 = time.perf_counter()
        batch_step = pipe.batch_at(step)
        synchronize(dev)
        t1 = time.perf_counter()
        p, o, metrics = step_fn(state["params"], state["opt"], batch_step)
        loss = float(metrics["loss"])
        t2 = time.perf_counter()
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss at step {step}")
        state["params"], state["opt"] = p, o
        losses.append(loss)
        gnorm = float(metrics["grad_norm"])
        if step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f}")
        emit("step", {"step": step, "loss": loss, "grad_norm": gnorm,
                      "lr": float(metrics["lr"]), "data_s": t1 - t0,
                      "step_s": t2 - t1})
        return metrics

    def save(step: int) -> None:
        if ckpt_dir:
            ckpt_mod.save_checkpoint(ckpt_dir, step, saved_tree(),
                                     extra={"pipeline": pipe.state_dict(step)})
            ckpt_mod.prune_checkpoints(ckpt_dir)

    def event(kind: str, info: dict) -> None:
        if kind in ("checkpoint", "restored"):
            info = dict(info, state=saved_tree())
        emit(kind, info)

    final = run_with_recovery(
        one_step, start_step=start_step, num_steps=steps, save_fn=save,
        restore_fn=restore, checkpoint_every=checkpoint_every,
        watchdog=WatchdogPolicy(), on_event=event)
    if ckpt_dir:
        save(final)
    return saved_tree()["params"], losses


def _meta_fp32(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=torch.float32, device="meta")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    _, losses = train(args.arch, smoke=args.smoke, steps=args.steps,
                      batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                      lr=args.lr, microbatches=args.microbatches,
                      device=args.device)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
