"""The training step (the JAX package's ``repro.train.train_step`` in
PyTorch).

:func:`make_train_step` builds the (params, opt_state, batch) → (params',
opt_state', metrics) function: autograd in place of ``jax.value_and_grad``,
microbatches accumulated in fp32 as the reference's scan accumulates them,
then one :class:`AdamW` update in place.

:func:`shard_train_step` is the step over a
:class:`~repro_torch.launch.mesh.DeviceMesh`, the reference's sharding
contract on a (data, model) mesh; a 1-D ``data`` mesh is such a mesh with
one model slot.  Each slot holds its pieces of the parameters and moments
(:func:`make_state_shardings`), runs forward and backward on its data rows
and its model pieces, the grads of every piece sum over the slots that hold
it (over ``data``, and over ``model`` where a piece is replicated there),
and AdamW updates each piece once.  :func:`batch_pspec`,
:func:`make_batch_shardings` and :func:`make_state_shardings` return the
port's per-slot layouts (:class:`~repro_torch.distributed.sharding.Layout`)
where the reference returns ``NamedSharding`` trees.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import Layout, flat_specs, holders
from repro_torch.launch.mesh import DeviceMesh, with_model_axis
from repro_torch.models.params import Spec, param_pspecs, tree_leaves, tree_map
from repro_torch.train.optimizer import AdamW, AdamWState
from repro_torch.utils import roofline as RL


def _leaves(tree) -> List[torch.Tensor]:
    return list(tree_leaves(tree))


def value_and_grad(model, params, batch: Dict[str, torch.Tensor], *,
                   kv_chunk: int = 2048, microbatches: int = 1
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``(loss, grads)`` of ``model.train_loss`` at ``params``; the grads
    are a list in :func:`tree_map` leaf order.

    With ``microbatches > 1`` the batch splits along dim 0; the grads
    accumulate in fp32 and the loss as an fp32 sum, both divided by
    ``microbatches`` at the end, as the reference's scan does."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = _leaves(live)

    def one(b):
        loss = model.train_loss(live, b, kv_chunk=kv_chunk)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    if microbatches == 1:
        loss, grads = one(batch)
        return loss, list(grads)
    rows = next(iter(batch.values())).shape[0]
    if rows % microbatches:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{microbatches} microbatches")
    n = rows // microbatches
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    for i in range(microbatches):
        part, g = one({k: v[i * n:(i + 1) * n] for k, v in batch.items()})
        loss = loss + part
        for a, gg in zip(acc, g):
            a.add_(gg)
        del g
    for a in acc:
        a.div_(microbatches)
    return loss / microbatches, acc


def make_train_step(model, opt: AdamW, *, kv_chunk: int = 2048,
                    microbatches: int = 1) -> Callable:
    """(params, opt_state, batch) → (params', opt_state', metrics).

    microbatches > 1 enables gradient accumulation: the global batch is
    split along dim 0, bounding in-flight activations to one microbatch.
    The update is in place: ``params'`` and ``opt_state'`` hold the tensors
    passed in.  A step whose loss is not finite applies no update: the
    parameters and the state stay as they were (:func:`skipped`)."""
    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = value_and_grad(model, params, batch, kv_chunk=kv_chunk,
                                     microbatches=microbatches)
        if not finite(loss):
            return params, opt_state, skipped(opt, opt_state, loss)
        params, opt_state, stats = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **stats}
    return train_step


def finite(loss: torch.Tensor) -> bool:
    """Whether the step's loss is finite.  A ``meta`` loss (a dry-run's
    counted step, :mod:`repro_torch.launch.dryrun`) has no value and counts
    as finite, so the counted step takes the update."""
    return loss.device.type == "meta" or math.isfinite(float(loss))


def skipped(opt: AdamW, state: AdamWState, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The metrics of a step whose loss is not finite.  The reference's
    driver discards such a step's new state (``repro.launch.train``); the
    port's update is in place, so the step checks the loss first and
    leaves the state alone: NaN grad norm, the lr the step would have
    used."""
    return {"loss": loss, "grad_norm": torch.full((), math.nan, device=loss.device),
            "lr": opt.lr(state.step + 1)}


def batch_pspec(mesh: DeviceMesh, extra_dims: int = 1) -> Spec:
    """Batch arrays shard their leading dim over every non-model axis."""
    axes = tuple(a for a in mesh.axis_names if a != "model")
    return Spec(axes, *([None] * extra_dims))


def make_batch_shardings(mesh: DeviceMesh, batch_tree) -> Layout:
    """The batch's per-slot layout: rows over the non-model axes where they
    divide, else replicated (e.g. a global batch of 1)."""
    n_batch = int(np.prod([mesh.shape[a] for a in mesh.axis_names if a != "model"]))
    return Layout(mesh, {k: batch_pspec(mesh, x.ndim - 1)
                         if x.ndim and x.shape[0] % n_batch == 0 else Spec()
                         for k, x in batch_tree.items()})


def make_state_shardings(mesh: DeviceMesh, model) -> Tuple[Layout, Layout]:
    """Per-slot layouts of (params, opt_state) from the logical-axis rules."""
    specs = param_pspecs(model.infos(), mesh.shape)
    return Layout(mesh, specs), Layout(mesh, AdamWState(step=Spec(), m=specs, v=specs))


def state_layout(mesh: DeviceMesh, model) -> Layout:
    """The layout of per-slot ``{"params", "opt"}`` trees (a checkpoint's)."""
    p_lay, o_lay = make_state_shardings(mesh, model)
    return Layout(mesh, {"params": p_lay.specs, "opt": o_lay.specs})


def _mesh_train_step(model, opt: AdamW, kv_chunk: int, microbatches: int) -> Callable:
    mesh = model.mesh

    def train_step(params: Sequence[Any], opt_state: Sequence[AdamWState], batch):
        live = [tree_map(lambda p: p.detach().requires_grad_(), t) for t in params]
        leaves = [_leaves(t) for t in live]
        flat = [x for slot in leaves for x in slot]
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{microbatches} microbatches")
        n = rows // microbatches
        loss = torch.zeros((), dtype=torch.float32, device=mesh.lead)
        acc = [[torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in slot]
               for slot in leaves]
        for i in range(microbatches):
            mb = {k: torch.as_tensor(v)[i * n:(i + 1) * n] for k, v in batch.items()}
            part = model.train_loss(live, mb, kv_chunk=kv_chunk)
            grads = iter(torch.autograd.grad(part, flat, allow_unused=True))
            for slot in acc:
                for a in slot:
                    g = next(grads)
                    if g is not None:
                        a.add_(g)
            loss = loss + part.detach()
            del grads
        loss = loss / microbatches
        if not finite(loss):
            return params, opt_state, skipped(opt, opt_state[0], loss)
        # each piece's grad: the sum over the slots that hold it, in slot order
        # (an all-reduce over each piece's holders, under a cost counter)
        pieces = [holders(mesh, sp) for sp in flat_specs(params[0], model.param_specs())]
        for i, groups in enumerate(pieces):
            for group in groups:
                dev0 = acc[group[0]][i].device
                total = acc[group[0]][i]
                if len(group) > 1:
                    with RL.collective("all-reduce") as moved:
                        for s in group[1:]:
                            total = total + acc[s][i].to(dev0)
                        moved.extend([total] * len(group))
                total = total / microbatches
                for s in group:
                    acc[s][i] = total.to(acc[s][i].device)
        del live, leaves, flat
        params, opt_state, stats = opt.update_slots(acc, list(opt_state), list(params), pieces)
        return params, opt_state, {"loss": loss, **stats}
    return train_step


def shard_train_step(model, opt: AdamW, mesh: DeviceMesh, *,
                     kv_chunk: int = 2048, microbatches: int = 1) -> Callable:
    """The step over ``mesh``: (params per slot, opt_state per slot, batch)
    → (params', opt_state', metrics), every tree in the slot's layout
    (:func:`make_state_shardings`; the state from :meth:`AdamW.init_slots`).

    A mesh without a ``model`` axis (``make_mesh(n)``) is a (data, model)
    mesh with one model slot, and a model without a mesh is run on
    ``mesh``: one path serves data-parallel and sharded training.  The
    loss is the mean over the data shards' means; each slot's grads come
    from one backward through every slot, and a piece's grad is the sum
    over the slots that hold it.  Each microbatch splits over the data
    shards, so for equal shards the loss and grads are the reference's
    means over the global batch."""
    mesh = with_model_axis(mesh)
    if getattr(model, "mesh", None) is None:
        from repro_torch.models.model import Model
        model = Model(model.cfg, mesh=mesh,
                      batch_axes=tuple(a for a in mesh.axis_names if a != "model"))
    elif model.mesh.slots != mesh.slots or model.mesh.shape != mesh.shape:
        raise ValueError("shard_train_step: the model lies on another mesh")
    return _mesh_train_step(model, opt, kv_chunk, microbatches)
