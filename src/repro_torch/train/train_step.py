"""The training step (the JAX package's ``repro.train.train_step`` in
PyTorch).

:func:`make_train_step` builds the (params, opt_state, batch) → (params',
opt_state', metrics) function: autograd in place of ``jax.value_and_grad``,
microbatches accumulated in fp32 as the reference's scan accumulates them,
then one :class:`AdamW` update in place.

:func:`shard_train_step` is the data-parallel step over a 1-D
:class:`~repro_torch.launch.mesh.DeviceMesh`, what the reference's GSPMD
does on its data axis: each slot takes its rows of the batch and computes
its grads on its own device (accumulating its own microbatches), the grads
gather to the lead device and average, one update runs there, and the
parameters go back to every slot.  The parameters are a list with one tree
per slot (:func:`replicate`); slots on one device share one tree.

The reference's ``NamedSharding`` constructions (``make_state_shardings``,
``make_batch_shardings``, ``batch_pspec``) need a model axis and are not
ported.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train.optimizer import AdamW, AdamWState


def _leaves(tree) -> List[torch.Tensor]:
    return list(tree_leaves(tree))


def replicate(tree, mesh: DeviceMesh) -> List[Any]:
    """One copy of ``tree`` per slot of ``mesh``: the first slot on each
    device holds a copy there (``tree`` itself where it already lies on
    that device) and later slots on the same device share it."""
    by_dev: Dict[torch.device, Any] = {}
    src = _leaves(tree)[0].device
    for dev in mesh.devices:
        if dev not in by_dev:
            by_dev[dev] = tree if dev == src else tree_map(lambda x: x.to(dev), tree)
    return [by_dev[d] for d in mesh.devices]


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
    passed in."""
    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = value_and_grad(model, params, batch, kv_chunk=kv_chunk,
                                     microbatches=microbatches)
        params, opt_state, stats = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **stats}
    return train_step


def shard_train_step(model, opt: AdamW, mesh: DeviceMesh, *,
                     kv_chunk: int = 2048, microbatches: int = 1) -> Callable:
    """The data-parallel step over ``mesh``:
    (params per slot, opt_state, batch) → (params per slot, opt_state',
    metrics).

    ``params`` is :func:`replicate`'s list; ``opt_state`` lies on the lead
    device.  Slot ``s`` takes rows ``[s·B/D, (s+1)·B/D)`` and accumulates
    its ``microbatches`` of them; the loss and the grads are the means over
    slots, which for equal slots is the reference's mean over the global
    batch.  Every slot is launched before the first gather."""
    d = mesh.size

    def train_step(params: Sequence[Any], opt_state: AdamWState, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % d:
            raise ValueError(f"batch of {rows} rows does not split over {d} slots")
        n = rows // d
        per_slot = []
        for s, dev in enumerate(mesh.devices):
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                b = {k: torch.as_tensor(v)[s * n:(s + 1) * n].to(dev)
                     for k, v in batch.items()}
                per_slot.append(value_and_grad(model, params[s], b, kv_chunk=kv_chunk,
                                               microbatches=microbatches))
        lead = mesh.lead
        loss = sum(part.to(lead) for part, _ in per_slot) / d
        grads = [sum(g[i].to(lead, torch.float32) for _, g in per_slot) / d
                 for i in range(len(per_slot[0][1]))]
        del per_slot
        lead_params, opt_state, stats = opt.update(grads, opt_state, params[0])
        with torch.no_grad():
            for tree in {id(t): t for t in params[1:]}.values():
                if tree is not lead_params:
                    for dst, src in zip(_leaves(tree), _leaves(lead_params)):
                        dst.copy_(src)
        return params, opt_state, {"loss": loss, **stats}
    return train_step

