"""Gradient compression: int8 error-feedback all-reduce (the JAX package's
``repro.distributed.compression`` in PyTorch).

Gradients are quantised to int8 with a per-tensor scale before the
reduction, and the quantisation error is kept as local feedback state
(added back before the next step's quantisation) — the classic EF-SGD
scheme, which preserves convergence where plain one-shot quantisation
doesn't.

The reference's ``psum`` over a manual ``shard_map`` axis becomes a sum
over the slots of a :class:`~repro_torch.launch.mesh.DeviceMesh`: each
slot's tensor is quantised on its own device, the dequantised payloads
gather to the lead device and sum there in slot order.  Rounding is half to
even and the scale divides in IEEE fp32, as in the reference.  A stacked
leaf of the reference's is a list of per-layer tensors in the port's
parameter trees: given the info tree the parameters were made from
(``Model.infos()``), the entries of each such list share one scale
(:func:`~repro_torch.models.params.stacked_leaves`).  Without it, every
tensor is a leaf of its own, as ``jax.tree_util`` takes a tree.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models.params import stacked_leaves, tree_leaves, tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation.  Returns (q, scale)."""
    x32 = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(x32)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_allreduce_leaf(grads: Sequence[torch.Tensor], errors: Sequence[torch.Tensor],
                      mesh: DeviceMesh) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Error-feedback compressed mean over the slots of ``mesh`` for one
    tensor: ``grads[s]`` and ``errors[s]`` are slot ``s``'s.

    Returns (the reduced fp32 mean on the lead device, each slot's new
    error)."""
    if not len(grads) == len(errors) == mesh.size:
        raise ValueError(f"{len(grads)} grads and {len(errors)} errors for "
                         f"{mesh.size} slots")
    deqs, new_errors = [], []
    for g, e in zip(grads, errors):
        g32 = g.float() + e
        q, scale = quantize_int8(g32)
        deq = dequantize_int8(q, scale)
        new_errors.append(g32 - deq)           # local feedback memory
        deqs.append(deq)
    # the sum of the dequantised payloads models int8 wire traffic + an
    # fp32 combine
    total = deqs[0].to(mesh.lead)
    for deq in deqs[1:]:
        total = total + deq.to(mesh.lead)
    return total / float(mesh.size), new_errors


def _groups(tree, infos=None) -> List[List[torch.Tensor]]:
    """The leaves of ``tree`` grouped under their int8 scales: by the
    stacked leaves of ``infos`` where given, else one tensor a group."""
    if infos is not None:
        return stacked_leaves(tree, infos)
    return [[x] for x in tree_leaves(tree)]


def _ef_group(grads: Sequence[List[torch.Tensor]], errors: Sequence[List[torch.Tensor]],
              mesh: DeviceMesh) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]]]:
    """:func:`ef_allreduce_leaf` for one stacked leaf held as ``grads[s]``,
    slot ``s``'s list of its entries: one int8 scale over every entry."""
    deqs, new_errors = [], []
    for g, e in zip(grads, errors):
        g32 = [x.float() + err for x, err in zip(g, e)]
        amax = torch.stack([torch.max(torch.abs(x)) for x in g32]).max()
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        deq = [dequantize_int8(torch.clamp(torch.round(x / scale), -127, 127)
                               .to(torch.int8), scale) for x in g32]
        new_errors.append([x - d for x, d in zip(g32, deq)])
        deqs.append(deq)
    reduced = []
    for i in range(len(deqs[0])):
        total = deqs[0][i].to(mesh.lead)
        for deq in deqs[1:]:
            total = total + deq[i].to(mesh.lead)
        reduced.append(total / float(mesh.size))
    return reduced, new_errors


def ef_allreduce_tree(grads: Sequence[Any], errors: Sequence[Any], mesh: DeviceMesh,
                      infos: Any = None) -> Tuple[Any, List[Any]]:
    """Tree version: ``grads[s]`` and ``errors[s]`` are slot ``s``'s trees,
    in the port's layout.  With ``infos``, the stacked info tree the
    parameters were made from, each stacked leaf is quantised under one
    scale, as the reference quantises its ``[L, ...]`` leaf; without it,
    each tensor under its own.  Returns (the reduced tree on the lead
    device, each slot's new error tree), both in the port's layout."""
    if not len(grads) == len(errors) == mesh.size:
        raise ValueError(f"{len(grads)} grads and {len(errors)} errors for "
                         f"{mesh.size} slots")
    groups_g = [_groups(g, infos) for g in grads]
    groups_e = [_groups(e, infos) for e in errors]
    out_g, out_e = [], [[] for _ in grads]
    for k in range(len(groups_g[0])):
        rg, ne = _ef_group([g[k] for g in groups_g], [e[k] for e in groups_e], mesh)
        out_g.append(rg)
        for s, x in enumerate(ne):
            out_e[s].append(x)

    def rebuild(groups, like):
        order = {id(x): (k, i) for k, g in enumerate(_groups(like, infos))
                 for i, x in enumerate(g)}
        return tree_map(lambda x: groups[order[id(x)][0]][order[id(x)][1]], like)

    return rebuild(out_g, grads[0]), [rebuild(out_e[s], grads[s])
                                      for s in range(len(grads))]


def init_error_tree(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compression_ratio(tree: Any, infos: Any = None) -> float:
    """Wire-bytes ratio of int8+scale vs fp32 for a gradient tree: one
    4-byte scale per stacked leaf of ``infos`` where given, else per
    tensor (as :func:`ef_allreduce_tree` groups them)."""
    groups = _groups(tree, infos)
    total_f32 = sum(x.numel() * 4 for g in groups for x in g)
    total_q = sum(sum(x.numel() for x in g) + 4 for g in groups)
    return total_q / total_f32
