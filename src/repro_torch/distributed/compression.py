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
even and the scale divides in IEEE fp32, as in the reference.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models.params import tree_leaves, tree_map


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


def ef_allreduce_tree(grads: Sequence[Any], errors: Sequence[Any], mesh: DeviceMesh
                      ) -> Tuple[Any, List[Any]]:
    """Tree version: ``grads[s]`` and ``errors[s]`` are slot ``s``'s trees.
    Returns (the reduced tree on the lead device, each slot's new error
    tree)."""
    flat_g = [list(tree_leaves(g)) for g in grads]
    flat_e = [list(tree_leaves(e)) for e in errors]
    out_g, out_e = [], [[] for _ in grads]
    for i in range(len(flat_g[0])):
        rg, ne = ef_allreduce_leaf([g[i] for g in flat_g], [e[i] for e in flat_e], mesh)
        out_g.append(rg)
        for s, x in enumerate(ne):
            out_e[s].append(x)
    it = iter(out_g)
    reduced = tree_map(lambda _: next(it), grads[0])
    new_errors = []
    for s in range(len(grads)):
        it_s = iter(out_e[s])
        new_errors.append(tree_map(lambda _: next(it_s), grads[s]))
    return reduced, new_errors


def init_error_tree(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compression_ratio(tree: Any) -> float:
    """Wire-bytes ratio of int8+scale vs fp32 for a gradient tree."""
    leaves = list(tree_leaves(tree))
    total_f32 = sum(x.numel() * 4 for x in leaves)
    total_q = sum(x.numel() * 1 + 4 for x in leaves)
    return total_q / total_f32
