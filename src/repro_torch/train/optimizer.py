"""AdamW + schedules (the JAX package's ``repro.train.optimizer`` in
PyTorch).

The state mirrors the parameter tree: one fp32 moment per parameter
tensor, in the port's layout (a list per unstacked ``layers`` dim).  The
update follows the reference's order of operations: fp32 grads, a
global-norm clip, m and v, the bias corrections as fp32 powers, ``delta``,
decoupled weight decay, a cast back to the parameter's dtype.  It runs in
place under ``torch.no_grad()`` (the port's counterpart of the reference's
buffer donation): the returned parameters and state are the tensors that
were passed in, updated.

Weight decay applies where the reference applies it, to leaves of rank
>= 2 in the reference's *stacked* layout.  A leaf's stacked rank is its
``ndim`` plus the list levels above it, since each list is one unstacked
``layers`` dim (:mod:`repro_torch.models.params`): a per-layer ``ln1`` of
shape [d] is ``[L, d]`` stacked and is decayed, ``embed/final_norm`` is
not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor         # scalar int32
    m: Any                     # fp32 tree
    v: Any                     # fp32 tree


def leaves_with_rank(tree, depth: int = 0) -> Iterator[Tuple[torch.Tensor, int]]:
    """``(leaf, rank in the reference's stacked layout)`` of a parameter
    tree, depth first (dict order, then list order)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves_with_rank(v, depth)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves_with_rank(v, depth + 1)
    else:
        yield tree, tree.ndim + depth


def _zeros_like(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def _leaves(tree):
    return list(tree_leaves(tree))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        dev = _leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=_zeros_like(params), v=_zeros_like(params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        """One step, in place.  ``grads`` has the parameters' structure, or
        is a flat list in leaf order, in any float dtype; returns
        ``(params, state, {"grad_norm", "lr"})``."""
        step = state.step + 1
        gs = _leaves(grads)
        ps = list(leaves_with_rank(params))
        ms, vs = _leaves(state.m), _leaves(state.v)
        if not len(gs) == len(ps) == len(ms) == len(vs):
            raise ValueError("grads, params and moments differ in structure")

        # global-norm clip (the per-layer pieces sum in the port's order)
        gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
        for g in gs:
            g32 = g.float()
            gnorm = gnorm + torch.sum(g32 * g32).to(gnorm.device)
        gnorm = torch.sqrt(gnorm)
        scale = torch.clamp_max(self.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
        bc1 = 1 - self.b1 ** step.float()
        bc2 = 1 - self.b2 ** step.float()
        lr = self.lr(step)

        # one leaf at a time: the temporaries are one leaf's
        for g, (p, rank), m, v in zip(gs, ps, ms, vs):
            self._leaf(g, p, rank, m, v, scale, bc1, bc2, lr)
        return params, AdamWState(step=step, m=state.m, v=state.v), {
            "grad_norm": gnorm, "lr": lr}

    def _leaf(self, g, p, rank, m, v, scale, bc1, bc2, lr) -> None:
        dev = p.device
        g32 = g.float() * scale.to(dev)
        m.mul_(self.b1).add_((1 - self.b1) * g32)
        v.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
        mhat = m / bc1.to(dev)
        vhat = v / bc2.to(dev)
        delta = mhat / (torch.sqrt(vhat) + self.eps)
        if rank >= 2:                        # decoupled WD on matrices
            delta = delta + self.weight_decay * p.float()
        p.copy_(p.float() - lr.to(dev) * delta)

    def init_slots(self, params: List[Any]) -> List[AdamWState]:
        """The state of per-slot parameter trees (a mesh's layout): each
        slot's moments in its parameters' layout, shared where the slots
        share a parameter tensor."""
        zeros: Dict[Tuple[str, int], torch.Tensor] = {}
        steps: Dict[torch.device, torch.Tensor] = {}

        def z(p, kind):
            if (kind, id(p)) not in zeros:
                zeros[kind, id(p)] = torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device)
            return zeros[kind, id(p)]

        out = []
        for tree in params:
            dev = _leaves(tree)[0].device
            if dev not in steps:
                steps[dev] = torch.zeros((), dtype=torch.int32, device=dev)
            out.append(AdamWState(step=steps[dev], m=tree_map(lambda p: z(p, "m"), tree),
                                  v=tree_map(lambda p: z(p, "v"), tree)))
        return out

    @torch.no_grad()
    def update_slots(self, grads: List[List[torch.Tensor]], states: List[AdamWState],
                     params: List[Any], pieces: List[List[List[int]]]
                     ) -> Tuple[List[Any], List[AdamWState], Dict[str, torch.Tensor]]:
        """One step over per-slot trees, in place.

        ``grads[s]`` is slot ``s``'s list of reduced grads in leaf order,
        ``pieces[i]`` the groups of slots that hold one piece of leaf ``i``
        (``repro_torch.distributed.sharding.holders``).  The global grad
        norm counts every element once — one holder per piece — and each
        parameter tensor is updated once, however many slots share it."""
        lead = _leaves(params[0])[0].device
        step = states[0].step.to(lead) + 1
        gnorm = torch.zeros((), dtype=torch.float32, device=lead)
        for i, groups in enumerate(pieces):
            for group in groups:
                g32 = grads[group[0]][i].float()
                gnorm = gnorm + torch.sum(g32 * g32).to(lead)
        gnorm = torch.sqrt(gnorm)
        scale = torch.clamp_max(self.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
        bc1 = 1 - self.b1 ** step.float()
        bc2 = 1 - self.b2 ** step.float()
        lr = self.lr(step)
        done = set()
        for s, tree in enumerate(params):
            for g, (p, rank), m, v in zip(grads[s], leaves_with_rank(tree),
                                          _leaves(states[s].m), _leaves(states[s].v)):
                if id(p) not in done:
                    done.add(id(p))
                    self._leaf(g, p, rank, m, v, scale, bc1, bc2, lr)
        steps = {}
        new = []
        for st in states:
            dev = st.step.device
            if dev not in steps:
                steps[dev] = step.to(dev)
            new.append(AdamWState(step=steps[dev], m=st.m, v=st.v))
        return params, new, {"grad_norm": gnorm, "lr": lr}


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    def schedule(step):
        s = torch.as_tensor(step).float()
        warm = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        # the cosine in float64, rounded once: the correctly rounded value,
        # which XLA's float32 cosine gives and torch's misses by an ulp at
        # some steps
        c = torch.cos((math.pi * t).double()).float()
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + c)
        return torch.where(s < warmup, warm, cos)
    return schedule


def constant_lr(value: float) -> Callable:
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)
