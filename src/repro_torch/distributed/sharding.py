"""Activation / cache sharding rules and the one-process collectives of a
(data, model) mesh (the JAX package's ``repro.distributed.sharding``).

Weights follow :func:`repro_torch.models.params.param_pspecs`.  Caches
follow the reference's per-family rules, unchanged:

  * KV caches shard the **kv-heads dim over `model`** when divisible —
    zero-collective decode attention;
  * otherwise they shard the **sequence dim over `model`** (flash-decoding
    style, :func:`repro_torch.models.layers.set_decode_shard`);
  * an MLA latent shards its sequence dim; SSM states shard heads over
    `model`, conv tails their channels;
  * batch shards over every non-model axis (pod × data), dropped where it
    does not divide.

The reference lays a tensor out on devices and lets ``shard_map`` / GSPMD
move it.  The port drives every slot from one process: a sharded tensor is
a list with one local piece per slot (:func:`shard`, :func:`gather`), and
the collectives over one mesh axis (:func:`psum`, :func:`pmax`,
:func:`all_gather`, :func:`psum_scatter`) combine the pieces of the slots
that differ on that axis alone, always in slot order, so every run sums in
the same order.  No ``torch.distributed``: slots of one device that hold
the same piece share one tensor.  Under a
:class:`~repro_torch.utils.roofline.CostCounter` each collective adds its
per-slot result bytes under the reference's HLO kind (``psum`` / ``pmax``:
all-reduce, ``all_gather``: all-gather, ``psum_scatter``: reduce-scatter),
its backward the transpose's, and its own adds and copies count no op
bytes; a group of one slot moves nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models.params import Spec, tree_leaves, tree_map
from repro_torch.utils import roofline as RL
from repro_torch.utils.config import ModelConfig


def _axes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def _div(n: int, mesh, axis="model") -> bool:
    return n % _axes(mesh)[axis] == 0


def cache_pspecs(cfg: ModelConfig, mesh, batch: int, max_len: int,
                 enc_len: int = 0, img_len: int = 0) -> Dict[str, Any]:
    """A :class:`Spec` per entry of ``repro_torch.models.decoding.cache_shapes``.

    ``mesh`` needs only ``axis_names`` and ``devices.shape``."""
    # imported here: the models package imports this module
    from repro_torch.models import ssm as SSM_mod

    ba = batch_axes(mesh)
    sizes = _axes(mesh)
    n_batch = int(np.prod([sizes[a] for a in ba]))
    if batch % n_batch != 0:
        ba = None                     # e.g. global_batch=1 long-context decode
    kv_ok = _div(cfg.num_kv_heads, mesh) and not cfg.use_mla
    seq_ok = _div(max_len, mesh)

    def kv_spec(lead: int, seq_dim_len: int):
        """[*lead, B, S, KV, hd] — prefer heads sharding, else seq."""
        lead_spec = (None,) * lead
        if kv_ok:
            return Spec(*lead_spec, ba, None, "model", None)
        if seq_dim_len % sizes["model"] == 0:
            return Spec(*lead_spec, ba, "model", None, None)
        return Spec(*lead_spec, ba, None, None, None)

    if cfg.family in ("dense", "moe") and not cfg.use_mla:
        return {"k": kv_spec(1, max_len), "v": kv_spec(1, max_len), "len": Spec()}
    if cfg.use_mla:
        s = Spec(None, ba, "model", None) if seq_ok else Spec(None, ba, None, None)
        return {"ckv": s, "len": Spec()}
    if cfg.family == "ssm":
        d_in, h, n = SSM_mod.ssm_dims(cfg)
        hspec = "model" if _div(h, mesh) else None
        cspec = "model" if _div(d_in + 2 * n, mesh) else None
        return {"h": Spec(None, ba, hspec, None, None),
                "conv": Spec(None, ba, None, cspec), "len": Spec()}
    if cfg.family == "hybrid":
        d_in, h, n = SSM_mod.ssm_dims(cfg)
        hspec = "model" if _div(h, mesh) else None
        cspec = "model" if _div(d_in + 2 * n, mesh) else None
        return {"h": Spec(None, None, ba, hspec, None, None),
                "conv": Spec(None, None, ba, None, cspec),
                "k": kv_spec(1, max_len), "v": kv_spec(1, max_len),
                "len": Spec()}
    if cfg.family == "encdec":
        return {"k": kv_spec(1, max_len), "v": kv_spec(1, max_len),
                "xk": kv_spec(1, enc_len), "xv": kv_spec(1, enc_len),
                "len": Spec()}
    if cfg.family == "vlm":
        return {"k": kv_spec(2, max_len), "v": kv_spec(2, max_len),
                "xk": kv_spec(1, img_len), "xv": kv_spec(1, img_len),
                "len": Spec()}
    raise ValueError(cfg.family)


def cache_shardings(cfg: ModelConfig, mesh: DeviceMesh, batch: int, max_len: int,
                    enc_len: int = 0, img_len: int = 0) -> "Layout":
    """The cache's per-slot :class:`Layout` (the reference's NamedShardings)."""
    return Layout(mesh, cache_pspecs(cfg, mesh, batch, max_len, enc_len, img_len))


# ----------------------------------------------------------------------
# pieces: one local tensor per slot
# ----------------------------------------------------------------------
def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def piece_coords(mesh: DeviceMesh, slot: int, spec) -> Tuple[Tuple[int, int], ...]:
    """(index, count) of slot ``slot``'s piece along each dim of ``spec``:
    a dim split over several axes counts them with the first major."""
    c = mesh.coords(slot)
    out = []
    for e in spec:
        idx, n = 0, 1
        for a in _entry_axes(e):
            idx, n = idx * mesh.shape[a] + int(c[a]), n * mesh.shape[a]
        out.append((idx, n))
    return tuple(out)


def holders(mesh: DeviceMesh, spec) -> List[List[int]]:
    """The slots that hold each distinct piece of a ``spec`` tensor, in slot
    order (a piece replicated over an axis has one holder per coordinate)."""
    by_piece: Dict[Tuple, List[int]] = {}
    for s in range(mesh.size):
        by_piece.setdefault(piece_coords(mesh, s, spec), []).append(s)
    return list(by_piece.values())


def _narrow(t: torch.Tensor, coords) -> torch.Tensor:
    for dim, (idx, n) in enumerate(coords):
        if n > 1:
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                                 f"into {n} pieces")
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t


def shard(t: torch.Tensor, mesh: DeviceMesh, spec) -> List[torch.Tensor]:
    """``t`` laid out by ``spec``: slot ``s``'s piece on its device, a copy
    of ``t``'s values.  Slots of one device that hold the same piece share
    one tensor."""
    spec = tuple(spec) + (None,) * (t.ndim - len(spec))
    memo: Dict[Tuple, torch.Tensor] = {}
    out = []
    for s, dev in enumerate(mesh.slots):
        key = (dev, piece_coords(mesh, s, spec))
        if key not in memo:
            p = _narrow(t, key[1])
            memo[key] = torch.empty(p.shape, dtype=p.dtype, device=dev).copy_(p)
        out.append(memo[key])
    return out


def gather(pieces: Sequence[torch.Tensor], mesh: DeviceMesh, spec,
           device=None) -> torch.Tensor:
    """The whole tensor of ``pieces`` laid out by ``spec``, on ``device``
    (the lead device by default)."""
    first = pieces[0]
    spec = tuple(spec) + (None,) * (first.ndim - len(spec))
    counts = [n for _, n in piece_coords(mesh, 0, spec)]
    out = torch.empty([d * n for d, n in zip(first.shape, counts)], dtype=first.dtype,
                      device=mesh.lead if device is None else device)
    for group in holders(mesh, spec):
        coords = piece_coords(mesh, group[0], spec)
        _narrow(out, coords).copy_(pieces[group[0]])
    return out


# ----------------------------------------------------------------------
# collectives over one mesh axis, in slot order
# ----------------------------------------------------------------------
def _reduce(xs: Sequence[torch.Tensor], mesh: DeviceMesh, axis: str, combine,
            moved: List[torch.Tensor], grad_kind: str = "all-reduce"):
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for s, group in enumerate(mesh.groups(axis)):
        if out[s] is not None:
            continue
        dev0 = mesh.slots[group[0]]
        ins = [RL.grad_counted(xs[g], grad_kind) for g in group] \
            if len(group) > 1 else [xs[group[0]]]
        total = ins[0]
        for x in ins[1:]:
            total = combine(total, x.to(dev0))
        for g in group:
            out[g] = total.to(mesh.slots[g])
            if len(group) > 1:
                moved.append(out[g])
    return out


def psum(xs: Sequence[torch.Tensor], mesh: DeviceMesh, axis: str) -> List[torch.Tensor]:
    """Each slot gets the sum of the pieces of its group over ``axis``,
    added in the group's order on its first slot's device."""
    with RL.collective("all-reduce") as moved:
        return _reduce(xs, mesh, axis, torch.add, moved)


def pmax(xs: Sequence[torch.Tensor], mesh: DeviceMesh, axis: str) -> List[torch.Tensor]:
    """Each slot gets the elementwise max over its group on ``axis``."""
    with RL.collective("all-reduce") as moved:
        return _reduce(xs, mesh, axis, torch.maximum, moved)


def all_gather(xs: Sequence[torch.Tensor], mesh: DeviceMesh, axis: str,
               dim: int) -> List[torch.Tensor]:
    """Each slot gets its group's pieces on ``axis`` joined along ``dim``."""
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    with RL.collective("all-gather") as moved:
        for s, group in enumerate(mesh.groups(axis)):
            if out[s] is None:
                if len(group) == 1:
                    out[s] = xs[s].to(mesh.slots[s])
                    continue
                dev0 = mesh.slots[group[0]]
                whole = torch.cat([RL.grad_counted(xs[g], "reduce-scatter").to(dev0)
                                   for g in group], dim=dim)
                for g in group:
                    out[g] = whole.to(mesh.slots[g])
                    moved.append(out[g])
    return out


def psum_scatter(xs: Sequence[torch.Tensor], mesh: DeviceMesh, axis: str,
                 dim: int) -> List[torch.Tensor]:
    """:func:`psum`, then each slot keeps its coordinate's equal part of
    ``dim`` (a reduce-scatter)."""
    with RL.collective("reduce-scatter") as moved:
        total = _reduce(xs, mesh, axis, torch.add, [], grad_kind="all-gather")
        out = []
        for s, group in enumerate(mesh.groups(axis)):
            n, i = len(group), group.index(s)
            size = total[s].shape[dim] // n
            out.append(total[s].narrow(dim, i * size, size) if n > 1 else total[s])
            if n > 1:
                moved.append(out[-1])
    return out


# ----------------------------------------------------------------------
# trees: a spec tree (stacked, as param_pspecs gives it) over the port's
# layout, where each list is one unstacked leading dim
# ----------------------------------------------------------------------
def flat_specs(tree, specs, depth: int = 0) -> Iterator[Spec]:
    """One :class:`Spec` per leaf of ``tree``, in ``tree_leaves`` order.

    ``specs`` mirrors ``tree`` in the reference's stacked layout: a list in
    ``tree`` takes the same spec node for every entry and drops its
    leading entry.  ``specs=None`` is replicated."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_specs(v, None if specs is None else specs[k], depth)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from flat_specs(getattr(tree, f),
                                  None if specs is None else getattr(specs, f), depth)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from flat_specs(v, specs, depth + 1)
    else:
        yield Spec(*((None,) * torch.as_tensor(tree).ndim if specs is None
                     else tuple(specs)[depth:]))


class Layout:
    """A tree's layout on a mesh: ``specs`` is a spec tree in the
    reference's stacked form (the port's counterpart of a tree of
    ``NamedSharding``).  :meth:`shard` turns a whole tree into one tree of
    local pieces per slot; :meth:`gather` turns those back into the whole
    tree."""

    def __init__(self, mesh: DeviceMesh, specs=None):
        self.mesh, self.specs = mesh, specs

    def leaf_specs(self, tree) -> List[Spec]:
        return list(flat_specs(tree, self.specs))

    def shard(self, tree) -> List[Any]:
        leaves = list(tree_leaves(tree))
        pieces = [shard(torch.as_tensor(x), self.mesh, sp)
                  for x, sp in zip(leaves, self.leaf_specs(tree))]
        out = []
        for s in range(self.mesh.size):
            it = iter([p[s] for p in pieces])
            out.append(tree_map(lambda _: next(it), tree))
        return out

    def gather(self, slot_trees: Sequence[Any], device=None) -> Any:
        flats = [list(tree_leaves(t)) for t in slot_trees]
        whole = [gather([f[i] for f in flats], self.mesh, sp, device)
                 for i, sp in enumerate(self.leaf_specs(slot_trees[0]))]
        it = iter(whole)
        return tree_map(lambda _: next(it), slot_trees[0])
