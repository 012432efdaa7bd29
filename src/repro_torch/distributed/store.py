"""PartitionStore layouts — the counterpart of ``repro.distributed.store``.

  * :func:`pad_store` — append inert partitions up to a multiple;
  * :func:`shard_store` — one store laid out over a
    :class:`~repro_torch.launch.DeviceMesh`: slot d gets the partitions
    ``[d·per, (d+1)·per)``, ``per = ceil(P / D)`` (the sharded refine);
  * :func:`stack_stores` — whole shard stores on a NEW leading shard axis
    (``[S, P, cap, n]``, ragged P/cap padded with inert slots, local record
    ids remapped to fleet-global ids): the JAX package's fleet layout for
    ``shard_map``.  The port's fleet placement refines each shard's own
    store on its slot's device instead, so nothing on its path stacks;
  * :func:`concat_stores` — one union store along the partition axis, the
    fleet's exact full scan (``IndexFleet.scan_exact``);
  * :func:`store_to_arrays` / ``store_from_arrays`` (the latter lives in
    ``repro_torch.core.index``) — the bit-exact host-array wire format of
    the fleet's shard snapshots.

Pad slots carry ``rec_gid = rec_dfs = -1``: never a live record, never
inside a node interval, so a padded store answers as the unpadded one.

Every layout here is of dense stores.  A ragged store
(``core.index.RaggedStore``) lays out over a one-slot mesh only; the rest
raise a ``ValueError`` that names its layout.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.index import (PartitionStore, RaggedStore, Store, require_dense,
                                    store_from_arrays)  # noqa: F401
from repro_torch.launch.mesh import as_mesh

_FILL = {"data": 0, "norms": 0, "rec_dfs": -1, "rec_gid": -1, "count": 0}


def pad_store(store: PartitionStore, multiple: int) -> PartitionStore:
    """Append empty partitions so ``P % multiple == 0`` (no-op when it is)."""
    require_dense(store, "pad_store")
    pad = (-store.num_partitions) % multiple
    if pad == 0:
        return store
    return PartitionStore(*[
        torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), _FILL[name],
                                 dtype=x.dtype, device=x.device)])
        for name, x in zip(PartitionStore._fields, store)])


# ``store_pspecs`` (the JAX package's PartitionSpec per store field) has no
# counterpart: a slot's partitions are a tensor on its device, not a
# NamedSharding of one array, and :func:`shard_store` is that layout.


def slot_range(num_partitions: int, num_slots: int, d: int):
    """Slot ``d``'s global partition range ``[lo, hi)``: ``[d·per,
    (d+1)·per)`` cut at P, ``per = ceil(P / D)`` (the reference's
    ``pad_store`` split)."""
    per = -(-num_partitions // num_slots)
    lo = min(d * per, num_partitions)
    return lo, min(lo + per, num_partitions)


def _inert_store(like: PartitionStore, device) -> PartitionStore:
    """One empty partition of one slot: plans never select it."""
    n = like.data.shape[-1]
    full = lambda shape, v, dt: torch.full(shape, v, dtype=dt, device=device)
    return PartitionStore(full((1, 1, n), 0, like.data.dtype),
                          full((1, 1), 0, like.norms.dtype),
                          full((1, 1), -1, like.rec_dfs.dtype),
                          full((1, 1), -1, like.rec_gid.dtype),
                          full((1,), 0, like.count.dtype))


def to_device(store: Store, device) -> Store:
    """The store on ``device``: itself when it is there, else a copy."""
    if store.data.device == torch.device(device):
        return store
    return type(store)(*(x.to(device) if isinstance(x, torch.Tensor) else x
                         for x in store))


def shard_store(store: Store, mesh) -> List[Store]:
    """Lay ``store`` out over ``mesh``: one store per slot, on its device.
    A ragged store takes a mesh of one slot only.

    Slot d holds the partitions ``[d·per, (d+1)·per)`` of
    :func:`slot_range`.  A slot on the store's own device gets views of its
    rows, not copies; another device gets one copy of them.  The last
    slot's pad partitions are not materialised (no plan selects them), and
    a slot with no real partition gets a one-slot inert store.
    """
    mesh = as_mesh(mesh)
    if mesh.size == 1 and isinstance(store, RaggedStore):
        return [to_device(store, mesh.slots[0])]
    require_dense(store, "shard_store over several slots")
    out = []
    for d, dev in enumerate(mesh.slots):
        lo, hi = slot_range(store.num_partitions, mesh.size, d)
        if hi == lo:
            out.append(_inert_store(store, dev))
        else:
            out.append(to_device(PartitionStore(*(x[lo:hi] for x in store)),
                                 dev))
    return out


def _remap(gid: torch.Tensor, gid_map) -> torch.Tensor:
    """Local record ids → global ids through ``gid_map`` (``-1`` stays)."""
    if gid_map is None:
        return gid
    gmap = torch.as_tensor(np.asarray(gid_map, dtype=np.int32),
                           device=gid.device)
    return torch.where(gid >= 0, gmap[torch.clamp(gid, min=0).long()], -1)


def _assemble(stores: Sequence[PartitionStore], gid_maps, lead: tuple,
              slot) -> PartitionStore:
    """Allocate every field as ``lead + (cap, ...)`` filled with its pad
    value (``count`` as ``lead``) and copy store ``i`` into ``slot(i)``:
    one copy of the stores, with no padded intermediates."""
    for st in stores:
        require_dense(st, "a stacked or concatenated store")
    cap = max(s.capacity for s in stores)
    out = PartitionStore(*[
        torch.full(lead + ((cap,) + tuple(x.shape[2:]) if x.dim() > 1 else ()),
                   _FILL[name], dtype=x.dtype, device=x.device)
        for name, x in zip(PartitionStore._fields, stores[0])])
    for i, st in enumerate(stores):
        at = slot(i)
        rows = at + (slice(0, st.capacity),)
        gid_map = None if gid_maps is None else gid_maps[i]
        out.data[rows] = st.data
        out.norms[rows] = st.norms
        out.rec_dfs[rows] = st.rec_dfs
        out.rec_gid[rows] = _remap(st.rec_gid, gid_map)
        out.count[at] = st.count
    return out


def stack_stores(stores: Sequence[PartitionStore],
                 gid_maps: Optional[Sequence] = None) -> PartitionStore:
    """Stack shard stores on a NEW leading shard axis (``S`` first).

    Every field becomes ``[S, ...]`` (``data [S, P, cap, n]``, ``count
    [S, P]``), ragged partition counts and capacities padded to the
    maxima with inert slots.  ``gid_maps`` maps each store's local record
    ids to fleet-global ids (identity when omitted).  The result is a
    second copy of the stores.
    """
    stores = list(stores)
    if not stores:
        raise ValueError("stack_stores needs at least one store")
    pmax = max(s.num_partitions for s in stores)
    return _assemble(stores, gid_maps, (len(stores), pmax),
                     lambda i: (i, slice(0, stores[i].num_partitions)))


def concat_stores(stores: Sequence[PartitionStore],
                  gid_maps: Optional[Sequence] = None) -> PartitionStore:
    """Fuse several shard stores into one union store along the P axis
    (capacities padded to the maximum with inert slots; ``gid_maps`` as in
    :func:`stack_stores`).  The result is a copy of the stores."""
    stores = list(stores)
    if not stores:
        raise ValueError("concat_stores needs at least one store")
    starts = np.cumsum([0] + [s.num_partitions for s in stores])
    return _assemble(stores, gid_maps, (int(starts[-1]),),
                     lambda i: (slice(int(starts[i]), int(starts[i + 1])),))


def store_to_arrays(store: PartitionStore, prefix: str = "store_"):
    """Host-array dict of every store field (the snapshot wire format),
    keyed ``f"{prefix}{field}"``; inverse of ``store_from_arrays``."""
    require_dense(store, "store_to_arrays (the snapshot format)")
    return {prefix + name: getattr(store, name).cpu().numpy()
            for name in PartitionStore._fields}
