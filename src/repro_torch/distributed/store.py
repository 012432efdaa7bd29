"""PartitionStore layouts for the fleet — the counterpart of
``repro.distributed.store`` for one card.

  * :func:`pad_store` — append inert partitions up to a multiple;
  * :func:`stack_stores` — whole shard stores on a NEW leading shard axis
    (``[S, P, cap, n]``, ragged P/cap padded with inert slots, local record
    ids remapped to fleet-global ids): the JAX package's layout for
    ``shard_map`` over a device mesh, kept for the multi-GPU placement —
    on one card the fleet's stacked pass refines each shard's own store;
  * :func:`concat_stores` — one union store along the partition axis, the
    fleet's exact full scan (``IndexFleet.scan_exact``);
  * :func:`store_to_arrays` / ``store_from_arrays`` (the latter lives in
    ``repro_torch.core.index``) — the bit-exact host-array wire format of
    the fleet's shard snapshots.

Pad slots carry ``rec_gid = rec_dfs = -1``: never a live record, never
inside a node interval, so a padded store answers as the unpadded one.
``store_pspecs`` and ``shard_store`` (the JAX package's multi-device
layout) wait for the multi-GPU slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.index import PartitionStore, store_from_arrays  # noqa: F401

_FILL = {"data": 0, "norms": 0, "rec_dfs": -1, "rec_gid": -1, "count": 0}


def pad_store(store: PartitionStore, multiple: int) -> PartitionStore:
    """Append empty partitions so ``P % multiple == 0`` (no-op when it is)."""
    pad = (-store.num_partitions) % multiple
    if pad == 0:
        return store
    return PartitionStore(*[
        torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), _FILL[name],
                                 dtype=x.dtype, device=x.device)])
        for name, x in zip(PartitionStore._fields, store)])


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
    return {prefix + name: getattr(store, name).cpu().numpy()
            for name in PartitionStore._fields}
