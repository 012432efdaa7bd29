"""Sealed-shard snapshots + the fleet-level save/open manifest.

The port of ``repro/fleet/lifecycle/snapshot.py``: the same directory
layout, file names, npz keys and manifest JSON, so either package opens a
fleet the other saved.  Arrays come off the card once per save; a load
puts them on the fleet's device.

A sealed shard is fully described by its :class:`~repro_torch.core.index.
PartitionStore` arrays, its trie skeleton (:class:`~repro_torch.core.trie.
TrieForest` — plain numpy tables plus three scalars), its pivots/centroids,
and its ``global_ids`` map.  :func:`save_shard` serializes exactly that to
one ``arrays.npz`` plus a JSON ``MANIFEST.json``; :func:`load_shard`
rebuilds the :class:`~repro_torch.core.index.ClimberIndex` (the device trie is
re-derived from the forest, which is deterministic), so a restored shard's
answers are bit-identical to the live shard's.

Atomicity reuses the ``train/checkpoint.py`` pattern: everything is written
into a ``<dir>.tmp`` sibling, fsynced, and published with one
``os.rename`` — a crash mid-write never leaves a half snapshot that
``open`` would pick up.

The fleet-level layout under one storage directory::

    <dir>/
      FLEET_MANIFEST.json     # configs, gid watermark, shard list, router
      ROUTER.npz              # reference pivots + per-shard summaries
      shards/<slug>/          # one atomic snapshot dir per sealed shard
          MANIFEST.json
          arrays.npz
      wal/seg_*.wal           # the delta's write-ahead log (lifecycle.wal)

``save_fleet`` implements ``IndexFleet.save`` and ``IndexFleet.open`` reads back:
save persists every sealed shard not yet on disk plus the manifest and
router state (the WAL is already durable — it is written at insert time);
open loads the manifest's shards, restores the router verbatim (routing
decisions survive restart bit-for-bit), and replays the WAL tail into a
fresh delta, skipping frames whose global ids a sealed shard already
covers (the crash window between compact swap and WAL truncate).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.index import ClimberIndex, require_dense, store_from_arrays
from repro_torch.core.traversal import TrieDevice
from repro_torch.core.trie import TrieForest
from repro_torch.distributed.store import store_to_arrays
from repro_torch.fleet.lifecycle.wal import fsync_dir
from repro_torch.utils.config import ClimberConfig
from repro_torch.utils.device import DeviceLike, resolve_device

SNAPSHOT_VERSION = 1

_FOREST_ARRAYS = ("child_start", "edge_pivot", "edge_child", "edge_key",
                  "node_size", "node_depth", "dfs_in", "dfs_out",
                  "part_start", "part_ids", "group_root",
                  "group_default_part")
_FOREST_SCALARS = ("num_partitions", "num_pivots", "max_parts_per_node")


def _atomic_dir(final: Path):
    """Context-ish helper: returns a tmp dir; call :func:`_publish` after."""
    tmp = final.parent / (final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    return tmp


def _publish(tmp: Path, final: Path) -> None:
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                          # atomic publish
    fsync_dir(final.parent)                        # persist the rename


def _write_json(path: Path, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.flush()
        os.fsync(f.fileno())


def _atomic_json(path: Path, doc: dict) -> None:
    tmp = path.parent / (path.name + ".tmp")
    _write_json(tmp, doc)
    os.replace(tmp, path)
    fsync_dir(path.parent)


def shard_slug(key: str, taken) -> str:
    """Filesystem-safe, collision-free directory name for a shard key."""
    base = re.sub(r"[^A-Za-z0-9_.-]", "_", key) or "shard"
    slug, i = base, 1
    while slug in taken:
        slug, i = f"{base}_{i}", i + 1
    return slug


# -- one sealed shard -----------------------------------------------------
def save_shard(dir_: Path, handle) -> Path:
    """Atomically snapshot one sealed :class:`~repro_torch.fleet.ShardHandle`."""
    dir_ = Path(dir_)
    idx: ClimberIndex = handle.index
    require_dense(idx.store, "save_shard (a snapshot)")
    tmp = _atomic_dir(dir_)
    arrays: Dict[str, np.ndarray] = store_to_arrays(idx.store)
    arrays["pivots"] = idx.pivots.cpu().numpy()
    arrays["centroid_onehot"] = idx.centroid_onehot.cpu().numpy()
    arrays["global_ids"] = np.asarray(handle.global_ids)
    for name in _FOREST_ARRAYS:
        arrays["forest_" + name] = np.asarray(getattr(idx.forest, name))
    np.savez(tmp / "arrays.npz", **arrays)
    _write_json(tmp / "MANIFEST.json", {
        "version": SNAPSHOT_VERSION,
        "key": handle.key,
        "created_at": handle.created_at,
        "num_records": int(handle.num_records),
        "cfg": dataclasses.asdict(idx.cfg),
        "forest": {name: int(getattr(idx.forest, name))
                   for name in _FOREST_SCALARS},
    })
    _publish(tmp, dir_)
    return dir_


def load_shard(dir_: Path, device: DeviceLike = None):
    """Rebuild a :class:`~repro_torch.fleet.ShardHandle` from
    :func:`save_shard`, on ``device``.

    The store/pivot/forest arrays load bit-exact; the device trie is
    re-derived from the forest (``TrieDevice.from_forest`` is a pure
    function of it), so query answers match the pre-snapshot shard
    bit-for-bit.
    """
    from repro_torch.fleet.fleet import ShardHandle
    dev = resolve_device(device)
    dir_ = Path(dir_)
    manifest = json.loads((dir_ / "MANIFEST.json").read_text())
    if manifest["version"] != SNAPSHOT_VERSION:
        raise ValueError(f"{dir_}: snapshot version {manifest['version']} "
                         f"!= {SNAPSHOT_VERSION}")
    arrays = np.load(dir_ / "arrays.npz")
    forest = TrieForest(
        **{name: arrays["forest_" + name] for name in _FOREST_ARRAYS},
        **{name: int(manifest["forest"][name]) for name in _FOREST_SCALARS})
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    index = ClimberIndex(cfg=ClimberConfig(**manifest["cfg"]),
                         pivots=t(arrays["pivots"]),
                         centroid_onehot=t(arrays["centroid_onehot"]),
                         forest=forest,
                         trie=TrieDevice.from_forest(forest, dev),
                         store=store_from_arrays(arrays, dev))
    return ShardHandle(key=manifest["key"], index=index,
                       global_ids=np.array(arrays["global_ids"]),
                       created_at=float(manifest.get("created_at", 0.0)))


# -- whole fleet ----------------------------------------------------------
def write_manifest(fleet, dir_: Path) -> None:
    """Atomically (re)write FLEET_MANIFEST.json + ROUTER.npz for ``fleet``.

    Caller must hold the fleet lock; every shard listed must already have
    a published snapshot dir (``fleet._shard_dirs``).
    """
    dir_ = Path(dir_)
    fc = dataclasses.asdict(fleet.cfg)
    shard_cfg = fc.pop("shard_cfg")
    router_doc: Optional[dict] = None
    if fleet.router is not None:
        tmp = dir_ / "ROUTER_tmp.npz"   # .npz name so savez won't rename it
        np.savez(tmp,
                 pivots=fleet.router.pivots.cpu().numpy(),
                 summaries=(np.stack(fleet.router._summaries)
                            if fleet.router._summaries
                            else np.zeros((0, fleet.router.pivots.shape[0]),
                                          np.float32)))
        os.replace(tmp, dir_ / "ROUTER.npz")
        router_doc = {"file": "ROUTER.npz", "keys": list(fleet.router.keys)}
    _atomic_json(dir_ / "FLEET_MANIFEST.json", {
        "version": SNAPSHOT_VERSION,
        "fleet": fc,
        "shard_cfg": shard_cfg,
        "next_gid": int(fleet._next_gid),
        "seal_count": int(fleet._seal_count),
        "merge_count": int(fleet._merge_count),
        "shards": [{"key": s.key, "dir": fleet._shard_dirs[s.key],
                    "num_records": int(s.num_records),
                    "created_at": s.created_at}
                   for s in fleet.shards],
        "router": router_doc,
    })


def save_fleet(fleet, dir_: Path) -> Path:
    """Persist every sealed shard + the manifest (``IndexFleet.save``).

    Shards already snapshotted under this directory are skipped (their
    key is in ``fleet._shard_dirs``); the manifest always rewrites, so
    merges/retirements since the last save take effect.
    """
    dir_ = Path(dir_)
    (dir_ / "shards").mkdir(parents=True, exist_ok=True)
    taken = set(fleet._shard_dirs.values())
    for handle in fleet.shards:
        if handle.key in fleet._shard_dirs:
            continue
        slug = shard_slug(handle.key, taken)
        taken.add(slug)
        save_shard(dir_ / "shards" / slug, handle)
        fleet._shard_dirs[handle.key] = slug
    write_manifest(fleet, dir_)
    return dir_


def read_manifest(dir_: Path) -> dict:
    path = Path(dir_) / "FLEET_MANIFEST.json"
    if not path.exists():
        raise FileNotFoundError(f"no fleet manifest under {dir_}")
    manifest = json.loads(path.read_text())
    if manifest["version"] != SNAPSHOT_VERSION:
        raise ValueError(f"{dir_}: manifest version {manifest['version']} "
                         f"!= {SNAPSHOT_VERSION}")
    return manifest


def load_router(dir_: Path, manifest: dict, cfg: ClimberConfig,
                device: DeviceLike = None):
    """Restore the SignatureRouter verbatim (pivots + summaries + keys),
    its pivots on ``device``."""
    from repro_torch.fleet.router import SignatureRouter
    doc = manifest.get("router")
    if not doc:
        return None
    arrays = np.load(Path(dir_) / doc["file"])
    router = SignatureRouter(
        torch.from_numpy(np.array(arrays["pivots"])).to(resolve_device(device)),
        cfg)
    for key, summary in zip(doc["keys"], arrays["summaries"]):
        router.register(key, summary)
    return router
