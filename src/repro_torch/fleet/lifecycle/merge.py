"""LSM-style shard maintenance: merge small neighbours, retire the aged.

The port of ``repro/fleet/lifecycle/merge.py``: the same policy, pair
choice and crash ordering; the merged shard's records are recovered from
the partition stores on the card and rebuilt there.

Streaming workloads seal many small delta-sized shards; left alone, query
fan-out cost grows linearly with their count forever.  The classic LSM
answer applies directly (the fleet's sealed shards are its sorted runs):

  * **merge** — two *adjacent* sealed shards that are both small are
    rebuilt as one shard over their concatenated records.  Global ids are
    preserved and the raw records are recovered exactly from the partition
    stores (the store scatter is invertible through ``rec_gid``), so exact
    answers over the surviving records are unchanged — only the fan-out
    count and per-shard index quality improve.  Adjacency keeps the merge
    order-preserving: time-range neighbours stay neighbours, and the
    fleet's deterministic shard-order merge fold is undisturbed.
  * **retirement** — shards whose newest content is older than
    ``retire_after`` seconds are dropped entirely (their records leave the
    fleet; the id space is never reused).

Both run under :meth:`repro_torch.fleet.IndexFleet.maintenance`, typically
driven by ``FleetEngine.maintenance()`` ticks between serving batches.
The expensive step (the merged INX rebuild) runs off the fleet lock; the
splice itself is atomic and revalidates that the shard list did not change
underneath it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import require_dense


@dataclass(frozen=True)
class MergePolicy:
    """Knobs of one maintenance tick."""

    small_shard_records: int = 1024   # merge-eligible at or below this size
    max_merged_records: int = 8192    # never build a merged shard beyond this
    merges_per_tick: int = 1          # bound the work one tick may do
    retire_after: Optional[float] = None  # seconds since created_at;
                                          # None = shards never age out


def shard_records(handle) -> Tuple[torch.Tensor, np.ndarray]:
    """Recover a sealed shard's raw records in original row order.

    Inverts the ``build_store`` scatter: every live slot carries its local
    row id in ``rec_gid``, so ``(data [n, series_len], global_ids [n])``
    comes back bit-exact (``data`` on the shard's device) — which is what
    makes a merged rebuild answer-preserving.
    """
    store = require_dense(handle.index.store, "shard_records (a merge)")
    live = store.rec_gid >= 0
    out = torch.empty((handle.num_records, store.data.shape[-1]),
                      dtype=torch.float32, device=store.data.device)
    out[store.rec_gid[live].long()] = store.data[live]
    return out, np.asarray(handle.global_ids)


def _retire(fleet, policy: MergePolicy, now: float) -> List[str]:
    """Drop shards past the horizon (fleet lock held)."""
    from repro_torch.fleet.lifecycle.snapshot import write_manifest
    if policy.retire_after is None:
        return []
    retired = []
    keep = []
    for si, shard in enumerate(fleet.shards):
        if shard.created_at and now - shard.created_at > policy.retire_after:
            retired.append(shard.key)
        else:
            keep.append(si)
    if not retired:
        return []
    # splice the router registry in reverse so indices stay valid
    for si in reversed([i for i in range(len(fleet.shards))
                        if i not in keep]):
        if fleet.router is not None:
            fleet.router.replace_span(si, 1)
    fleet.shards = [fleet.shards[i] for i in keep]
    fleet._invalidate_placement()
    fleet.stats.retired_shards += len(retired)
    if fleet.storage_dir is not None:
        import shutil
        # manifest first: a crash must never leave it referencing deleted
        # snapshot dirs (the storage dir would be unopenable)
        old_slugs = [fleet._shard_dirs.pop(key, None) for key in retired]
        write_manifest(fleet, fleet.storage_dir)
        for slug in old_slugs:
            if slug:
                shutil.rmtree(fleet.storage_dir / "shards" / slug,
                              ignore_errors=True)
    return retired


def _pick_merge_pair(fleet, policy: MergePolicy) -> Optional[int]:
    """Index i of the first adjacent sealed pair (i, i+1) worth merging."""
    for i in range(len(fleet.shards) - 1):
        a, b = fleet.shards[i], fleet.shards[i + 1]
        if (a.num_records <= policy.small_shard_records
                and b.num_records <= policy.small_shard_records
                and a.num_records + b.num_records
                <= policy.max_merged_records):
            return i
    return None


def _merge_pair(fleet, i: int) -> Optional[str]:
    """Merge shards[i] and shards[i+1]; returns the new key (or None when
    the shard list changed under the rebuild and the merge was skipped)."""
    from repro_torch.fleet.fleet import ShardHandle
    from repro_torch.fleet.lifecycle.snapshot import write_manifest
    with fleet._lock:
        a, b = fleet.shards[i], fleet.shards[i + 1]
        fleet._merge_count += 1
        key = f"merged:{fleet._merge_count}"
        while any(s.key == key for s in fleet.shards):
            fleet._merge_count += 1
            key = f"merged:{fleet._merge_count}"
        # fold offset 1000+ keeps merge build keys disjoint from the
        # add_shard/seal fold family (len(shards) + 17)
        fold = 1000 + fleet._merge_count
    data_a, gids_a = shard_records(a)
    data_b, gids_b = shard_records(b)
    data = torch.cat([data_a, data_b])
    gids = np.concatenate([gids_a, gids_b])
    index = fleet._build_shard_index(data, fold)    # expensive: off-lock
    handle = ShardHandle(key=key, index=index, global_ids=gids,
                         created_at=max(a.created_at, b.created_at))
    with fleet._lock:
        if (i + 1 >= len(fleet.shards) or fleet.shards[i] is not a
                or fleet.shards[i + 1] is not b):
            return None                 # concurrent mutation: retry next tick
        fleet.shards[i: i + 2] = [handle]
        if fleet.router is not None:
            fleet.router.replace_span(i, 2, key,
                                      fleet.router.summarize(data))
        fleet._invalidate_placement()
        fleet.stats.merges += 1
        if fleet.storage_dir is not None:
            import shutil
            from repro_torch.fleet.lifecycle.snapshot import save_shard, shard_slug
            # crash ordering: new snapshot → manifest (no longer naming the
            # sources) → only then delete the source dirs, so the manifest
            # always references directories that exist
            slug = shard_slug(key, set(fleet._shard_dirs.values()))
            save_shard(fleet.storage_dir / "shards" / slug, handle)
            fleet._shard_dirs[key] = slug
            old_slugs = [fleet._shard_dirs.pop(old.key, None)
                         for old in (a, b)]
            write_manifest(fleet, fleet.storage_dir)
            for old_slug in old_slugs:
                if old_slug:
                    shutil.rmtree(fleet.storage_dir / "shards" / old_slug,
                                  ignore_errors=True)
    return key


def run_maintenance(fleet, policy: Optional[MergePolicy] = None,
                    now: Optional[float] = None) -> dict:
    """One tick: retire first (never merge doomed shards), then merge.

    Implements :meth:`repro_torch.fleet.IndexFleet.maintenance`; ``now`` is
    injectable for tests.  Returns ``{"retired": [...], "merged": [...]}``
    with the shard keys acted on.
    """
    policy = policy or fleet.merge_policy or MergePolicy()
    now = time.time() if now is None else now
    with fleet._lock:
        retired = _retire(fleet, policy, now)
    merged = []
    for _ in range(policy.merges_per_tick):
        with fleet._lock:
            i = _pick_merge_pair(fleet, policy)
        if i is None:
            break
        key = _merge_pair(fleet, i)
        if key is not None:
            merged.append(key)
    return {"retired": retired, "merged": merged}
