"""Fleet lifecycle plane — durability, background compaction, shard aging.

The port of ``repro.fleet.lifecycle``:

  * :mod:`~repro_torch.fleet.lifecycle.wal` — the binary write-ahead log
    ``IndexFleet.insert`` appends to (and fsyncs) before the delta scatter,
    in the reference's frame format byte for byte;
  * :mod:`~repro_torch.fleet.lifecycle.snapshot` — sealed-shard snapshots
    and the fleet manifest, in the reference's layout, atomic tmp-dir
    rename;
  * :mod:`~repro_torch.fleet.lifecycle.compactor` — the INX rebuild of a
    frozen delta on a worker thread, swapped in atomically;
  * :mod:`~repro_torch.fleet.lifecycle.merge` — merge small adjacent
    sealed shards, retire shards past a time horizon.

The crash contract is gid-based: a WAL frame whose global ids a sealed
shard already covers is skipped at replay.
"""
from repro_torch.fleet.lifecycle.compactor import CompactionTicket
from repro_torch.fleet.lifecycle.merge import MergePolicy
from repro_torch.fleet.lifecycle.snapshot import load_shard, save_shard
from repro_torch.fleet.lifecycle.wal import WriteAheadLog

__all__ = ["WriteAheadLog", "CompactionTicket", "MergePolicy",
           "save_shard", "load_shard"]
