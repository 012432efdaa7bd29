"""Binary write-ahead log for the fleet's streaming delta.

A copy of the JAX package's ``repro/fleet/lifecycle/wal.py`` (numpy only):
the segment and frame format below is the same byte for byte, so either
package replays the other's log.

``IndexFleet.insert`` appends each batch here *before* the delta scatter,
so the log is always a superset of what the in-memory delta holds and a
restart can replay the exact insert sequence (same batches, same order —
which reproduces the delta's rebuild history bit-for-bit, since delta
rebuilds are keyed on occupancy at rebuild time).

Layout: one directory of numbered **segment** files.  The active segment
(highest id) receives appends; when the delta is frozen for compaction the
log ``roll()``s — the frozen segments then correspond exactly to the frozen
delta contents and are ``drop()``ped once the sealed shard is durable.  The
segment ↔ delta correspondence is what makes WAL truncation a pure space
reclaim: correctness never depends on it, because replay skips frames whose
global ids a sealed shard already covers.

Frame format (little-endian), append-only within a segment::

    segment  := SEG_MAGIC (8 bytes) frame*
    frame    := FRAME_MAGIC u32 | rows u32 | series_len u32 | crc32 u32
                | gids  int32[rows]
                | data  float32[rows * series_len]

``crc32`` covers the gid and data payload.  A crash mid-append leaves a
torn tail frame; replay detects it (short read / bad magic / bad crc) and
stops at the last complete frame — exactly the set of inserts that were
acknowledged durably.  Torn tails are only legal in the *last* segment;
anywhere else the log is corrupt and replay raises.
"""
from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SEG_MAGIC = b"CLWAL001"
FRAME_MAGIC = 0x464C4157          # "WALF"
_HEADER = struct.Struct("<IIII")  # magic, rows, series_len, crc32


class WalCorruptError(RuntimeError):
    """A non-tail segment holds a torn or corrupt frame."""


def fsync_dir(path) -> None:
    """fsync a directory so entry creates/renames survive power loss.

    Per-file fsync alone does not persist the *dirent*; without this a
    freshly rolled segment (or a just-published snapshot dir) can vanish
    on power failure even though its bytes were synced.  Best-effort:
    some filesystems refuse O_RDONLY fsync on directories.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def encode_frame(gids: np.ndarray, batch: np.ndarray) -> bytes:
    """One insert batch as a self-checking binary frame."""
    gids = np.ascontiguousarray(gids, dtype=np.int32)
    batch = np.ascontiguousarray(batch, dtype=np.float32)
    payload = gids.tobytes() + batch.tobytes()
    header = _HEADER.pack(FRAME_MAGIC, batch.shape[0], batch.shape[1],
                          zlib.crc32(payload) & 0xFFFFFFFF)
    return header + payload


def _decode_frames(raw: bytes) -> Tuple[List[Tuple[np.ndarray, np.ndarray]],
                                        bool]:
    """(frames, clean): parse until EOF or the first torn/corrupt frame."""
    frames: List[Tuple[np.ndarray, np.ndarray]] = []
    off = 0
    while off < len(raw):
        if off + _HEADER.size > len(raw):
            return frames, False                       # torn header
        magic, rows, n, crc = _HEADER.unpack_from(raw, off)
        size = rows * 4 + rows * n * 4
        if magic != FRAME_MAGIC or off + _HEADER.size + size > len(raw):
            return frames, False                       # torn / garbage
        payload = raw[off + _HEADER.size: off + _HEADER.size + size]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return frames, False                       # torn write
        gids = np.frombuffer(payload[: rows * 4], dtype=np.int32).copy()
        batch = np.frombuffer(payload[rows * 4:], dtype=np.float32
                              ).reshape(rows, n).copy()
        frames.append((gids, batch))
        off += _HEADER.size + size
    return frames, True


class WriteAheadLog:
    """Segmented append-only log under one directory.

    Args:
      root: directory holding the segment files (created if missing;
        existing segments are adopted and appends continue on the highest).
      fsync: fsync after every append (the durability point the crash
        tests rely on; disable only for benchmarks).
    """

    def __init__(self, root, *, fsync: bool = True):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.fsync = fsync
        self.appended_bytes = 0           # cumulative, this process
        existing = self.segments()
        self._active_id = existing[-1] if existing else 1
        self._fh = open(self._seg_path(self._active_id), "ab")
        if self._fh.tell() == 0:
            self._fh.write(SEG_MAGIC)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
                fsync_dir(self.root)        # the new dirent itself

    # -- segment bookkeeping ---------------------------------------------
    def _seg_path(self, seg_id: int) -> Path:
        return self.root / f"seg_{seg_id:08d}.wal"

    def segments(self) -> List[int]:
        """Segment ids on disk, ascending (== append order)."""
        return sorted(int(p.stem.split("_")[1])
                      for p in self.root.glob("seg_*.wal"))

    @property
    def active_segment(self) -> int:
        return self._active_id

    def bytes_on_disk(self) -> int:
        return sum(self._seg_path(s).stat().st_size
                   for s in self.segments()
                   if self._seg_path(s).exists())

    # -- the write path ---------------------------------------------------
    def append(self, gids: np.ndarray, batch: np.ndarray) -> int:
        """Durably append one insert batch; returns bytes written."""
        frame = encode_frame(gids, batch)
        self._fh.write(frame)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self.appended_bytes += len(frame)
        return len(frame)

    def roll(self) -> int:
        """Freeze the active segment and open the next one.

        Returns the frozen segment id.  Called when the delta is frozen
        for compaction: frames up to here belong to the frozen delta and
        are dropped together once the sealed shard is durable.
        """
        frozen = self._active_id
        self._fh.close()
        self._active_id += 1
        self._fh = open(self._seg_path(self._active_id), "ab")
        if self._fh.tell() == 0:
            self._fh.write(SEG_MAGIC)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
                fsync_dir(self.root)        # the new dirent itself
        return frozen

    def drop(self, seg_ids) -> None:
        """Delete frozen segments (space reclaim after a durable seal)."""
        for seg_id in seg_ids:
            if seg_id == self._active_id:
                raise ValueError(f"cannot drop the active segment {seg_id}")
            self._seg_path(seg_id).unlink(missing_ok=True)

    # -- the read path ----------------------------------------------------
    def replay(self) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """Every durable frame, in append order: ``(seg_id, gids, batch)``.

        A torn tail in the last segment is silently dropped (the append
        never completed, so the insert was never acknowledged); a torn
        frame anywhere else raises :class:`WalCorruptError`.
        """
        segs = self.segments()
        out: List[Tuple[int, np.ndarray, np.ndarray]] = []
        for i, seg_id in enumerate(segs):
            raw = self._seg_path(seg_id).read_bytes()
            if raw[: len(SEG_MAGIC)] != SEG_MAGIC:
                raise WalCorruptError(f"segment {seg_id}: bad magic")
            frames, clean = _decode_frames(raw[len(SEG_MAGIC):])
            if not clean and i != len(segs) - 1:
                raise WalCorruptError(
                    f"segment {seg_id}: torn frame before the tail segment")
            out.extend((seg_id, g, b) for g, b in frames)
        return out

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __del__(self):  # best-effort: tests create many short-lived logs
        try:
            self.close()
        except Exception:       # noqa: BLE001 — interpreter teardown
            pass
