"""Background compaction — the INX rebuild off the query path.

The port of ``repro/fleet/lifecycle/compactor.py``.  The worker thread
builds on the fleet's card, on the default stream the serving thread also
launches on, and synchronises the card before the swap, so no query ever
reads a half-built store.

The sealing protocol (ParIS/MESSI's lesson: index construction does not
belong on the query thread):

  1. **freeze** (fleet lock): the live delta becomes the *frozen* delta —
     still queried, now immutable — a fresh delta takes over ingest, and
     the WAL rolls so the frozen segments correspond exactly to the frozen
     contents;
  2. **build** (worker thread, no lock): the full CLIMBER-INX rebuild over
     the frozen contents — identical arithmetic and key derivation to the
     synchronous path, so the sealed shard is bit-identical to what a
     blocking ``compact()`` would have produced;
  3. **swap** (fleet lock): snapshot the shard (when storage is attached),
     splice it into the shard list + router, rewrite the manifest, drop
     the frozen delta — atomic from a query's point of view: a query sees
     either ``shards + frozen delta`` or ``shards∪{sealed}``, never both
     and never neither;
  4. **truncate**: the frozen WAL segments are dropped last — crash before
     this point replays them, and replay skips frames whose gids the
     sealed shard's snapshot already covers.

A failed build aborts cleanly: the frozen contents fold back into the live
delta (no acknowledged insert is ever lost) and the error surfaces on the
ticket.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.obs import TRACER


class CompactionTicket:
    """Handle on one in-flight background seal."""

    def __init__(self, fleet):
        self._fleet = fleet
        self._event = threading.Event()
        self.handle = None              # ShardHandle once sealed
        self.error: Optional[BaseException] = None
        self.seconds: float = 0.0       # freeze-to-swap wall time

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None):
        """Block until the seal finishes; returns the new ShardHandle.

        Re-raises the build's exception if it failed; raises TimeoutError
        if ``timeout`` elapses first.
        """
        if not self._event.wait(timeout):
            raise TimeoutError("compaction still running")
        if self.error is not None:
            raise self.error
        return self.handle


def start_background_compaction(fleet) -> Optional[CompactionTicket]:
    """Freeze the delta and seal it on a worker thread.

    Returns the ticket, the already-running ticket if a seal is in
    flight, or None when the delta is empty.  Raises ValueError (before
    any state changes) when the delta is too small to build an index.
    """
    with fleet._lock:
        if fleet._seal_ticket is not None and not fleet._seal_ticket.done():
            return fleet._seal_ticket
        with TRACER.span("compact.freeze"):
            frozen = fleet._freeze()    # may raise ValueError (< num_pivots)
        if frozen is None:
            return None
        ticket = CompactionTicket(fleet)
        fleet._seal_ticket = ticket

    # trace handoff: when a serving tick's maintenance hook triggered this
    # seal, the worker thread's compact.* spans join the triggering
    # request's trace (adopt is a no-op when no span is open — an
    # explicitly-called compaction still roots its own tree as before)
    trigger_ctx = TRACER.current_context()

    def _worker():
        t0 = time.perf_counter()
        with TRACER.adopt(trigger_ctx), \
                TRACER.span("compact.seal", key=frozen.key,
                            records=len(frozen.data)):
            try:
                with TRACER.span("compact.build"):
                    index = fleet._build_shard_index(frozen.data,
                                                     frozen.fold)
                from repro_torch.fleet.fleet import ShardHandle
                handle = ShardHandle(key=frozen.key, index=index,
                                     global_ids=frozen.global_ids,
                                     created_at=time.time())
                with TRACER.span("compact.swap"):
                    fleet._finish_seal(frozen, handle)
                ticket.handle = handle
            except BaseException as exc:  # noqa: BLE001 — surface on ticket
                try:
                    fleet._abort_seal(frozen)
                finally:
                    ticket.error = exc
            finally:
                ticket.seconds = time.perf_counter() - t0
                with fleet._lock:
                    fleet.stats.compaction_ms += ticket.seconds * 1e3
                    if fleet._seal_ticket is ticket:
                        fleet._seal_ticket = None
                fleet.compaction_hist.observe(ticket.seconds * 1e3)
                ticket._event.set()

    thread = threading.Thread(target=_worker, name="fleet-compactor",
                              daemon=True)
    ticket.thread = thread
    thread.start()
    return ticket
