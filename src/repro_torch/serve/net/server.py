"""ClimberServer — asyncio TCP front for a BatchedServingLoop.

The port of ``repro/serve/net/server.py``.  The executor thread runs the
engine's ``execute_prepared``; the port's engines name their device on every
tensor and kernel launch (never the thread's current device) and copy each
answer to the host before its ticket completes, so an answer leaves the
server only once the card has finished it.

The serving path that used to be one blocking Python call is split into
two planes that overlap:

  * the **asyncio event loop** (host plane) accepts connections, decodes
    frames, validates requests (shape / k / quota) and *assembles* the
    next fixed-shape batch — featurize-ready, zero-padded — into the
    building buffer;
  * the **executor thread** (device plane) pops assembled batches off a
    bounded queue and runs ``engine.execute_prepared`` (featurize →
    descend → plan → refine on device).

Because assembly happens on the event loop while ``execute_prepared``
blocks only the executor thread, batch N+1 is admitted, validated and
padded while tick N is still on the device — the classic double buffer.
``admission_depth`` bounds how many assembled batches may wait; when the
buffers are full (or ``max_pending`` requests are in flight) the server
answers with a typed ``RETRY_LATER`` instead of queueing unboundedly,
and per-tenant quotas (optionally tightened for tenants hogging the
fleet's per-shard load) answer ``QUOTA_EXCEEDED``.

Every reply a connection receives is one of the
:mod:`repro_torch.serve.api` dataclasses over the :mod:`~repro_torch.serve.net.codec`
frame format — the server never sends an unframed byte and never dies on
a malformed one.
"""
from __future__ import annotations

import asyncio
import queue
import threading
from typing import List, Optional

from repro_torch.obs import REGISTRY, TRACER
from repro_torch.obs.export import to_prometheus
from repro_torch.obs.flight import FLIGHT
from repro_torch.serve import api
from repro_torch.serve.knn_engine import BatchedServingLoop, QueryTicket
from repro_torch.serve.net import codec, schema

__all__ = ["ClimberServer", "serve_in_thread"]


class _Connection:
    """Per-connection state: outbox queue + obs counters."""

    __slots__ = ("cid", "writer", "outbox", "pending", "closing", "alive",
                 "frames_in", "frames_out")

    def __init__(self, cid: int, writer):
        self.cid = cid
        self.writer = writer
        self.outbox: asyncio.Queue = asyncio.Queue()
        self.pending = 0          # admitted, answer not yet queued
        self.closing = False      # BYE received: close once drained
        self.alive = True
        label = f"c{cid}"
        self.frames_in = REGISTRY.counter("net.frames_in", conn=label)
        self.frames_out = REGISTRY.counter("net.frames_out", conn=label)

    def post(self, mtype: schema.MsgType, msg) -> None:
        if self.alive:
            self.outbox.put_nowait((mtype, msg))


class ClimberServer:
    """Typed TCP serving plane over one engine's admission path.

    Args:
      engine: a :class:`~repro_torch.serve.ClimberEngine` or
        :class:`~repro_torch.fleet.FleetEngine` (anything speaking the
        ``BatchedServingLoop`` ticket protocol).
      host / port: bind address; ``port=0`` picks a free port
        (read :attr:`port` after :meth:`start`).
      config: admission knobs (``admission_depth`` / ``max_pending`` /
        ``tenant_quota`` / ``hot_tenant_share`` / ``flush_interval_ms``)
        from one :class:`~repro_torch.serve.api.ServingConfig`; None reuses
        the engine's config.
    """

    def __init__(self, engine: BatchedServingLoop, host: str = "127.0.0.1",
                 port: int = 0, *,
                 config: Optional[api.ServingConfig] = None):
        self.engine = engine
        self.host = host
        self._requested_port = port
        self.config = config if config is not None \
            else getattr(engine, "config", api.ServingConfig())
        self.port: Optional[int] = None
        if self.config.trace_ring:
            TRACER.set_capacity(self.config.trace_ring)
        # tail-sampled slow/error traces served over the TRACES admin kind
        self.flight = FLIGHT

        # double buffer: building batch (event loop) + bounded exec queue
        self._building: List[QueryTicket] = []
        self._exec_queue: "queue.Queue" = queue.Queue(
            maxsize=max(1, self.config.admission_depth))
        self._executing = False      # exec thread is inside a device tick
        self._pending = 0            # admitted tickets not yet answered
        self._draining = False
        self.overlap_admissions = 0  # admits that happened during a tick

        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._exec_thread: Optional[threading.Thread] = None
        self._flush_task = None
        self._conns: dict = {}
        self._next_cid = 0

        self._n_conns = REGISTRY.counter("net.connections")
        self._n_queries = REGISTRY.counter("net.queries")
        self._n_rejected = REGISTRY.counter("net.rejected")
        self._n_overlap = REGISTRY.counter("net.overlap_admissions")

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        """Bind, start the executor thread and the flush timer."""
        self._loop = asyncio.get_running_loop()
        self._exec_thread = threading.Thread(
            target=self._exec_loop, name="climber-server-exec", daemon=True)
        self._exec_thread.start()
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self._requested_port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._flush_task = asyncio.ensure_future(self._flush_timer())

    async def stop(self) -> None:
        """Graceful shutdown: drain every in-flight request, then close.

        New admissions are refused with ``SHUTTING_DOWN`` the moment this
        is called; requests already admitted are executed and answered
        before the sockets close.
        """
        self._draining = True
        if self._server is not None:
            self._server.close()           # no new connections
        # drain: flush the partial batch, wait for the exec queue + tick
        while self._pending > 0:
            self._try_flush()
            await asyncio.sleep(0.002)
        self._exec_queue.put(None)         # executor sentinel
        if self._flush_task is not None:
            self._flush_task.cancel()
        for conn in list(self._conns.values()):
            conn.outbox.put_nowait(None)   # writer sentinel
        if self._server is not None:
            await self._server.wait_closed()
        if self._exec_thread is not None:
            await self._loop.run_in_executor(None, self._exec_thread.join)

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # -- admission (event loop side) --------------------------------------

    def _effective_quota(self, tenant: str) -> int:
        quota = self.config.tenant_quota
        if not quota:
            return 0
        share = self.config.hot_tenant_share
        if share < 1.0 and hasattr(self.engine, "tenant_load") \
                and self.engine.tenant_load(tenant) > share:
            return max(1, quota // 2)
        return quota

    def _admit(self, req: api.QueryRequest, conn: _Connection) -> None:
        """Validate + quota-check + append to the building batch.

        Every refusal posts a typed ErrorReply; success posts nothing
        (the answer arrives when the batch executes).  The admission
        decision runs under a ``net.admit`` span adopted into the
        request's client-minted trace, so a refusal is a one-span trace
        and an admit links the client's RTT span to the tick that will
        execute it."""
        with TRACER.adopt(req.trace_id, req.parent_span_id), \
                TRACER.span("net.admit",
                            conn=f"c{getattr(conn, 'cid', '?')}",
                            tenant=req.tenant):
            self._admit_inner(req, conn)

    def _admit_inner(self, req: api.QueryRequest,
                     conn: _Connection) -> None:
        if self._draining:
            self._reject(conn, req, "SHUTTING_DOWN", "server draining")
            return
        if self._pending >= self.config.max_pending or \
                len(self._building) >= self.engine.batch_size:
            # both buffers full — typed backpressure with a retry hint
            # scaled to the engine's mean tick time so far
            stats = self.engine.stats
            hint = max(1.0, stats.total_s / stats.ticks * 1e3
                       if stats.ticks else 1.0)
            self._reject(conn, req, "RETRY_LATER",
                         "admission buffers full", retry_after_ms=hint)
            return
        quota = self._effective_quota(req.tenant)
        if quota and self.engine.tenant_inflight(req.tenant) >= quota:
            self._reject(conn, req, "QUOTA_EXCEEDED",
                         f"tenant {req.tenant!r} at quota {quota}",
                         retry_after_ms=1.0)
            return
        try:
            ticket = self.engine.make_ticket(req)
        except ValueError as exc:
            self._reject(conn, req, "BAD_REQUEST", str(exc))
            return
        ticket.conn = conn
        conn.pending += 1
        self._pending += 1
        self._n_queries.inc()
        if self._executing:
            # the device is mid-tick N: this request lands in batch N+1 —
            # the overlap the double buffer exists for
            self.overlap_admissions += 1
            self._n_overlap.inc()
        self._building.append(ticket)
        if len(self._building) >= self.engine.batch_size:
            self._try_flush()

    def _reject(self, conn: _Connection, req: api.QueryRequest, code: str,
                message: str, retry_after_ms: float = 0.0) -> None:
        self._n_rejected.inc()
        # noted before the enclosing net.admit span finishes, so the
        # flight recorder retains the refused request's trace
        self.flight.note_error(req.trace_id, code)
        conn.post(schema.MsgType.ERROR,
                  api.ErrorReply(request_id=req.request_id, code=code,
                                 message=message,
                                 retry_after_ms=retry_after_ms))

    def _try_flush(self) -> None:
        """Hand the building batch to the executor if a buffer is free."""
        if not self._building or self._exec_queue.full():
            return
        tickets, self._building = self._building, []
        qbatch = self.engine.prepare_batch(tickets)
        self._exec_queue.put_nowait((qbatch, tickets))

    async def _flush_timer(self) -> None:
        """Flush partial batches so a trickle never waits for a full one."""
        interval = max(0.0005, self.config.flush_interval_ms / 1e3)
        while True:
            await asyncio.sleep(interval)
            self._try_flush()

    # -- execution (executor thread side) ---------------------------------

    def _exec_loop(self) -> None:
        while True:
            item = self._exec_queue.get()
            if item is None:
                return
            qbatch, tickets = item
            self._executing = True
            try:
                self.engine.execute_prepared(qbatch, tickets)
            except Exception as exc:   # typed INTERNAL, never a dead server
                self.engine.fail_tickets(
                    tickets, api.ErrorReply(
                        request_id=0, code="INTERNAL",
                        message=f"{type(exc).__name__}: {exc}"))
                # the tick's spans already closed when the exception
                # unwound, so note the error and finish a tiny net.fail
                # error-trigger span per trace to retain the evidence
                for t in tickets:
                    if t.trace is not None and t.trace.trace_id:
                        self.flight.note_error(t.trace.trace_id,
                                               "INTERNAL")
                        with TRACER.adopt(t.trace), \
                                TRACER.span("net.fail", code="INTERNAL"):
                            pass
            finally:
                self._executing = False
            self._loop.call_soon_threadsafe(self._deliver, tickets)

    def _deliver(self, tickets: List[QueryTicket]) -> None:
        """Back on the event loop: route each answered ticket out."""
        for ticket in tickets:
            self._pending -= 1
            conn = ticket.conn
            if conn is None or not conn.alive:
                continue
            conn.pending -= 1
            if isinstance(ticket.result, api.QueryResult):
                conn.post(schema.MsgType.RESULT, ticket.result)
            elif isinstance(ticket.result, api.ErrorReply):
                conn.post(schema.MsgType.ERROR, ticket.result)
            if conn.closing and conn.pending == 0:
                conn.outbox.put_nowait(None)
        self._try_flush()   # a buffer just freed: push a held batch

    # -- connection handling ----------------------------------------------

    def server_info(self) -> api.ServerInfo:
        engine = self.engine
        fleet = getattr(engine, "fleet", None)
        return api.ServerInfo(
            series_len=engine.series_len, k_max=engine.k,
            batch_size=engine.batch_size,
            engine="fleet" if fleet is not None else "climber",
            variant=getattr(engine, "variant", ""),
            routing=getattr(engine, "routing", ""),
            shards=len(fleet.shards) if fleet is not None else 0,
            max_pending=self.config.max_pending,
            tenant_quota=self.config.tenant_quota)

    def health(self) -> dict:
        """The HEALTH admin reply: readiness + load + lifecycle state.

        ``ready`` is "this server will admit a query right now": not
        draining.  The depth fields expose how full the double buffer is
        (``queue_depth`` = building batch, ``exec_depth`` = assembled
        batches waiting for the device); ``compaction_in_flight`` says a
        background INX rebuild is running (expect a latency shoulder);
        ``spans_dropped`` rising between scrapes means the trace ring is
        undersized for the load (raise ``ServingConfig.trace_ring``).
        """
        engine = self.engine
        fleet = getattr(engine, "fleet", None)
        dropped = TRACER._dropped
        return {
            "ready": int(not self._draining),
            "draining": int(self._draining),
            "pending": self._pending,
            "queue_depth": len(self._building),
            "exec_depth": self._exec_queue.qsize(),
            "shards": len(fleet.shards) if fleet is not None else 0,
            "delta_occupancy": fleet.delta.occupancy
            if fleet is not None else 0,
            "compaction_in_flight": int(
                fleet is not None and fleet._seal_ticket is not None),
            "spans_dropped": int(dropped.value)
            if dropped is not None else 0,
        }

    def _answer_admin(self, mtype: schema.MsgType, msg: dict,
                      conn: _Connection) -> None:
        """Admin plane: reply in the same MsgType over the same socket."""
        if mtype == schema.MsgType.METRICS:
            conn.post(mtype, {"page": to_prometheus(REGISTRY)})
        elif mtype == schema.MsgType.HEALTH:
            conn.post(mtype, self.health())
        else:                                   # TRACES
            limit = int(msg.get("limit", 0))
            records = self.flight.records(limit)
            conn.post(mtype, {"limit": limit, "count": len(records),
                              "traces_jsonl": self.flight.jsonl(limit)})

    async def _handle_connection(self, reader, writer) -> None:
        cid = self._next_cid
        self._next_cid += 1
        conn = _Connection(cid, writer)
        self._conns[cid] = conn
        self._n_conns.inc()
        writer_task = asyncio.ensure_future(self._write_loop(conn))
        try:
            with TRACER.span("net.connection", conn=f"c{cid}"):
                await self._read_loop(reader, conn)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass                            # peer hung up
        except codec.FrameError as exc:
            # malformed bytes: answer typed, then close — a corrupt
            # length prefix desyncs the stream, so no resync attempt
            code = "VERSION_MISMATCH" if exc.code == "VERSION_MISMATCH" \
                else "BAD_FRAME"
            conn.post(schema.MsgType.ERROR,
                      api.ErrorReply(request_id=0, code=code,
                                     message=str(exc)))
        finally:
            conn.closing = True
            if conn.pending == 0:
                conn.outbox.put_nowait(None)
            await writer_task
            conn.alive = False
            self._conns.pop(cid, None)
            writer.close()

    async def _read_loop(self, reader, conn: _Connection) -> None:
        # handshake: HELLO in, SERVER_INFO out
        msg_type, payload = await codec.read_frame(reader)
        conn.frames_in.inc()
        mtype, _hello = schema.decode_message(msg_type, payload)
        if mtype != schema.MsgType.HELLO:
            raise codec.FrameError(
                "BAD_PAYLOAD", f"expected HELLO, got {mtype.name}")
        conn.post(schema.MsgType.SERVER_INFO, self.server_info())
        while True:
            msg_type, payload = await codec.read_frame(reader)
            conn.frames_in.inc()
            mtype, msg = schema.decode_message(msg_type, payload)
            if mtype == schema.MsgType.BYE:
                return
            if mtype in (schema.MsgType.METRICS, schema.MsgType.HEALTH,
                         schema.MsgType.TRACES):
                self._answer_admin(mtype, msg, conn)
                continue
            if mtype != schema.MsgType.QUERY:
                raise codec.FrameError(
                    "BAD_PAYLOAD", f"unexpected {mtype.name} from client")
            self._admit(msg, conn)

    async def _write_loop(self, conn: _Connection) -> None:
        while True:
            item = await conn.outbox.get()
            if item is None:
                break
            mtype, msg = item
            try:
                conn.writer.write(schema.encode_message(mtype, msg))
                await conn.writer.drain()
                conn.frames_out.inc()
            except (ConnectionError, OSError):
                conn.alive = False
                return


def serve_in_thread(engine: BatchedServingLoop, host: str = "127.0.0.1",
                    port: int = 0, *,
                    config: Optional[api.ServingConfig] = None):
    """Run a :class:`ClimberServer` on a daemon thread's event loop.

    Returns ``(server, stop)`` once the port is bound — ``server.port``
    is live — where ``stop()`` drains gracefully and joins the thread.
    The in-process path tests and benchmarks use this to get a real
    socket without giving up the calling thread.
    """
    server = ClimberServer(engine, host, port, config=config)
    started = threading.Event()
    loop_box: dict = {}

    def _run():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop_box["loop"] = loop
        loop.run_until_complete(server.start())
        started.set()
        try:
            loop.run_forever()
        finally:
            loop.close()

    thread = threading.Thread(target=_run, name="climber-server", daemon=True)
    thread.start()
    if not started.wait(timeout=30):
        raise RuntimeError("server failed to start within 30s")
    loop = loop_box["loop"]

    def stop():
        fut = asyncio.run_coroutine_threadsafe(server.stop(), loop)
        fut.result(timeout=60)
        # one extra loop turn so transport-close callbacks run before the
        # loop itself shuts down (else their GC warns "loop is closed")
        asyncio.run_coroutine_threadsafe(asyncio.sleep(0.02), loop).result()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)

    return server, stop
