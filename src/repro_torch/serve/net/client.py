"""Client library for the CLIMBER++ network serving plane.

The port of ``repro/serve/net/client.py``; it speaks the same frames, so it
works against either package's server.

Two clients over the same frames:

  * :class:`ClimberClient` — blocking socket client.  ``query()`` is one
    round trip; ``query_batch()`` pipelines a whole list before reading
    any reply, which is how a single connection keeps the server's
    double-buffered admission full.  Observes every round trip into the
    ``net.rtt_ms`` histogram so client-perceived tails sit next to the
    server's ``serve.latency_ms`` in the same registry.
  * :class:`AsyncClimberClient` — asyncio client multiplexing concurrent
    ``query()`` awaitables over one connection by ``request_id``.

Typed refusals surface as exceptions: :class:`RetryLater` (backpressure
and quota — carries ``retry_after_ms``) and :class:`ServerError`
(everything else, with the wire ``code``).  Both carry the decoded
:class:`~repro_torch.serve.api.ErrorReply`.
"""
from __future__ import annotations

import asyncio
import json
import socket
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs import REGISTRY, TRACER
from repro_torch.serve import api
from repro_torch.serve.net import codec, schema

__all__ = ["ServerError", "RetryLater", "ClimberClient",
           "AsyncClimberClient"]


class ServerError(RuntimeError):
    """The server answered with a typed :class:`~repro_torch.serve.api.ErrorReply`."""

    def __init__(self, reply: api.ErrorReply):
        super().__init__(f"{reply.code}: {reply.message}")
        self.reply = reply
        self.code = reply.code


class RetryLater(ServerError):
    """Backpressure / quota refusal; honor :attr:`retry_after_ms`."""

    @property
    def retry_after_ms(self) -> float:
        return self.reply.retry_after_ms


def _raise_for(reply: api.ErrorReply) -> None:
    if reply.code in ("RETRY_LATER", "QUOTA_EXCEEDED"):
        raise RetryLater(reply)
    raise ServerError(reply)


class ClimberClient:
    """Blocking client; usable as a context manager."""

    def __init__(self, host: str, port: int, *, tenant: str = "",
                 client_name: str = "climber-client",
                 timeout: float = 30.0):
        self.tenant = tenant
        self._client_name = client_name
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._next_rid = 0
        self.rtt_hist = REGISTRY.histogram("net.rtt_ms", client=client_name)
        self.info = self._handshake(client_name)

    def _handshake(self, client_name: str) -> api.ServerInfo:
        self._send(schema.MsgType.HELLO, {"client": client_name})
        mtype, msg = self._recv()
        if mtype == schema.MsgType.ERROR:
            _raise_for(msg)
        if mtype != schema.MsgType.SERVER_INFO:
            raise codec.FrameError(
                "BAD_PAYLOAD", f"expected SERVER_INFO, got {mtype.name}")
        return msg

    def _send(self, mtype: schema.MsgType, msg) -> None:
        self._sock.sendall(schema.encode_message(mtype, msg))

    def _recv(self):
        msg_type, payload = codec.read_frame_sync(self._sock)
        return schema.decode_message(msg_type, payload)

    def query(self, series: np.ndarray, k: int = 0, *,
              tenant: Optional[str] = None) -> api.QueryResult:
        """One kNN round trip.  Raises :class:`RetryLater` on
        backpressure/quota and :class:`ServerError` on other refusals."""
        return self.query_batch([series], k, tenant=tenant)[0]

    def query_batch(self, series_list: Sequence[np.ndarray], k: int = 0, *,
                    tenant: Optional[str] = None) -> List[api.QueryResult]:
        """Pipeline: send every request, then collect every reply.

        Replies are matched by ``request_id`` (the server answers in
        batch-completion order, not send order).  The first typed error
        raises after all replies are drained, so the stream stays in
        sync for the next call.

        The whole pipelined exchange runs under one ``net.rtt`` span
        with a client-minted ``trace_id`` that rides every request, so
        the server's admission/tick/fleet spans and the client's RTT
        span form ONE distributed trace.
        """
        tenant = self.tenant if tenant is None else tenant
        rids = []
        trace_id = TRACER.mint_trace_id()
        t0 = time.perf_counter()
        with TRACER.adopt(trace_id), \
                TRACER.span("net.rtt", client=self._client_name,
                            requests=len(series_list)) as rtt_span:
            for series in series_list:
                rid = self._next_rid
                self._next_rid += 1
                rids.append(rid)
                self._send(schema.MsgType.QUERY, api.QueryRequest(
                    series=np.asarray(series, np.float32), k=k,
                    tenant=tenant, request_id=rid,
                    trace_id=trace_id,
                    parent_span_id=rtt_span.span_id))
            replies: Dict[int, object] = {}
            while len(replies) < len(rids):
                mtype, msg = self._recv()
                if mtype not in (schema.MsgType.RESULT,
                                 schema.MsgType.ERROR):
                    raise codec.FrameError(
                        "BAD_PAYLOAD",
                        f"unexpected {mtype.name} from server")
                replies[msg.request_id] = msg
        rtt_ms = (time.perf_counter() - t0) * 1e3
        self.rtt_hist.observe(rtt_ms / max(1, len(rids)))
        for rid in rids:
            if isinstance(replies[rid], api.ErrorReply):
                _raise_for(replies[rid])
        return [replies[rid] for rid in rids]

    # -- admin plane -------------------------------------------------------
    def _admin(self, mtype: schema.MsgType, msg: dict) -> dict:
        """One admin round trip (call between query batches — the
        blocking client is sequential, so no replies can interleave)."""
        self._send(mtype, msg)
        got_type, got = self._recv()
        if got_type == schema.MsgType.ERROR:
            _raise_for(got)
        if got_type != mtype:
            raise codec.FrameError(
                "BAD_PAYLOAD", f"expected {mtype.name}, got {got_type.name}")
        return got

    def metrics(self) -> str:
        """The server's Prometheus text-exposition page, over the same
        socket queries ride (no separate scrape endpoint to deploy)."""
        return self._admin(schema.MsgType.METRICS, {})["page"]

    def health(self) -> dict:
        """Readiness card: ``ready`` / ``draining``, queue + executor
        depth, shard count, delta occupancy, compaction in flight,
        spans dropped (see ``ClimberServer.health``)."""
        return self._admin(schema.MsgType.HEALTH, {})

    def traces(self, limit: int = 0) -> List[dict]:
        """Recent tail-sampled slow/error traces from the server's
        flight recorder, newest last (``limit`` keeps the newest N)."""
        reply = self._admin(schema.MsgType.TRACES, {"limit": limit})
        text = reply["traces_jsonl"].strip()
        return [json.loads(line) for line in text.splitlines() if line]

    def close(self) -> None:
        try:
            self._send(schema.MsgType.BYE, {})
            self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        finally:
            self._sock.close()

    def __enter__(self) -> "ClimberClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncClimberClient:
    """Asyncio client: concurrent ``query()`` calls share one connection.

    Each in-flight request parks a future keyed by ``request_id``; one
    reader task resolves them as RESULT/ERROR frames arrive, so any
    number of tasks can await queries concurrently — the client-side
    mirror of the server's double-buffered admission.
    """

    def __init__(self, *, tenant: str = "",
                 client_name: str = "climber-async-client"):
        self.tenant = tenant
        self._client_name = client_name
        self._reader = None
        self._writer = None
        self._futures: Dict[int, asyncio.Future] = {}
        self._next_rid = 0
        self._reader_task = None
        self.info: Optional[api.ServerInfo] = None
        self.rtt_hist = REGISTRY.histogram("net.rtt_ms", client=client_name)

    @classmethod
    async def connect(cls, host: str, port: int, *, tenant: str = "",
                      client_name: str = "climber-async-client"
                      ) -> "AsyncClimberClient":
        self = cls(tenant=tenant, client_name=client_name)
        self._reader, self._writer = await asyncio.open_connection(host, port)
        self._writer.write(schema.encode_message(
            schema.MsgType.HELLO, {"client": client_name}))
        await self._writer.drain()
        msg_type, payload = await codec.read_frame(self._reader)
        mtype, msg = schema.decode_message(msg_type, payload)
        if mtype == schema.MsgType.ERROR:
            _raise_for(msg)
        if mtype != schema.MsgType.SERVER_INFO:
            raise codec.FrameError(
                "BAD_PAYLOAD", f"expected SERVER_INFO, got {mtype.name}")
        self.info = msg
        self._reader_task = asyncio.ensure_future(self._read_loop())
        return self

    async def _read_loop(self) -> None:
        try:
            while True:
                msg_type, payload = await codec.read_frame(self._reader)
                mtype, msg = schema.decode_message(msg_type, payload)
                fut = self._futures.pop(getattr(msg, "request_id", -1), None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            for fut in self._futures.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("connection closed"))
            self._futures.clear()

    async def query(self, series: np.ndarray, k: int = 0, *,
                    tenant: Optional[str] = None) -> api.QueryResult:
        rid = self._next_rid
        self._next_rid += 1
        fut = asyncio.get_event_loop().create_future()
        self._futures[rid] = fut
        trace_id = TRACER.mint_trace_id()
        t0 = time.perf_counter()
        # the span covers only the send — the await yields the event loop
        # to other tasks, so a span across it would nest their traces
        with TRACER.adopt(trace_id), \
                TRACER.span("net.rtt", client=self._client_name,
                            requests=1) as rtt_span:
            self._writer.write(schema.encode_message(
                schema.MsgType.QUERY, api.QueryRequest(
                    series=np.asarray(series, np.float32), k=k,
                    tenant=self.tenant if tenant is None else tenant,
                    request_id=rid,
                    trace_id=trace_id,
                    parent_span_id=rtt_span.span_id)))
            await self._writer.drain()
        msg = await fut
        self.rtt_hist.observe((time.perf_counter() - t0) * 1e3)
        if isinstance(msg, api.ErrorReply):
            _raise_for(msg)
        return msg

    async def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.write(schema.encode_message(
                    schema.MsgType.BYE, {}))
                await self._writer.drain()
            except (ConnectionError, OSError):
                pass
            self._writer.close()
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except asyncio.CancelledError:
                pass
