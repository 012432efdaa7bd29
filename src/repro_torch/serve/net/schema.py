"""Message schema — the :mod:`repro_torch.serve.api` dataclasses on the wire.

The port of ``repro/serve/net/schema.py``: the same field names, order and
dtypes per message, so ``np.savez`` writes the same payload bytes as the
JAX package's encoder.

Each message type maps one api dataclass to a flat npz field dict and
back.  The mapping is explicit per type (no reflection, no pickle): a
field the decoder does not expect is ignored, a missing field raises a
typed ``BAD_PAYLOAD`` :class:`~repro_torch.serve.net.codec.FrameError` — so a
*minor* additive schema change is forward-compatible while structural
changes bump :data:`~repro_torch.serve.api.WIRE_VERSION`.

Scalars travel as 0-d arrays (``np.asarray(3)``), strings as 0-d unicode
arrays; ``_scalar``/``_text`` undo that on decode.  Query series are
cast to float32 on encode — the engine's native dtype — so client and
server never disagree on precision.
"""
from __future__ import annotations

import enum
from typing import Tuple, Union

import numpy as np

from repro_torch.serve import api
from repro_torch.serve.net import codec

__all__ = ["MsgType", "Message", "encode_message", "decode_message"]


class MsgType(enum.IntEnum):
    HELLO = 1         # client → server: wire version + client name
    SERVER_INFO = 2   # server → client: api.ServerInfo handshake card
    QUERY = 3         # client → server: api.QueryRequest
    RESULT = 4        # server → client: api.QueryResult
    ERROR = 5         # server → client: api.ErrorReply
    BYE = 6           # client → server: drain + close this connection
    # admin plane: request/reply share the kind; the client sends
    # an (empty or small) dict, the server replies with the payload dict
    METRICS = 7       # ↔ the Prometheus text-exposition page
    HEALTH = 8        # ↔ readiness: drain state, queue depth, compaction
    TRACES = 9        # ↔ the flight recorder's retained slow traces


Message = Union[api.QueryRequest, api.QueryResult, api.ErrorReply,
                api.ServerInfo, dict]


def _scalar(fields, key, cast, default=None):
    if key not in fields:
        if default is not None:
            return default
        raise codec.FrameError("BAD_PAYLOAD", f"missing field {key!r}")
    return cast(fields[key].item())


def _text(fields, key, default=""):
    if key not in fields:
        return default
    return str(fields[key].item())


# -- per-type encoders -----------------------------------------------------

def _enc_hello(msg: dict) -> bytes:
    return codec.encode_payload({
        "wire_version": np.asarray(api.WIRE_VERSION, np.int32),
        "client": np.asarray(str(msg.get("client", ""))),
    })


def _enc_query(msg: api.QueryRequest) -> bytes:
    # trace_id / parent_span_id are additive: an older decoder
    # ignores the extra fields, an older encoder's frames decode with the
    # 0 = "no trace" default — WIRE_VERSION stays 1
    return codec.encode_payload({
        "request_id": np.asarray(msg.request_id, np.int64),
        "series": np.asarray(msg.series, np.float32),
        "k": np.asarray(msg.k, np.int32),
        "tenant": np.asarray(msg.tenant),
        "trace_id": np.asarray(msg.trace_id, np.uint64),
        "parent_span_id": np.asarray(msg.parent_span_id, np.uint64),
    })


def _enc_result(msg: api.QueryResult) -> bytes:
    return codec.encode_payload({
        "request_id": np.asarray(msg.request_id, np.int64),
        "dist": np.asarray(msg.dist, np.float32),
        "gid": np.asarray(msg.gid, np.int32),
        "partitions_touched": np.asarray(msg.partitions_touched, np.int64),
        "candidates_scanned": np.asarray(msg.candidates_scanned, np.int64),
        "latency_ms": np.asarray(msg.latency_ms, np.float64),
        "batch_fill": np.asarray(msg.batch_fill, np.float64),
        "trace_id": np.asarray(msg.trace_id, np.uint64),
        "parent_span_id": np.asarray(msg.parent_span_id, np.uint64),
    })


def _enc_error(msg: api.ErrorReply) -> bytes:
    return codec.encode_payload({
        "request_id": np.asarray(msg.request_id, np.int64),
        "code": np.asarray(msg.code),
        "message": np.asarray(msg.message),
        "retry_after_ms": np.asarray(msg.retry_after_ms, np.float64),
    })


def _enc_info(msg: api.ServerInfo) -> bytes:
    return codec.encode_payload({
        "series_len": np.asarray(msg.series_len, np.int32),
        "k_max": np.asarray(msg.k_max, np.int32),
        "batch_size": np.asarray(msg.batch_size, np.int32),
        "wire_version": np.asarray(msg.wire_version, np.int32),
        "engine": np.asarray(msg.engine),
        "variant": np.asarray(msg.variant),
        "routing": np.asarray(msg.routing),
        "shards": np.asarray(msg.shards, np.int32),
        "max_pending": np.asarray(msg.max_pending, np.int32),
        "tenant_quota": np.asarray(msg.tenant_quota, np.int32),
    })


# -- admin plane (dict payloads both directions) ---------------------------
#
# A client's admin *request* is a small dict ({} or {"limit": n}); the
# server's *reply* reuses the same MsgType with the payload filled in.
# Every reply field decodes with a default, so the admin plane follows the
# same additive-evolution rule as QUERY/RESULT.

# readiness scalars a HEALTH reply carries (all encoded int64)
_HEALTH_FIELDS = ("ready", "draining", "pending", "queue_depth",
                  "exec_depth", "shards", "delta_occupancy",
                  "compaction_in_flight", "spans_dropped")


def _enc_metrics(msg: dict) -> bytes:
    return codec.encode_payload({
        "page": np.asarray(str(msg.get("page", "")))})


def _dec_metrics(fields) -> dict:
    return {"page": _text(fields, "page")}


def _enc_health(msg: dict) -> bytes:
    return codec.encode_payload({
        key: np.asarray(int(msg.get(key, 0)), np.int64)
        for key in _HEALTH_FIELDS})


def _dec_health(fields) -> dict:
    return {key: _scalar(fields, key, int, 0) for key in _HEALTH_FIELDS}


def _enc_traces(msg: dict) -> bytes:
    return codec.encode_payload({
        "limit": np.asarray(int(msg.get("limit", 0)), np.int64),
        "count": np.asarray(int(msg.get("count", 0)), np.int64),
        "traces_jsonl": np.asarray(str(msg.get("traces_jsonl", ""))),
    })


def _dec_traces(fields) -> dict:
    return {"limit": _scalar(fields, "limit", int, 0),
            "count": _scalar(fields, "count", int, 0),
            "traces_jsonl": _text(fields, "traces_jsonl")}


# -- per-type decoders -----------------------------------------------------

def _dec_hello(fields) -> dict:
    return {"wire_version": _scalar(fields, "wire_version", int),
            "client": _text(fields, "client")}


def _dec_query(fields) -> api.QueryRequest:
    if "series" not in fields:
        raise codec.FrameError("BAD_PAYLOAD", "missing field 'series'")
    return api.QueryRequest(
        series=np.asarray(fields["series"], np.float32),
        k=_scalar(fields, "k", int, 0),
        tenant=_text(fields, "tenant"),
        request_id=_scalar(fields, "request_id", int, 0),
        trace_id=_scalar(fields, "trace_id", int, 0),
        parent_span_id=_scalar(fields, "parent_span_id", int, 0))


def _dec_result(fields) -> api.QueryResult:
    for key in ("dist", "gid"):
        if key not in fields:
            raise codec.FrameError("BAD_PAYLOAD", f"missing field {key!r}")
    return api.QueryResult(
        request_id=_scalar(fields, "request_id", int, 0),
        dist=np.asarray(fields["dist"], np.float32),
        gid=np.asarray(fields["gid"], np.int32),
        partitions_touched=_scalar(fields, "partitions_touched", int, 0),
        candidates_scanned=_scalar(fields, "candidates_scanned", int, 0),
        latency_ms=_scalar(fields, "latency_ms", float, 0.0),
        batch_fill=_scalar(fields, "batch_fill", float, 0.0),
        trace_id=_scalar(fields, "trace_id", int, 0),
        parent_span_id=_scalar(fields, "parent_span_id", int, 0))


def _dec_error(fields) -> api.ErrorReply:
    code = _text(fields, "code", "INTERNAL")
    if code not in api.ERROR_CODES:
        raise codec.FrameError("BAD_PAYLOAD", f"unknown error code {code!r}")
    return api.ErrorReply(
        request_id=_scalar(fields, "request_id", int, 0),
        code=code,
        message=_text(fields, "message"),
        retry_after_ms=_scalar(fields, "retry_after_ms", float, 0.0))


def _dec_info(fields) -> api.ServerInfo:
    return api.ServerInfo(
        series_len=_scalar(fields, "series_len", int),
        k_max=_scalar(fields, "k_max", int),
        batch_size=_scalar(fields, "batch_size", int),
        wire_version=_scalar(fields, "wire_version", int,
                             api.WIRE_VERSION),
        engine=_text(fields, "engine"),
        variant=_text(fields, "variant"),
        routing=_text(fields, "routing"),
        shards=_scalar(fields, "shards", int, 0),
        max_pending=_scalar(fields, "max_pending", int, 0),
        tenant_quota=_scalar(fields, "tenant_quota", int, 0))


_ENCODERS = {
    MsgType.HELLO: _enc_hello,
    MsgType.SERVER_INFO: _enc_info,
    MsgType.QUERY: _enc_query,
    MsgType.RESULT: _enc_result,
    MsgType.ERROR: _enc_error,
    MsgType.BYE: lambda msg: codec.encode_payload({}),
    MsgType.METRICS: _enc_metrics,
    MsgType.HEALTH: _enc_health,
    MsgType.TRACES: _enc_traces,
}

_DECODERS = {
    MsgType.HELLO: _dec_hello,
    MsgType.SERVER_INFO: _dec_info,
    MsgType.QUERY: _dec_query,
    MsgType.RESULT: _dec_result,
    MsgType.ERROR: _dec_error,
    MsgType.BYE: lambda fields: {},
    MsgType.METRICS: _dec_metrics,
    MsgType.HEALTH: _dec_health,
    MsgType.TRACES: _dec_traces,
}


def encode_message(msg_type: MsgType, msg: Message) -> bytes:
    """One api dataclass (or handshake dict) → one complete frame."""
    return codec.encode_frame(int(msg_type), _ENCODERS[MsgType(msg_type)](msg))


def decode_message(msg_type: int, payload: bytes) -> Tuple[MsgType, Message]:
    """One received frame body → ``(MsgType, api dataclass | dict)``."""
    try:
        mtype = MsgType(msg_type)
    except ValueError:
        raise codec.FrameError("BAD_PAYLOAD",
                               f"unknown message type {msg_type}")
    return mtype, _DECODERS[mtype](codec.decode_payload(payload))
