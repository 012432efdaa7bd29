"""Frame codec — length-prefixed, versioned, checksummed, pickle-free.

The port of ``repro/serve/net/codec.py`` (numpy and the standard library
only): the same bytes on the wire, so either package's client talks to
either package's server.

One frame on the wire is::

    +--------+---------+----------+----------+-------------+-------+
    | magic  | version | msg_type | reserved | payload_len | crc32 |
    |  u16   |   u16   |   u16    |   u16    |     u32     |  u32  |
    +--------+---------+----------+----------+-------------+-------+
    |                payload_len bytes of npz payload              |
    +--------------------------------------------------------------+

big-endian, 16-byte header (:data:`HEADER`).  The payload is a
``numpy.savez`` archive (``allow_pickle=False`` both ways — a hostile
peer can send bytes, never objects); scalars ride as 0-d arrays, strings
as 0-d unicode arrays.  ``crc32`` covers the payload only, so a flipped
bit anywhere in the body is caught before ``np.load`` ever parses it.

Every way the bytes can be wrong maps to a typed :class:`FrameError`
(``BAD_MAGIC`` / ``VERSION_MISMATCH`` / ``BAD_CRC`` / ``TRUNCATED`` /
``BAD_PAYLOAD`` / ``TOO_LARGE``) — the server answers decode failures
with a typed :class:`~repro_torch.serve.api.ErrorReply` instead of dying, and
a client can distinguish "retry" from "speak a newer protocol".
"""
from __future__ import annotations

import io
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from repro_torch.serve.api import WIRE_VERSION

__all__ = ["MAGIC", "HEADER", "HEADER_LEN", "MAX_PAYLOAD", "FrameError",
           "encode_payload", "decode_payload", "encode_frame",
           "decode_header", "read_frame", "read_frame_sync"]

MAGIC = 0xC11B                      # "CLIMBer" — rejects non-protocol bytes
HEADER = struct.Struct(">HHHHII")   # magic, version, msg_type, reserved,
HEADER_LEN = HEADER.size            # payload_len, crc32  (= 16 bytes)
MAX_PAYLOAD = 64 * 1024 * 1024      # refuse absurd length prefixes early


class FrameError(ValueError):
    """A frame failed to decode; ``code`` says how.

    Codes: ``BAD_MAGIC``, ``VERSION_MISMATCH``, ``BAD_CRC``, ``TRUNCATED``,
    ``BAD_PAYLOAD``, ``TOO_LARGE``.  ``VERSION_MISMATCH`` carries the
    peer's version in :attr:`peer_version`.
    """

    def __init__(self, code: str, message: str, peer_version: int = -1):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.peer_version = peer_version


def encode_payload(fields: Dict[str, object]) -> bytes:
    """npz-encode a flat dict of arrays / scalars / strings."""
    arrays = {}
    for key, val in fields.items():
        arr = np.asarray(val)
        if arr.dtype == object:
            raise TypeError(f"field {key!r} is not npz-encodable "
                            f"({type(val).__name__})")
        arrays[key] = arr
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_payload(payload: bytes) -> Dict[str, np.ndarray]:
    """Decode an npz payload back to a dict of arrays (never objects)."""
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as npz:
            return {key: npz[key] for key in npz.files}
    except Exception as exc:                      # zipfile/np parse errors
        raise FrameError("BAD_PAYLOAD", f"payload did not decode: {exc}")


def encode_frame(msg_type: int, payload: bytes,
                 version: int = WIRE_VERSION) -> bytes:
    if len(payload) > MAX_PAYLOAD:
        raise FrameError("TOO_LARGE",
                         f"payload {len(payload)}B > {MAX_PAYLOAD}B")
    header = HEADER.pack(MAGIC, version, msg_type, 0, len(payload),
                         zlib.crc32(payload) & 0xFFFFFFFF)
    return header + payload


def decode_header(header: bytes) -> Tuple[int, int, int]:
    """Validate a header; returns (msg_type, payload_len, crc32)."""
    if len(header) < HEADER_LEN:
        raise FrameError("TRUNCATED",
                         f"header {len(header)}B < {HEADER_LEN}B")
    magic, version, msg_type, _, length, crc = HEADER.unpack(
        header[:HEADER_LEN])
    if magic != MAGIC:
        raise FrameError("BAD_MAGIC", f"magic {magic:#06x} != {MAGIC:#06x}")
    if version != WIRE_VERSION:
        raise FrameError("VERSION_MISMATCH",
                         f"peer wire version {version} != {WIRE_VERSION}",
                         peer_version=version)
    if length > MAX_PAYLOAD:
        raise FrameError("TOO_LARGE", f"payload {length}B > {MAX_PAYLOAD}B")
    return msg_type, length, crc


def _check_crc(payload: bytes, crc: int) -> None:
    got = zlib.crc32(payload) & 0xFFFFFFFF
    if got != crc:
        raise FrameError("BAD_CRC", f"payload crc {got:#010x} != {crc:#010x}")


async def read_frame(reader) -> Tuple[int, bytes]:
    """Read one frame from an ``asyncio.StreamReader``.

    Returns ``(msg_type, payload)``; raises :class:`FrameError` on any
    malformed byte and ``ConnectionError``/``IncompleteReadError`` when
    the peer hangs up mid-frame.
    """
    header = await reader.readexactly(HEADER_LEN)
    msg_type, length, crc = decode_header(header)
    payload = await reader.readexactly(length) if length else b""
    _check_crc(payload, crc)
    return msg_type, payload


def read_frame_sync(sock) -> Tuple[int, bytes]:
    """Blocking :func:`read_frame` over a plain socket (client side)."""
    header = _recv_exactly(sock, HEADER_LEN)
    msg_type, length, crc = decode_header(header)
    payload = _recv_exactly(sock, length) if length else b""
    _check_crc(payload, crc)
    return msg_type, payload


def _recv_exactly(sock, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)
