"""Network serving plane of the port: the JAX package's TCP frames, typed
client and double-buffered asyncio server."""
from repro_torch.serve.net.client import (AsyncClimberClient, ClimberClient,
                                          RetryLater, ServerError)
from repro_torch.serve.net.codec import (FrameError, decode_payload,
                                         encode_frame, encode_payload,
                                         read_frame, read_frame_sync)
from repro_torch.serve.net.schema import (MsgType, decode_message,
                                          encode_message)
from repro_torch.serve.net.server import ClimberServer, serve_in_thread

__all__ = ["AsyncClimberClient", "ClimberClient", "RetryLater", "ServerError",
           "FrameError", "decode_payload", "encode_frame", "encode_payload",
           "read_frame", "read_frame_sync", "MsgType", "decode_message",
           "encode_message", "ClimberServer", "serve_in_thread"]
