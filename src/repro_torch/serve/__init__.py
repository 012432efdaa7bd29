"""Serving plane of the port: the typed API, the batched kNN engine and its
admission hooks, and the LM slot engine (:class:`Engine`, :class:`Request`);
the TCP network plane is :mod:`repro_torch.serve.net`.

``QueryRequest`` here is the frozen :class:`api.QueryRequest`; the JAX
package's legacy mutable request is
:class:`repro_torch.serve.knn_engine.QueryRequest`.
"""
from repro_torch.serve import api
from repro_torch.serve.api import (ErrorReply, QueryRequest, QueryResult,
                                   ServerInfo, ServingConfig)
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.knn_engine import (BatchedServingLoop, ClimberEngine,
                                          EngineStats, PlanCache, QueryMetrics,
                                          QueryTicket)

__all__ = ["api", "BatchedServingLoop", "ClimberEngine", "Engine",
           "EngineStats", "ErrorReply", "PlanCache", "QueryMetrics",
           "QueryRequest", "QueryResult", "QueryTicket", "Request",
           "ServerInfo", "ServingConfig"]
