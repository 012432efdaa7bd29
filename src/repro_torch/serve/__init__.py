"""Serving plane of the port: the typed API and the batched kNN engine."""
from repro_torch.serve.api import QueryRequest, QueryResult, ServingConfig
from repro_torch.serve.knn_engine import (ClimberEngine, EngineStats, PlanCache,
                                          QueryMetrics)

__all__ = ["ClimberEngine", "EngineStats", "PlanCache", "QueryMetrics",
           "QueryRequest", "QueryResult", "ServingConfig"]
