"""Typed serving API — the one request/response contract for every entry.

A copy of ``repro.serve.api`` (plain numpy dataclasses), kept in the port so
that it imports nothing of the JAX package; a configuration means the same
in both packages, and the network plane (``repro_torch.serve.net``) puts
these dataclasses on the wire in the same frames.

Until this module existed each entry point had its own implicit calling
convention: ``ClimberEngine.submit`` took a *mutable* ``QueryRequest`` it
wrote the answer back into, ``run`` took ``(queries, k)`` tuples and
returned parallel arrays, and the fleet threaded dict-shaped metrics
alongside.  A network serving plane cannot ship "a Python object the
server mutates" over a socket, so the contract is made explicit here:

  * :class:`QueryRequest`  — one immutable kNN question (series, k,
    tenant, correlation id);
  * :class:`QueryResult`   — one immutable answer (dist/gid + per-query
    execution metrics);
  * :class:`ErrorReply`    — every way the server can say no, typed
    (validation, backpressure, quota, version skew, shutdown);
  * :class:`ServerInfo`    — the handshake card a server deals a client
    (static shapes, limits, wire version);
  * :class:`ServingConfig` — every engine/server construction knob in one
    documented dataclass shared by :class:`~repro.serve.ClimberEngine`,
    :class:`~repro.fleet.FleetEngine`, and
    :class:`~repro.serve.net.ClimberServer`.

The same four dataclasses are used in-process (``submit_request`` /
``QueryTicket.result``) and on the wire (``repro.serve.net.schema`` maps
them to npz-encoded frames), so the process boundary never invents a
second schema — the multi-host fleet can reuse this contract verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["WIRE_VERSION", "ERROR_CODES", "QueryRequest", "QueryResult",
           "ErrorReply", "ServerInfo", "ServingConfig", "resolve_config"]

# Bumped whenever a frame header or payload field changes incompatibly.
# Client and server exchange it in HELLO / SERVER_INFO and the codec
# rejects mismatched frames with a typed VERSION_MISMATCH error — never by
# misreading bytes.
WIRE_VERSION = 1

# Every refusal the serving plane can express (ErrorReply.code):
#   BAD_REQUEST      — request malformed (series shape, k > k_max, …)
#   BAD_FRAME        — bytes did not decode (magic/CRC/payload)
#   VERSION_MISMATCH — peer speaks a different WIRE_VERSION
#   RETRY_LATER      — admission backpressure: both double buffers full;
#                      retry after ``retry_after_ms``
#   QUOTA_EXCEEDED   — the tenant is at its in-flight admission quota
#   SHUTTING_DOWN    — server draining; no new admissions
#   INTERNAL         — the executor raised; request not served
ERROR_CODES = ("BAD_REQUEST", "BAD_FRAME", "VERSION_MISMATCH",
               "RETRY_LATER", "QUOTA_EXCEEDED", "SHUTTING_DOWN", "INTERNAL")


@dataclasses.dataclass(frozen=True, eq=False)
class QueryRequest:
    """One immutable kNN question.

    ``eq=False`` on purpose: the ndarray field makes structural equality
    ambiguous — compare ``series`` explicitly where it matters.
    """

    series: np.ndarray        # [series_len] float32 raw query series
    k: int = 0                # answer size; 0 = the server/engine default
    tenant: str = ""          # admission-quota identity (fleet shard key)
    request_id: int = 0       # caller-chosen correlation id (echoed back)
    # -- trace context (additive, wire-optional: 0 = absent) --------------
    trace_id: int = 0         # distributed trace this request belongs to
    parent_span_id: int = 0   # caller's span to parent server spans under


@dataclasses.dataclass(frozen=True, eq=False)
class QueryResult:
    """One immutable answer, metrics riding along."""

    request_id: int
    dist: np.ndarray          # [k] ascending squared ED (PAD_DIST pad)
    gid: np.ndarray           # [k] record ids (-1 pad)
    partitions_touched: int = 0
    candidates_scanned: int = 0
    latency_ms: float = 0.0   # server-side arrival → answer wall time
    batch_fill: float = 0.0   # live fraction of the tick that served it
    # -- trace context (additive, wire-optional: 0 = absent) --------------
    trace_id: int = 0         # echo of the request's trace id
    parent_span_id: int = 0   # server span that produced this answer


@dataclasses.dataclass(frozen=True)
class ErrorReply:
    """A typed refusal (see :data:`ERROR_CODES`)."""

    request_id: int
    code: str
    message: str = ""
    retry_after_ms: float = 0.0   # backpressure hint (RETRY_LATER / quota)

    def __post_init__(self):
        if self.code not in ERROR_CODES:
            raise ValueError(f"unknown error code {self.code!r}; "
                             f"expected one of {ERROR_CODES}")


@dataclasses.dataclass(frozen=True)
class ServerInfo:
    """The handshake card: what this server statically is.

    Sent in reply to HELLO so a client can validate requests locally
    (series length, k ceiling) before paying a round trip.
    """

    series_len: int           # required query shape [series_len]
    k_max: int                # static answer-size ceiling
    batch_size: int           # admission batch shape (informational)
    wire_version: int = WIRE_VERSION
    engine: str = ""          # "climber" | "fleet"
    variant: str = ""         # planner variant the engine runs
    routing: str = ""         # fleet routing mode ("" for single-index)
    shards: int = 0           # sealed shard count at handshake time
    max_pending: int = 0      # admission backpressure bound
    tenant_quota: int = 0     # per-tenant in-flight quota (0 = unlimited)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Every engine/server constructor knob, consolidated and documented.

    One frozen dataclass shared by :class:`~repro.serve.ClimberEngine`
    (which reads the batch/plan fields), :class:`~repro.fleet.FleetEngine`
    (adds the routing/maintenance fields) and
    :class:`~repro.serve.net.ClimberServer` (adds the admission fields).
    Engines still accept the individual keyword arguments — those are
    folded into a config — but a config built once can be handed to all
    three layers.

    Batch / planning (ClimberEngine + FleetEngine):

      batch_size        rows per tick — the one static batch shape that
                        jits (fewer live requests are zero-padded).
      k                 default answer size; 0 = the index config's ``k``.
      variant           registered planner name ("knn" | "adaptive" |
                        "od_smallest" | "exhaustive" | user-registered).
      use_kernel        refine backend: True = the fused CUDA kernel
                        (its plain version for a store on the CPU),
                        False = the dense oracle, None = by the store's
                        device (kernel on CUDA, dense on the CPU).
      max_slots         static slot budget for plan compaction; None = the
                        lossless ``default_slot_budget`` (or the index
                        config's ``query_max_slots`` override).
      plan_cache_size   LRU capacity of the per-query plan cache
                        (0 = off; planning then runs every tick).

    Fleet routing / upkeep (FleetEngine):

      routing           "signature" (top-``fanout`` router fan-out),
                        "adaptive" (per-query score-mass fan-out, learned
                        or configured threshold), or "exhaustive"
                        (lossless fallback).
      fanout            shards the router selects per query (the per-query
                        cap under "adaptive" routing); None = the fleet
                        config's default.
      placement         sealed-shard execution: "host", "mesh", or None
                        for the fleet default (mesh when one is attached).
      maintenance_every run lifecycle maintenance after every Nth queue
                        tick (0 = only when called explicitly).
      merge_policy      the LSM :class:`~repro.fleet.lifecycle.merge.
                        MergePolicy` maintenance applies (None = fleet /
                        policy defaults).  Engine-local — never shipped
                        over the wire.

    Network admission (ClimberServer):

      admission_depth   assembled batches the executor queue holds — the
                        double buffer.  2 means the host assembles batch
                        N+1 (and N+2) while the device executes batch N;
                        when all buffers are full new requests get a typed
                        RETRY_LATER reply.
      max_pending       total requests admitted but unanswered (building
                        batch + queued batches + executing batch) before
                        backpressure kicks in.
      tenant_quota      per-tenant in-flight admission cap (0 = off);
                        rejected with QUOTA_EXCEEDED.
      hot_tenant_share  fleet-load guard on top of ``tenant_quota``: when
                        a tenant's share of the fleet's per-shard query
                        load (``FleetStats.per_shard_queries``) exceeds
                        this fraction, its effective quota halves.  1.0
                        disables the guard.
      flush_interval_ms a partially filled admission batch is flushed to
                        the executor after this long, so a trickle of
                        requests never waits for a full batch.

    Observability (any engine; see docs/OBSERVABILITY.md):

      trace_ring        span-ring capacity applied to the process tracer
                        at engine construction (0 = leave the tracer's
                        current capacity — default 4096 — unchanged).
                        Evictions under load are counted on the
                        ``repro_obs_spans_dropped_total`` page metric.
      sentinel_rate     fraction of served queries the online recall
                        sentinel shadow-samples (FleetEngine only; 0 =
                        sentinel off).  Audits run off-path on the
                        maintenance hook; the running mean lands on the
                        ``fleet.online_recall`` gauge.
      sentinel_recalibrate_every
                        re-learn the adaptive-routing threshold from the
                        sentinel's production traces after every N
                        audited queries (0 = record traces only).
    """

    # batch / planning
    batch_size: int = 8
    k: int = 0
    variant: str = "adaptive"
    use_kernel: Optional[bool] = None
    max_slots: Optional[int] = None
    plan_cache_size: int = 256
    # fleet routing / upkeep
    routing: str = "signature"
    fanout: Optional[int] = None
    placement: Optional[str] = None
    maintenance_every: int = 0
    merge_policy: Optional[object] = None
    # network admission
    admission_depth: int = 2
    max_pending: int = 64
    tenant_quota: int = 0
    hot_tenant_share: float = 1.0
    flush_interval_ms: float = 2.0
    # observability
    trace_ring: int = 0
    sentinel_rate: float = 0.0
    sentinel_recalibrate_every: int = 0

    def replace(self, **kw) -> "ServingConfig":
        return dataclasses.replace(self, **kw)


def resolve_config(config: Optional[ServingConfig], kwargs: dict,
                   allowed: Tuple[str, ...]) -> ServingConfig:
    """Fold legacy keyword arguments into one :class:`ServingConfig`.

    ``config`` and individual kwargs are mutually exclusive (no silent
    precedence rules); unknown kwargs fail like a normal bad keyword.
    """
    unknown = [k for k in kwargs if k not in allowed]
    if unknown:
        raise TypeError(f"unexpected keyword argument(s) {unknown}; "
                        f"this engine accepts {sorted(allowed)}")
    if config is not None:
        if kwargs:
            raise TypeError(
                f"pass either config= or individual keyword arguments, "
                f"not both (got config and {sorted(kwargs)})")
        return config
    return ServingConfig(**kwargs)
