"""Index fleet on the card — sharded multi-index serving with streaming
ingest (the port of ``repro.fleet``)."""
from repro_torch.fleet.fleet import (DeltaShard, FleetConfig, FleetDraws,
                                     FleetQueryInfo, FleetStats, IndexFleet,
                                     ShardHandle)
from repro_torch.fleet.placement import MeshFleetPlacement
from repro_torch.fleet.router import SignatureRouter
from repro_torch.fleet.engine import FleetEngine
from repro_torch.fleet.lifecycle import (CompactionTicket, MergePolicy,
                                         WriteAheadLog)

__all__ = ["IndexFleet", "FleetConfig", "FleetStats", "FleetQueryInfo",
           "ShardHandle", "DeltaShard", "FleetDraws", "SignatureRouter",
           "FleetEngine", "MeshFleetPlacement", "CompactionTicket",
           "MergePolicy", "WriteAheadLog"]
