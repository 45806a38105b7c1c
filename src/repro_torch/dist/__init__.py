"""Distribution of the port: the single-device forms of the reference's
vocab-sharded lookups (the mesh forms wait for ROADMAP.md Queue A item 11)
and the fault-tolerance plans (heartbeats, the elastic remesh plan, and
what replica loss does to privacy)."""

from repro_torch.dist.collectives import sharded_table_lookup, sharded_vocab_lookup
from repro_torch.dist.fault import (
    FleetState,
    HeartbeatMonitor,
    RemeshPlan,
    pir_degraded_privacy,
    plan_elastic_remesh,
    scheme_degradation,
)

__all__ = [
    "FleetState",
    "HeartbeatMonitor",
    "RemeshPlan",
    "pir_degraded_privacy",
    "plan_elastic_remesh",
    "scheme_degradation",
    "sharded_table_lookup",
    "sharded_vocab_lookup",
]
