"""The PIR workload's config dataclass (field names as in the reference
package, so one config file can describe both packages)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["PIRConfig", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell of a configuration."""

    name: str
    kind: str
    params: Tuple[Tuple[str, int], ...]  # hashable dict

    def p(self) -> Dict[str, int]:
        return dict(self.params)

    @staticmethod
    def make(name: str, kind: str, **params: int) -> "ShapeSpec":
        return ShapeSpec(name=name, kind=kind, params=tuple(sorted(params.items())))


@dataclasses.dataclass(frozen=True)
class PIRConfig:
    """The paper's own workload (Certificate Transparency reference)."""

    name: str
    n_records: int
    record_bytes: int
    d: int
    d_a: int
    scheme: str = "sparse"
    theta: float = 0.25
    p: int = 0
    t: int = 0
    u: int = 1000
    query_batch: int = 1024
    # serving-pipeline knobs (repro_torch.serve.BatchScheduler)
    max_wait_ms: float = 5.0          # deadline before a partial batch cuts
    target_latency_ms: float = 50.0   # adaptive batch-size target
    # async ingest front (not ported yet; carried for config compatibility)
    ingest_workers: int = 2
    queue_limit: int = 8192
    # cross-batch cache (not ported yet: read, and ignored with a log line)
    cache_entries: int = 4096
    # execution-backend layer (repro_torch.kernels.backend)
    backend: str = "auto"             # registered backend: auto|cuda|ref
    autotune_file: str = ""           # not ported yet; carried
    fused_vmem_budget_bytes: int = 0  # fused-kernel shared-memory gate
                                      # override (the name is the reference
                                      # config's); 0 = ask the device
    # fleet harness (not ported yet; carried)
    heartbeat_timeout_s: float = 30.0
    fleet_clients: int = 10_000
    fleet_zipf_a: float = 1.3
    fleet_repoll_p: float = 0.2
