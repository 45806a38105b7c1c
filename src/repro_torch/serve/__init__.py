"""repro_torch.serve — the batch-scheduled PIR serving subsystem.

queue → router → backend: ``BatchScheduler`` decides when/how big batches
are, ``SchemeRouter`` drives the configured scheme's staged protocol
(DESIGN.md §Scheme protocol) to turn a batch into per-server payloads,
``ShardedBackend`` runs the answer stage with the CUDA kernels on one
device. ``ServingPipeline`` composes the three and enforces per-client
(ε, δ) budgets; ``PIRServingEngine`` is the back-compat facade.
"""

from repro_torch.serve.engine import PIRServingEngine, PlannedBatch, ServingPipeline
from repro_torch.serve.router import RoutedBatch, SchemeRouter
from repro_torch.serve.scheduler import BatchScheduler, Request, bucket_size
from repro_torch.serve.sharded import ServerStats, ShardedBackend

__all__ = [
    "BatchScheduler",
    "PIRServingEngine",
    "PlannedBatch",
    "Request",
    "RoutedBatch",
    "SchemeRouter",
    "ServerStats",
    "ServingPipeline",
    "ShardedBackend",
    "bucket_size",
]
