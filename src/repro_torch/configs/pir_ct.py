"""The paper's own workload: Certificate Transparency-scale PIR.

n = 10^6 records (certificates ≈ 1.5 kB), d = 100 databases, adversary
controls half; Sparse-PIR θ = 0.25 by default (the paper's reference
operating point: ε ≈ 3.6e-15 at d_a = d/2, ≈ 2.2 at d_a = d−1).

:func:`scheme_from_config` / :func:`make_serving_pipeline` build the
repro_torch.serve pipeline straight from a PIRConfig — the one-call path
from "the paper's workload" to a running, budgeted, batch-scheduled
server on the card."""

import dataclasses
import logging

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import PIRConfig, ShapeSpec

log = logging.getLogger(__name__)

CONFIG = PIRConfig(
    name="pir-ct",
    n_records=1_000_000,
    record_bytes=1536,
    d=100,
    d_a=50,
    scheme="sparse",
    theta=0.25,
    u=1000,
    query_batch=1024,
)

# PIR serve-step shape cells
SHAPES = (
    ShapeSpec.make("serve_batch", "pir_serve", query_batch=1024),
    ShapeSpec.make("serve_online", "pir_serve", query_batch=8),
)


def reduced() -> PIRConfig:
    return dataclasses.replace(
        CONFIG, n_records=2048, record_bytes=64, d=4, d_a=2, query_batch=8,
        u=16, heartbeat_timeout_s=0.1, fleet_clients=256,
    )


def scheme_from_config(cfg: PIRConfig = CONFIG):
    """PIRConfig -> scheme (back-compat facade over the staged registry).

    Config parsing is the only place scheme strings are interpreted
    outside the registry (DESIGN.md §Scheme protocol). The whole
    PIRConfig parameter union (θ/p/t/u) is forwarded and the registry
    drops what the named scheme does not declare."""
    from repro_torch.core import make_scheme

    return make_scheme(
        cfg.scheme,
        d=cfg.d,
        d_a=cfg.d_a,
        theta=cfg.theta,
        p=cfg.p or cfg.d,  # default: one request slot per database
        t=cfg.t or None,
        u=cfg.u,
    )


def make_serving_pipeline(
    cfg: PIRConfig = CONFIG, store=None, *, device: DeviceLike = None, **kw
):
    """PIRConfig -> repro_torch.serve.ServingPipeline (synthetic store on
    ``device`` unless one is passed; a live
    :class:`~repro_torch.db.live.VersionedStore` is served through its
    current head). ``device=None`` is the CUDA card.
    ``kw`` forwards to the pipeline (budgets, backend, seed).
    ``cfg.backend`` / ``cfg.fused_vmem_budget_bytes`` configure the
    execution-backend layer unless a ready ``backend=`` instance is
    passed in ``kw``. ``cfg.cache_entries`` is read but the cross-batch
    cache is not ported yet: a positive value is ignored with one logged
    line."""
    from repro_torch.db import make_synthetic_store
    from repro_torch.serve import BatchScheduler, ServingPipeline, ShardedBackend

    dev = resolve_device(device)
    if store is None:
        store = make_synthetic_store(
            cfg.n_records, cfg.record_bytes, seed=0, device=dev
        )
    frozen = store.snapshot() if hasattr(store, "snapshot") else store
    scheme = scheme_from_config(cfg)
    if cfg.cache_entries > 0 and "cache" not in kw:
        log.info(
            "cache_entries=%d ignored: the cross-batch QueryCache is not "
            "ported yet (ROADMAP.md Queue A)", cfg.cache_entries,
        )
    if "backend" not in kw:
        kw["backend"] = ShardedBackend(
            frozen,
            simulate_latency=kw.pop("simulate_latency", None),
            backend=cfg.backend,
            smem_budget_bytes=cfg.fused_vmem_budget_bytes or None,
            device=dev,
        )
    return ServingPipeline(
        store,
        scheme,
        scheduler=BatchScheduler(
            max_batch=cfg.query_batch,
            max_wait_s=cfg.max_wait_ms / 1e3,
            target_latency_s=cfg.target_latency_ms / 1e3,
        ),
        device=dev,
        **kw,
    )
