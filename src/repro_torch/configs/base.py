"""Config dataclasses of the port: the PIR workload's, the LM family's,
the GNN family's and the RecSys family's (field names, defaults and
properties as in the reference package, so one config file can describe
both packages).

Each configuration module under ``repro_torch.configs`` defines ``CONFIG``
(the full-scale config), ``SHAPES`` (its shape cells) and ``reduced()``
(a test-sized config of the same family)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["LMConfig", "GNNConfig", "RecSysConfig", "PIRConfig", "ShapeSpec"]


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
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # gemma-2 style features
    local_global: bool = False        # odd layers local, even layers global
    window: int = 4096
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # misc
    rope_theta: float = 10000.0
    dtype: str = "float32"
    loss_chunk: int = 0               # 0 = unchunked xent
    remat: bool = False
    remat_policy: str = "nothing"     # nothing | dots (save matmul outputs)
    # whether the arch is pure full attention (=> long_500k cell skipped)
    full_attention_only: bool = True
    # PIR integration (DESIGN.md §Arch-applicability; not ported yet)
    private_vocab_lookup: bool = False

    @property
    def params_dense(self) -> int:
        """Parameter count (for MODEL_FLOPS = 6·N·D roofline term)."""
        attn = self.n_layers * self.d_model * self.head_dim * (
            self.n_heads * 2 + self.n_kv_heads * 2
        )
        if self.moe:
            mlp = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
            router = self.n_layers * self.d_model * self.n_experts
            mlp += router
        else:
            mlp = self.n_layers * 3 * self.d_model * self.d_ff
        embed = self.vocab * self.d_model  # tied
        return attn + mlp + embed

    @property
    def params_active(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.params_dense
        attn = self.n_layers * self.d_model * self.head_dim * (
            self.n_heads * 2 + self.n_kv_heads * 2
        )
        mlp = self.n_layers * (
            self.top_k * 3 * self.d_model * self.d_ff
            + self.d_model * self.n_experts
        )
        return attn + mlp + self.vocab * self.d_model


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    n_classes: int
    aggregator: str = "mean"
    norm: str = "sym"
    dtype: str = "float32"
    private_feature_fetch: bool = False


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    model: str                        # dien | fm | dlrm | bert4rec
    embed_dim: int
    n_sparse: int = 0
    n_dense: int = 0
    vocab_per_field: int = 100_000
    interaction: str = "dot"
    # dlrm
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    # dien
    seq_len: int = 0
    gru_dim: int = 0
    mlp_dims: Tuple[int, ...] = ()
    # bert4rec
    n_blocks: int = 0
    n_heads: int = 0
    n_items: int = 0
    dtype: str = "float32"
    # PIR integration: route sparse lookups through a scheme
    # (repro_torch.core.private_embedding)
    private_lookup_scheme: str = "plain"   # plain | chor | sparse | ...
    private_lookup_theta: float = 0.25
    private_lookup_d: int = 4
    private_lookup_da: int = 2


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
    # async ingest front (repro_torch.serve.AsyncFrontend)
    ingest_workers: int = 2
    queue_limit: int = 8192
    # cross-batch cache (repro_torch.serve.QueryCache); 0 = no cache
    cache_entries: int = 4096
    # execution-backend layer (repro_torch.kernels.backend)
    backend: str = "auto"             # registered backend: auto|cuda|ref
    autotune_file: str = ""           # JSON autotune table: loaded at
                                      # start (foreign entries dropped);
                                      # "" = none
    fused_vmem_budget_bytes: int = 0  # fused-kernel shared-memory gate
                                      # override (the name is the reference
                                      # config's); 0 = ask the device
    # fleet harness (repro_torch.fleet)
    heartbeat_timeout_s: float = 30.0
    fleet_clients: int = 10_000
    fleet_zipf_a: float = 1.3
    fleet_repoll_p: float = 0.2
