"""kimi-k2-1t-a32b [arXiv:2501.kimi2; paper-table]: 61L d_model=7168 64H
(GQA kv=8) expert d_ff=2048 vocab=163840, MoE 384 experts top-8 —
trillion-parameter MoE. Trains with Adafactor + full FSDP (optimizer-state
memory; see DESIGN.md §5 / EXPERIMENTS.md §Dry-run)."""

import dataclasses

from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_shapes import LM_SHAPES

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab=163840,
    moe=True,
    n_experts=384,
    top_k=8,
    dtype="bfloat16",
    loss_chunk=512,
    remat=True,
    full_attention_only=True,  # => long_500k skipped
)

SHAPES = LM_SHAPES


def reduced() -> LMConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=64, vocab=512, n_experts=8, top_k=2, dtype="float32",
        loss_chunk=0, remat=False,
    )
