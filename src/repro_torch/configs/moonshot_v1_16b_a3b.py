"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d_model=2048
16H (GQA kv=16) expert d_ff=1408 vocab=163840, MoE 64 experts top-6."""

import dataclasses

from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_shapes import LM_SHAPES

CONFIG = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    moe=True,
    n_experts=64,
    top_k=6,
    dtype="bfloat16",
    loss_chunk=512,
    remat=True,
    full_attention_only=True,  # => long_500k skipped
)

SHAPES = LM_SHAPES


def reduced() -> LMConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=64, vocab=512, n_experts=8, top_k=2, dtype="float32",
        loss_chunk=0, remat=False,
    )
