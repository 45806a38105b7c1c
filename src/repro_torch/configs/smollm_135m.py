"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M]: llama-arch small dense LM.
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152."""

import dataclasses

from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_shapes import LM_SHAPES

CONFIG = LMConfig(
    name="smollm-135m",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    dtype="bfloat16",
    loss_chunk=512,
    remat=True,
    full_attention_only=True,   # => long_500k skipped (DESIGN.md §4)
)

SHAPES = LM_SHAPES


def reduced() -> LMConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, dtype="float32", loss_chunk=0, remat=False,
    )
