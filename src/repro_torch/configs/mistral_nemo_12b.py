"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407]: 40L d_model=5120
32H (GQA kv=8) d_ff=14336 vocab=131072, 128k ctx."""

import dataclasses

from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_shapes import LM_SHAPES

CONFIG = LMConfig(
    name="mistral-nemo-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1_000_000.0,   # 128k-context rope base
    dtype="bfloat16",
    loss_chunk=512,
    remat=True,
    full_attention_only=True,  # => long_500k skipped
)

SHAPES = LM_SHAPES


def reduced() -> LMConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, dtype="float32", loss_chunk=0, remat=False,
    )
