"""gemma2-2b [arXiv:2408.00118]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local(4096)/global alternating attention, logit softcaps.
Hybrid local/global => the long_500k cell RUNS for this arch."""

import dataclasses

from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_shapes import LM_SHAPES

CONFIG = LMConfig(
    name="gemma2-2b",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    local_global=True,
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    dtype="bfloat16",
    loss_chunk=512,
    remat=True,
    full_attention_only=False,
)

SHAPES = LM_SHAPES


def reduced() -> LMConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, window=8, dtype="float32", loss_chunk=0,
        remat=False,
    )
