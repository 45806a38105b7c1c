"""bert4rec [arXiv:1904.06690]: embed_dim=64, 2 blocks, 2 heads, seq_len=200,
bidirectional masked-item modelling. n_items = 26744 (ML-20M)."""

import dataclasses

from repro_torch.configs.base import RecSysConfig
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES

CONFIG = RecSysConfig(
    name="bert4rec",
    model="bert4rec",
    embed_dim=64,
    n_blocks=2,
    n_heads=2,
    seq_len=200,
    n_items=26744,
    vocab_per_field=26746,  # items + pad + mask
    interaction="bidir-seq",
)

SHAPES = RECSYS_SHAPES


def reduced() -> RecSysConfig:
    return dataclasses.replace(
        CONFIG, seq_len=16, n_items=300, vocab_per_field=302
    )
