"""dien [arXiv:1809.03672]: embed_dim=18, seq_len=100, gru_dim=108,
mlp=200-80, AUGRU interest evolution."""

import dataclasses

from repro_torch.configs.base import RecSysConfig
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES

CONFIG = RecSysConfig(
    name="dien",
    model="dien",
    embed_dim=18,
    seq_len=100,
    gru_dim=108,
    mlp_dims=(200, 80),
    vocab_per_field=1_000_000,     # item vocabulary (the PIR-protected table)
    interaction="augru",
)

SHAPES = RECSYS_SHAPES


def reduced() -> RecSysConfig:
    return dataclasses.replace(
        CONFIG, seq_len=12, gru_dim=24, mlp_dims=(32, 16), vocab_per_field=500
    )
