"""dlrm-rm2 [arXiv:1906.00091]: n_dense=13 n_sparse=26 embed_dim=64
bot_mlp=13-512-256-64 top_mlp=512-512-256-1, dot interaction."""

import dataclasses

from repro_torch.configs.base import RecSysConfig
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES

CONFIG = RecSysConfig(
    name="dlrm-rm2",
    model="dlrm",
    embed_dim=64,
    n_sparse=26,
    n_dense=13,
    vocab_per_field=1_000_000,
    bot_mlp=(512, 256, 64),
    top_mlp=(512, 512, 256, 1),
    interaction="dot",
)

SHAPES = RECSYS_SHAPES


def reduced() -> RecSysConfig:
    # bot_mlp[-1] must equal embed_dim (dot-interaction dimension contract)
    return dataclasses.replace(
        CONFIG, vocab_per_field=300, embed_dim=16,
        bot_mlp=(32, 16), top_mlp=(32, 16, 1),
    )
