"""fm [Rendle ICDM'10]: n_sparse=39 fields, embed_dim=10, pairwise
⟨v_i,v_j⟩x_i x_j via the O(nk) sum-square trick."""

import dataclasses

from repro_torch.configs.base import RecSysConfig
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES

CONFIG = RecSysConfig(
    name="fm",
    model="fm",
    embed_dim=10,
    n_sparse=39,
    vocab_per_field=1_000_000,
    interaction="fm-2way",
)

SHAPES = RECSYS_SHAPES


def reduced() -> RecSysConfig:
    return dataclasses.replace(CONFIG, vocab_per_field=200)
