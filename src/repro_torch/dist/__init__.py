"""Distribution of the port: for now only the single-device forms of the
reference's vocab-sharded lookups (the mesh forms wait for ROADMAP.md
Queue A item 11)."""

from repro_torch.dist.collectives import sharded_table_lookup, sharded_vocab_lookup

__all__ = ["sharded_table_lookup", "sharded_vocab_lookup"]
