"""Record store and bit packing (the replicated PIR database substrate)."""

from repro_torch.db.packing import (
    WORD_BITS,
    pack_bits,
    unpack_bits,
    words_per_record,
)
from repro_torch.db.store import RecordStore, make_synthetic_store

__all__ = [
    "WORD_BITS",
    "RecordStore",
    "make_synthetic_store",
    "pack_bits",
    "unpack_bits",
    "words_per_record",
]
