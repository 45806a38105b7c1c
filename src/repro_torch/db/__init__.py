"""Record store and bit packing (the replicated PIR database substrate),
and the versioned live store over it."""

from repro_torch.db.live import Delta, VersionedStore, rebuild
from repro_torch.db.packing import (
    WORD_BITS,
    pack_bits,
    unpack_bits,
    words_per_record,
)
from repro_torch.db.store import RecordStore, make_synthetic_store

__all__ = [
    "WORD_BITS",
    "Delta",
    "RecordStore",
    "VersionedStore",
    "make_synthetic_store",
    "pack_bits",
    "rebuild",
    "unpack_bits",
    "words_per_record",
]
