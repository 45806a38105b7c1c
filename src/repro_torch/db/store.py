"""Record store: the replicated PIR database substrate.

A :class:`RecordStore` holds ``n`` records of a standard size
``record_bits`` (paper §2.1: records of standardized size b bits),
bit-packed into 32-bit words. The store is what every scheme's *server
side* operates on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.db import packing

__all__ = ["RecordStore", "make_synthetic_store"]


@dataclasses.dataclass(frozen=True, eq=False)
class RecordStore:
    """``packed``: [n, W] int32 words (see :mod:`repro_torch.db.packing`
    for why not uint32); ``record_bits``: true record width in bits.

    Frozen: a store is an immutable value; nothing in the port writes
    through ``packed``.
    """

    packed: torch.Tensor
    record_bits: int

    # ---------------------------------------------------------------- basics
    @property
    def n(self) -> int:
        return int(self.packed.shape[0])

    @property
    def words(self) -> int:
        return int(self.packed.shape[1])

    @property
    def nbytes(self) -> int:
        return self.packed.numel() * 4

    @property
    def device(self) -> torch.device:
        return self.packed.device

    # ------------------------------------------------------------ construct
    @classmethod
    def from_bytes(
        cls, raw: np.ndarray, device: DeviceLike = None
    ) -> "RecordStore":
        """[n, nbytes] uint8 host array -> store on ``device``."""
        dev = resolve_device(device)
        raw = np.asarray(raw, dtype=np.uint8)
        packed = packing.pack_bytes_np(raw)
        return cls(
            packed=packing.words_from_numpy(packed, dev),
            record_bits=raw.shape[1] * 8,
        )

    @classmethod
    def from_float_table(cls, table: torch.Tensor) -> "RecordStore":
        """[n, dim] float32 table -> store on the table's device (bit-exact
        transport via bitcast; shares the table's memory)."""
        if table.dim() != 2:
            raise ValueError(f"need a [n, dim] table, got {tuple(table.shape)}")
        return cls(
            packed=packing.bitcast_f32_to_u32(table),
            record_bits=int(table.shape[1]) * 32,
        )

    # -------------------------------------------------------------- readout
    def record_bytes(self, i: int) -> np.ndarray:
        nbytes = -(-self.record_bits // 8)
        row = packing.words_to_numpy(self.packed[i : i + 1])
        return packing.unpack_bytes_np(row, nbytes)[0]

    def as_float_table(self) -> torch.Tensor:
        if self.record_bits % 32:
            raise ValueError("store was not built from a float table")
        return packing.bitcast_u32_to_f32(self.packed)

    def bitplanes(self, dtype: torch.dtype = torch.uint8) -> torch.Tensor:
        """[n, 32*W] {0,1} planes for the parity-matmul server path (the
        view of their bit-major storage: see
        :func:`packing.bitplanes_from_packed`)."""
        return packing.bitplanes_from_packed(self.packed, dtype=dtype)

    # ------------------------------------------------------------- sharding
    def shard_spec(self, record_axis: Optional[str] = "model"):
        """Partition spec sharding the record axis; words replicated."""
        from repro_torch.dist.sharding import P

        return P(record_axis, None)


def make_synthetic_store(
    n: int, record_bytes: int, seed: int = 0, device: DeviceLike = None
) -> RecordStore:
    """Deterministic synthetic database (numpy RNG: the bytes depend on
    ``seed`` only, never on the device)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, record_bytes), dtype=np.uint8)
    return RecordStore.from_bytes(raw, device=dev)
