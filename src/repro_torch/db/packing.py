"""Bit packing for PIR record stores.

PIR over GF(2) operates on raw record bits. Records are padded to a
multiple of 32 bits and packed into 32-bit words ("W words per record").
Two layouts are used by the kernels:

  * packed  : [n, W] words — one row per record (XOR-fold / gather-XOR)
  * bitplane: [n, B] uint8 {0,1} — one column per bit (parity-matmul),
    each column contiguous in memory (the view of a [B, n] tensor)

Word dtype: torch's ``uint32`` lacks XOR, shifts and indexing on some
devices, and XOR is sign-agnostic, so packed words are held as
``torch.int32`` and reinterpreted as unsigned only at the numpy boundary
(``.view(np.uint32)``) and inside the CUDA kernels (``uint32_t*``). The
numpy twins (``*_np``) build stores on the host so a multi-GB database
never round-trips through a device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

WORD_BITS = 32
WORD_DTYPE = torch.int32

__all__ = [
    "WORD_BITS",
    "WORD_DTYPE",
    "words_per_record",
    "pack_bits",
    "unpack_bits",
    "pack_bytes_np",
    "unpack_bytes_np",
    "words_to_numpy",
    "words_from_numpy",
    "bitcast_f32_to_u32",
    "bitcast_u32_to_f32",
    "bitplanes_from_packed",
    "packed_from_bitplanes",
]


def words_per_record(record_bits: int) -> int:
    """Number of 32-bit words needed for a record of ``record_bits`` bits."""
    if record_bits <= 0:
        raise ValueError(f"record_bits must be positive, got {record_bits}")
    return -(-record_bits // WORD_BITS)


def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=WORD_DTYPE, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a [..., B] tensor of {0,1} into [..., ceil(B/32)] words (LSB
    first)."""
    *lead, b = bits.shape
    w = words_per_record(b)
    pad = w * WORD_BITS - b
    if pad:
        bits = torch.cat(
            [bits, bits.new_zeros((*lead, pad))], dim=-1
        )
    bits = bits.reshape(*lead, w, WORD_BITS).to(WORD_DTYPE)
    # each summand is one distinct bit, bit 31 as -2^31: the int64 sum is
    # the word's two's-complement value, so narrowing back is exact
    return (bits << _shifts(bits.device)).sum(dim=-1).to(WORD_DTYPE)


def unpack_bits(
    words: torch.Tensor, num_bits: Optional[int] = None
) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: [..., W] words -> [..., num_bits]
    uint8."""
    *lead, w = words.shape
    # the shift on int32 is arithmetic; the mask drops the sign fill
    bits = (words.unsqueeze(-1) >> _shifts(words.device)) & 1
    bits = bits.reshape(*lead, w * WORD_BITS).to(torch.uint8)
    if num_bits is not None:
        bits = bits[..., :num_bits]
    return bits


def pack_bytes_np(raw: np.ndarray) -> np.ndarray:
    """Host-side: [n, nbytes] uint8 -> [n, W] uint32 (little-endian words)."""
    n, nbytes = raw.shape
    w = words_per_record(nbytes * 8)
    pad = w * 4 - nbytes
    if pad:
        raw = np.concatenate([raw, np.zeros((n, pad), dtype=np.uint8)], axis=1)
    return raw.reshape(n, w, 4).view(np.uint8).copy().view("<u4").reshape(n, w)


def unpack_bytes_np(words: np.ndarray, nbytes: int) -> np.ndarray:
    """Inverse of :func:`pack_bytes_np`."""
    n, w = words.shape
    raw = words.astype("<u4").view(np.uint8).reshape(n, w * 4)
    return raw[:, :nbytes].copy()


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Packed words (int32 tensor, any device) -> uint32 numpy array."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def words_from_numpy(
    words: np.ndarray, device: torch.device
) -> torch.Tensor:
    """uint32 numpy array -> packed int32 tensor on ``device``."""
    arr = np.ascontiguousarray(words, dtype=np.uint32)
    if not arr.flags.writeable:  # torch tensors cannot alias read-only memory
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32)).to(device)


def bitcast_f32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret float32 as 32-bit words (exact bit transport through
    XOR-PIR). The words come back as this package's word dtype, int32 —
    the reference's uint32 bits, held signed (see the module docstring)."""
    if x.dtype != torch.float32:
        raise TypeError(f"bitcast_f32_to_u32 takes float32, got {x.dtype}")
    return x.contiguous().view(WORD_DTYPE)


def bitcast_u32_to_f32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret 32-bit words (int32 here) as float32."""
    if x.dtype != WORD_DTYPE:
        raise TypeError(f"bitcast_u32_to_f32 takes {WORD_DTYPE} words, got {x.dtype}")
    return x.contiguous().view(torch.float32)


# rows unpacked at once by bitplanes_from_packed: bounds the 32-bit
# intermediate of the unpack (rows x W x 32 x 4 bytes)
_PLANES_CHUNK_ROWS = 1 << 15


def bitplanes_from_packed(
    words: torch.Tensor, dtype: torch.dtype = torch.uint8
) -> torch.Tensor:
    """[n, W] words -> [n, 32*W] {0,1} planes for the parity-matmul path.

    uint8 by default: the 0/1 values are what matter, and float32 planes
    of a million 1.5 kB records would be four times the bytes. Stored bit
    column by bit column — a [32*W, n] tensor, each row one bit of every
    record — and returned as its [n, 32*W] view ``.t()``: the layout the
    parity kernel's tensor cores read without a transpose (``contiguous()``
    gives the reference's [n, 32*W] rows). Unpacked in chunks of records
    into the preallocated result."""
    n, w = words.shape
    planes = torch.empty((w * WORD_BITS, n), dtype=dtype,
                         device=words.device).t()
    for lo in range(0, n, _PLANES_CHUNK_ROWS):
        hi = lo + _PLANES_CHUNK_ROWS
        planes[lo:hi] = unpack_bits(words[lo:hi])
    return planes


def packed_from_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """[n, B] {0,1} (any numeric dtype) -> [n, ceil(B/32)] words."""
    return pack_bits(planes.to(torch.uint8))
