"""Batched parity matmul — Chor's XOR fold as an integer product mod 2.

GF(2) identity: the XOR fold of selected records equals the *parity* of an
integer matmul over {0,1} operands:

    out_bits = (mask @ bitplanes) mod 2          mask: [q, n], planes: [n, B]

:func:`parity_matmul` (the reference's ``[q, B]`` uint8 bits) and
:func:`parity_matmul_packed` (the same bits packed LSB first into
``[q, ceil(B/32)]`` words, the store's layout, so the parity path needs no
``pack_bits`` after it) launch the CUDA kernel ``csrc/parity_matmul.cu``
for tensors on the card. It replaces the reference package's TPU kernel
``kernels/parity_matmul.py::_kernel``: int8 products on Hopper's tensor
cores (wgmma) accumulated in 32-bit integers, exact for every n the
wrapper admits, with the mod-2 epilogue in the kernel; on an H100 bound by
the planes' bytes below q ≈ 300 and by the 2·q·n·B operations above.

The planes come in either of two layouts, taken as they are: ``[n, B]``
contiguous (the reference's), which the kernel transposes on the way to
the tensor cores, or the ``[n, B]`` view ``.t()`` of a contiguous
``[B, n]`` tensor (what
:func:`repro_torch.db.packing.bitplanes_from_packed` returns and the
serving path holds), which they read as it lies. The plain versions,
taken only for tensors on the CPU, are :func:`parity_matmul_plain` and
:func:`parity_matmul_packed_plain`. On ``meta`` tensors (a dry run) the
wrappers check the operands as for the card and answer with an empty
tensor of the result's shape, building and launching nothing; there and
on the card they report the kernel's cost (:func:`parity_cost`) to an
active count (:mod:`repro_torch._cost`). Any other device raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import _cost
from repro_torch.db import packing
from repro_torch.kernels import _build
from repro_torch.kernels._common import check_launch, kernel_device, stream_ptr

__all__ = [
    "parity_matmul",
    "parity_matmul_packed",
    "parity_matmul_plain",
    "parity_matmul_packed_plain",
    "parity_cost",
]

_PLAIN_CHUNK_N = 1 << 16


def parity_matmul_plain(mask: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a float32 product over chunks of n (each
    chunk's sums stay far below 2^24, so float32 is exact), parities
    XOR-ed across chunks."""
    q, n = mask.shape
    out = torch.zeros((q, planes.shape[1]), dtype=torch.uint8,
                      device=mask.device)
    for lo in range(0, n, _PLAIN_CHUNK_N):
        a = _low_bit(mask[:, lo : lo + _PLAIN_CHUNK_N]).to(torch.float32)
        b = _low_bit(planes[lo : lo + _PLAIN_CHUNK_N]).to(torch.float32)
        out ^= torch.remainder(a @ b, 2.0).to(torch.uint8)
    return out


def _low_bit(x: torch.Tensor) -> torch.Tensor:
    """An operand's parity: ``x & 1`` for an integer dtype (the reference
    reduces the product of the values as they are mod 2, which only their
    low bits decide), nonzero for bool and floating dtypes (0/1 by
    contract)."""
    if x.dtype == torch.bool or x.is_floating_point():
        return x != 0
    return x & 1


def parity_matmul_packed_plain(mask: torch.Tensor,
                               planes: torch.Tensor) -> torch.Tensor:
    """Plain version of the packed form: ``pack_bits`` of the bits."""
    return packing.pack_bits(parity_matmul_plain(mask, planes))


def _as_bits(x: torch.Tensor) -> torch.Tensor:
    """uint8 as it lies (the int32 sums of its products have the parity of
    its low bits'); any other dtype as its low bit (:func:`_low_bit`)."""
    if x.dtype != torch.uint8:
        x = _low_bit(x).to(torch.uint8)
    return x


def _rows_on_16_bytes(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``x`` [rows, cols] uint8 and its row stride in bytes as TMA reads
    it: ``x`` itself where its columns are adjacent and its rows start on
    16-byte boundaries, else a copy into rows padded to a multiple of 16
    (the kernel never reads the padding)."""
    rows, cols = x.shape
    ld = x.stride(0) if rows > 1 else -(-cols // 16) * 16
    if ((cols == 1 or x.stride(1) == 1) and ld >= cols and ld % 16 == 0
            and x.data_ptr() % 16 == 0):
        return x, ld
    ld = -(-cols // 16) * 16
    buf = torch.empty((rows, ld), dtype=torch.uint8, device=x.device)
    buf[:, :cols] = x
    return buf, ld


def _planes_storage(planes: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """The planes as the matrix their bytes lie in, and whether that is
    ``[B, n]`` (n-contiguous: ``planes`` is its ``.t()`` view) rather than
    ``[n, B]``."""
    n, b = planes.shape
    if n > 1 and planes.stride(0) == 1 and (b == 1 or planes.stride(1) != 1):
        return planes.t(), True
    return planes, False


def parity_cost(q: int, n: int, b: int, packed: bool):
    """The kernel's own cost: 2·q·n·B int8 operations, and the uint8 mask
    and planes read once and the output written once (bytes)."""
    out = q * -(-b // packing.WORD_BITS) * 4 if packed else q * b
    return 2.0 * q * n * b, q * n + n * b + out


def _launch(fn, mask: torch.Tensor, planes: torch.Tensor,
            packed: bool) -> torch.Tensor:
    if planes.device != mask.device:
        raise ValueError(f"planes are on {planes.device}, expected "
                         f"{mask.device}")
    if max(*mask.shape, *planes.shape) >= 2**31:
        raise ValueError("an axis beyond the kernel's int range")
    mask, planes = _as_bits(mask), _as_bits(planes)
    storage, k_major = _planes_storage(planes)
    q, n = mask.shape
    b = planes.shape[1]
    dev = mask.device
    dtype = packing.WORD_DTYPE if packed else torch.uint8
    cols = -(-b // packing.WORD_BITS) if packed else b
    if q == 0 or b == 0 or n == 0:
        return torch.zeros((q, cols), dtype=dtype, device=dev)
    if _cost.active():
        _cost.record_kernel(fn.__name__, *parity_cost(q, n, b, packed))
    if dev.type == "meta":
        # answered by shape: nothing is built or launched
        return torch.empty((q, cols), dtype=dtype, device=dev)
    # the uint8 form is written four bit columns a word: rows of a
    # multiple of 4 bytes
    ld_out = cols if packed else -(-b // 4) * 4
    out = torch.empty((q, ld_out), dtype=dtype, device=dev)
    mask_t, ld_mask = _rows_on_16_bytes(mask)
    planes_t, ld_planes = _rows_on_16_bytes(storage)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.pir_parity_matmul(
            mask_t.data_ptr(), ld_mask, planes_t.data_ptr(), ld_planes,
            out.data_ptr(), ld_out, q, n, b, int(packed), int(k_major),
            stream_ptr(dev),
        )
    fn.launches += 1
    check_launch(code, fn.__name__)
    if not packed and ld_out != b:
        return out[:, :b].contiguous()
    return out


def _check_shapes(mask: torch.Tensor, planes: torch.Tensor) -> None:
    if mask.dim() != 2 or planes.dim() != 2 or mask.shape[1] != planes.shape[0]:
        raise ValueError(f"shapes disagree: mask {tuple(mask.shape)}, "
                         f"planes {tuple(planes.shape)}")


def parity_matmul(mask: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """mask: [q, n] {0,1}; planes: [n, B] {0,1} -> [q, B] uint8 bits.

    Inputs may be any integer/float/bool dtype. Integer operands count by
    their values mod 2, as the reference's product of the values mod 2
    does (uint8 reaches the tensor cores as it is, other integers as
    ``x & 1``); bool and float operands hold 0/1 (nonzero -> 1)."""
    _check_shapes(mask, planes)
    if kernel_device(mask, "parity_matmul", meta=True) == "cpu":
        return parity_matmul_plain(mask, planes)
    return _launch(parity_matmul, mask, planes, packed=False)


def parity_matmul_packed(mask: torch.Tensor,
                         planes: torch.Tensor) -> torch.Tensor:
    """mask: [q, n] {0,1}; planes: [n, B] {0,1} -> [q, ceil(B/32)] words
    (``packing.WORD_DTYPE``), bit j of word w = bit column 32·w + j; the
    high bits of a ragged last word are 0. Equal to
    ``pack_bits(parity_matmul(mask, planes))``; the same inputs."""
    _check_shapes(mask, planes)
    if kernel_device(mask, "parity_matmul_packed", meta=True) == "cpu":
        return parity_matmul_packed_plain(mask, planes)
    return _launch(parity_matmul_packed, mask, planes, packed=True)


parity_matmul.launches = 0
parity_matmul_packed.launches = 0
