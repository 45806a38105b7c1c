"""Batched parity matmul — Chor's XOR fold as an integer product mod 2.

GF(2) identity: the XOR fold of selected records equals the *parity* of an
integer matmul over {0,1} operands:

    out_bits = (mask @ bitplanes) mod 2          mask: [q, n], planes: [n, B]

:func:`parity_matmul` launches the CUDA kernel ``csrc/parity_matmul.cu``
for tensors on the card (it replaces the reference package's TPU kernel
``kernels/parity_matmul.py::_kernel``; on an H100 bound by the planes'
bytes below q ≈ 300 and by the 2·q·n·B operations above). The kernel accumulates in 32-bit integers, exact for every n the wrapper
admits, and writes only the parity bits. :func:`parity_matmul_plain` is
the plain PyTorch version, taken only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check_launch, require, stream_ptr

__all__ = ["parity_matmul", "parity_matmul_plain"]

_PLAIN_CHUNK_N = 1 << 16


def parity_matmul_plain(mask: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a float32 product over chunks of n (each
    chunk's sums stay far below 2^24, so float32 is exact), parities
    XOR-ed across chunks."""
    q, n = mask.shape
    out = torch.zeros((q, planes.shape[1]), dtype=torch.uint8,
                      device=mask.device)
    for lo in range(0, n, _PLAIN_CHUNK_N):
        a = (mask[:, lo : lo + _PLAIN_CHUNK_N] != 0).to(torch.float32)
        b = (planes[lo : lo + _PLAIN_CHUNK_N] != 0).to(torch.float32)
        out ^= torch.remainder(a @ b, 2.0).to(torch.uint8)
    return out


def _as_bits(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.uint8:
        x = (x != 0).to(torch.uint8)
    return x.contiguous()


def parity_matmul(mask: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """mask: [q, n] {0,1}; planes: [n, B] {0,1} -> [q, B] uint8 bits.

    Inputs may be any integer/float/bool dtype holding 0/1; anything but
    uint8 is converted to uint8 first."""
    if mask.dim() != 2 or planes.dim() != 2 or mask.shape[1] != planes.shape[0]:
        raise ValueError(f"shapes disagree: mask {tuple(mask.shape)}, "
                         f"planes {tuple(planes.shape)}")
    if mask.device.type == "cpu":
        return parity_matmul_plain(mask, planes)
    mask, planes = _as_bits(mask), _as_bits(planes)
    require(mask, "mask", torch.uint8, 2, mask.device)
    require(planes, "planes", torch.uint8, 2, mask.device)
    q, n = mask.shape
    b = planes.shape[1]
    if q > 65535 * 64:
        raise ValueError(f"parity_matmul takes at most {65535 * 64} queries")
    out = torch.empty((q, b), dtype=torch.uint8, device=mask.device)
    if q == 0 or b == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(mask.device):
        code = lib.pir_parity_matmul(
            mask.data_ptr(), planes.data_ptr(), out.data_ptr(), q, n, b,
            stream_ptr(mask.device),
        )
    parity_matmul.launches += 1
    check_launch(code, "parity_matmul")
    return out


parity_matmul.launches = 0
