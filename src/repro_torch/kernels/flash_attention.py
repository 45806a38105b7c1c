"""Flash-attention forward (online softmax) over the ``[B·H, S, D]`` layout.

    out[b] = softmax(mask(cap(q[b] k[b]ᵀ / √D))) v[b]

with masks by absolute position: keys from 0, queries from ``q_offset``
(``qpos = row + q_offset``, at least 0): ``kpos ≤ qpos`` if ``causal``,
``kpos > qpos − window`` if ``window`` is set (gemma-2's local layers;
``window`` is at least 1). ``cap(s) = softcap·tanh(s / softcap)`` when
``softcap > 0`` (gemma-2's logit softcap), the identity at 0; it comes
before the mask, as in the reference's ``_attn_core``. Scores, the cap,
the softmax and the products run in f32 whatever the input type (float32
or bfloat16); the result comes back in q's type. Masked scores take the
finite ``NEG_INF``.

:func:`flash_attention_fwd` launches one of two hand-written CUDA kernels
for tensors on the card, chosen by operand type and head dim
(:func:`_kernel_for`): bfloat16 at a head dim of 64, 128 or 256 (gemma-2's)
goes to ``csrc/flash_attention_wgmma.cu`` (Hopper's tensor cores: wgmma
fed by TMA; P·V as hi + lo bf16 halves of P, so P keeps about 16 mantissa
bits), everything else (float32 at every head dim, bfloat16 at the other
head dims up to 256, which that kernel pads) to
``csrc/flash_attention.cu`` (the TF32 tensor cores through ``mma.sync``,
each f32 operand split into TF32 hi + lo halves and each product taken in
three passes: f32 accuracy). Both take
the softcap and the query offset. Both replace the reference package's
TPU kernel ``kernels/flash_attention.py::_kernel`` (which has neither: the
reference applies them in ``models/layers.py::_attn_core``); the
function is bound by operations, 4·d flops per unmasked (q, k) pair (the
cap adds one tanh a pair). It takes
:func:`flash_attention_plain` only for tensors on the CPU. The kernels
zero-fill the ragged edges of Sq and Sk in their tiles, as the reference
zero-pads them, and give the padded keys −inf: a row that the mask
empties (Sq > Sk with a window) averages its Sk keys, as the plain
version does. GQA's broadcast of K/V over the query heads happens in
:func:`repro_torch.models.layers.gqa_attention`.

On ``meta`` tensors (a dry run) :func:`flash_attention_fwd` checks the
operands as for the card and returns an empty result, building and
launching nothing; there and on the card it reports the kernel's cost
(:func:`flash_cost`) to an active count (:mod:`repro_torch._cost`). Any
other device raises.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch import _cost
from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    check_launch, kernel_device, require, stream_ptr,
)

__all__ = ["flash_attention_fwd", "flash_attention_plain", "attention_pairs",
           "flash_cost"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128, 256)
# the two kernels by their CUDA names (what a profiler shows), with the
# q rows of one block of each
TF32_KERNEL, WGMMA_KERNEL = "flash_fwd_kernel", "flash_wgmma_kernel"
TILE_Q = {TF32_KERNEL: 64, WGMMA_KERNEL: 128}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel_for(dtype: torch.dtype, d: int) -> str:
    """Which kernel takes operands of this type and head dim: bfloat16 at
    d = 64, 128 or 256 goes to wgmma (``flash_attention_wgmma.cu``),
    everything else (float32 at every d, bfloat16 at the other d) to
    mma.sync in 3xTF32 (``flash_attention.cu``). A choice by operand type
    and head dim, not a fallback: either kernel raises when it fails, and
    an operand the wgmma kernel refuses (off 16 bytes) is refused."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return WGMMA_KERNEL
    return TF32_KERNEL


def _check_args(q, k, v, window, softcap, q_offset) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(
            f"need q [BH, Sq, D] and k, v [BH, Sk, D], got {tuple(q.shape)}, "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if not (math.isfinite(softcap) and softcap >= 0.0):
        raise ValueError(f"softcap must be finite and at least 0, got {softcap}")
    # a negative offset (queries before the first key) is refused, where
    # the reference's gqa_attention takes it: no caller of the port has one
    if q_offset < 0 or q_offset + q.shape[1] >= 2**31:
        raise ValueError(f"q_offset must be in [0, 2**31 - Sq), got {q_offset}")


def attention_pairs(sq: int, sk: int, causal: bool, window: Optional[int],
                    q_offset: int = 0) -> int:
    """Unmasked (query, key) pairs of one attention row (keys from 0,
    queries from ``q_offset``), the causal mask and the window honoured.
    In numpy: host arithmetic that a count of the run's torch ops must not
    see."""
    qpos = np.arange(sq, dtype=np.int64) + int(q_offset)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk, np.int64)
    lo = (np.clip(qpos - int(window) + 1, 0, sk) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.maximum(hi - lo, 0).sum())


def flash_cost(bh: int, sq: int, sk: int, d: int, elem: int, causal: bool,
               window: Optional[int], q_offset: int = 0):
    """The kernel's own cost: 4·d flops a unmasked pair, and Q, K, V read
    once and O written once (bytes of ``elem`` each)."""
    flops = 4.0 * bh * attention_pairs(sq, sk, causal, window, q_offset) * d
    return flops, bh * (2 * sq + 2 * sk) * d * elem


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
    softcap: float = 0.0, q_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version (the reference's oracle ``flash_attention_ref``,
    with the cap and the offset of its ``_attn_core``): einsum, cap, mask,
    softmax, einsum, all in f32; the [BH, Sq, Sk] scores are
    materialised."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    s = s / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(q.shape[1], device=q.device)[:, None] + int(q_offset)
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_fwd(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BH, Sk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    """q: [BH, Sq, D]; k, v: [BH, Sk, D], float32 or bfloat16 -> [BH, Sq, D]
    in q's dtype. ``softcap`` ≥ 0 (0: none) and ``q_offset`` ≥ 0 as in the
    module's docstring; a negative value of either raises ``ValueError``.

    The reference's ``block_q``/``block_k`` tuning arguments have no
    counterpart: each CUDA kernel's tiles are fixed by its register and
    shared-memory layout (``TILE_Q`` q rows a block). ``launches`` counts
    every launch, ``kernel_launches`` each kernel's."""
    softcap, q_offset = float(softcap), int(q_offset)
    _check_args(q, k, v, window, softcap, q_offset)
    if kernel_device(q, "flash_attention_fwd", meta=True) == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset)
    dev = q.device
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        require(t, name, q.dtype, 3, dev)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    if sk == 0 or d == 0:
        raise ValueError("flash_attention_fwd needs at least one key and one column")
    kernel = _kernel_for(q.dtype, d)
    if bh * math.ceil(sq / TILE_Q[kernel]) >= 2**31:
        raise ValueError("flash_attention_fwd: more than 2**31 - 1 blocks")
    if kernel == WGMMA_KERNEL and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: the TMA loads of bf16 "
                         "operands need 16-byte aligned tensors")
    # a window that no row can reach masks nothing (the global window of
    # the LM is 1 << 30): the last row's position is q_offset + sq - 1, so
    # key 0 is inside every row's window when window >= q_offset + sq; the
    # kernels take -1 for none
    win = (-1 if window is None or int(window) >= q_offset + sq
           else int(window))
    if _cost.active():
        _cost.record_kernel(kernel, *flash_cost(
            bh, sq, sk, d, q.element_size(), causal,
            None if win < 0 else win, q_offset))
    if dev.type == "meta":
        # answered by shape: nothing is built or launched
        return out
    lib = _build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, sq, sk, d, int(bool(causal)), win, q_offset, softcap)
    with torch.cuda.device(dev):
        if kernel == WGMMA_KERNEL:
            code = lib.pir_flash_attention_wgmma(*args, stream_ptr(dev))
        else:
            code = lib.pir_flash_attention_fwd(
                *args, _DTYPE_CODES[q.dtype], stream_ptr(dev))
    flash_attention_fwd.launches += 1
    flash_attention_fwd.kernel_launches[kernel] += 1
    check_launch(code, f"flash_attention_fwd ({kernel})")
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.kernel_launches = {TF32_KERNEL: 0, WGMMA_KERNEL: 0}
