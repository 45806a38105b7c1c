"""The port's flash-attention plain version and wrapper (CPU) against the
JAX package: its oracle ``ref.flash_attention_ref`` on the reference's own
sweep (tests/test_flash_attention.py), and its Pallas kernel in interpret
mode; with a logit softcap and a query offset, which the Pallas kernel
does not have, its model layer ``gqa_attention`` (and so is the
flex_attention call that chip_smoke.py times as the capped sets' library
call). Inputs are made with numpy and handed to both packages.

Tolerances are the reference's own (2e-6 in f32, 2e-2 in bf16): the two
packages' CPU sums run in other orders, and these shapes stay inside them.
The CUDA kernel is held to the same plain version on the card in
tests/test_torch_cuda.py."""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash
from repro.models import layers as RL
from repro_torch.kernels import flash_attention_fwd as exported
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    _kernel_for,
    flash_attention_fwd,
    flash_attention_plain,
)

import _torch_parity  # noqa: F401  (one intra-op thread per worker)

CASES = [
    # (bh, sq, sk, d, causal, window) — the reference's sweep
    (2, 64, 64, 16, True, None),
    (3, 100, 100, 32, True, None),      # ragged vs blocks
    (2, 64, 64, 16, True, 24),          # sliding window (gemma-2 local)
    (1, 128, 128, 64, False, None),     # bidirectional (bert4rec)
    (2, 96, 160, 16, False, None),      # cross lengths
    (1, 257, 129, 8, True, None),       # prime-ish raggedness
]
F32 = dict(rtol=2e-6, atol=2e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _case(bh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal((bh, s, d)).astype(np.float32)
        for s in (sq, sk, sk)
    )


def _torch(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


def _jax(*arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(a, dtype) for a in arrays)


@pytest.mark.parametrize("bh,sq,sk,d,causal,window", CASES)
def test_plain_matches_reference_oracle_f32(bh, sq, sk, d, causal, window):
    arrays = _case(bh, sq, sk, d)
    got = flash_attention_plain(*_torch(*arrays), causal=causal, window=window)
    want = jref.flash_attention_ref(*_jax(*arrays), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("bh,sq,sk,d,causal,window", [CASES[1], CASES[2]])
def test_plain_matches_the_pallas_kernel(bh, sq, sk, d, causal, window):
    arrays = _case(bh, sq, sk, d, seed=1)
    got = flash_attention_fwd(*_torch(*arrays), causal=causal, window=window)
    want = jax_flash(*_jax(*arrays), causal=causal, window=window,
                     block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_plain_bf16_matches_reference_oracle():
    arrays = _case(2, 64, 64, 16)
    got = flash_attention_plain(*_torch(*arrays, dtype=torch.bfloat16))
    want = jref.flash_attention_ref(*_jax(*arrays, dtype=jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), **BF16
    )


@pytest.mark.parametrize("bq,bk", [(16, 64), (64, 16), (128, 128)])
def test_block_sweep_matches_the_pallas_kernel(bq, bk):
    # the port has no tile arguments: every block size of the reference
    # gives the port's one result
    arrays = _case(2, 128, 128, 32, seed=3)
    got = flash_attention_fwd(*_torch(*arrays))
    want = jax_flash(*_jax(*arrays), block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_the_oracle_name_and_the_export_are_the_plain_version_and_wrapper():
    assert ref.flash_attention_ref is flash_attention_plain
    assert exported is flash_attention_fwd


def test_wrapper_on_the_cpu_takes_the_plain_version_and_counts_nothing():
    q, k, v = _torch(*_case(3, 100, 100, 32))
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=True)
    assert flash_attention_fwd.launches == before
    assert torch.equal(got, flash_attention_plain(q, k, v, causal=True))


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, "flash_wgmma_kernel"),
    (torch.bfloat16, 128, "flash_wgmma_kernel"),
    (torch.float32, 64, "flash_fwd_kernel"),
    (torch.float32, 128, "flash_fwd_kernel"),
    (torch.float32, 32, "flash_fwd_kernel"),
    (torch.bfloat16, 8, "flash_fwd_kernel"),
    (torch.bfloat16, 48, "flash_fwd_kernel"),
    (torch.bfloat16, 256, "flash_wgmma_kernel"),   # gemma-2's heads
    (torch.bfloat16, 192, "flash_fwd_kernel"),
    (torch.bfloat16, 255, "flash_fwd_kernel"),
    (torch.float32, 256, "flash_fwd_kernel"),
])
def test_bf16_at_head_dims_64_128_and_256_goes_to_the_tensor_cores(
        dtype, d, kernel):
    # a choice by operand type and head dim: the f32 paths (BERT4Rec, the
    # f32 checks) at every head dim, and bf16 at the head dims that the
    # f32 kernel pads, stay on the f32 kernel
    assert _kernel_for(dtype, d) == kernel


def test_the_per_kernel_counters_stay_still_on_the_cpu():
    q, k, v = _torch(*_case(2, 64, 64, 64), dtype=torch.bfloat16)
    before = dict(flash_attention_fwd.kernel_launches)
    assert set(before) == {"flash_fwd_kernel", "flash_wgmma_kernel"}
    flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.kernel_launches == before


def test_a_window_no_row_can_reach_masks_nothing():
    # the LM's global layers pass window = 1 << 30
    q, k, v = _torch(*_case(2, 64, 64, 16))
    assert torch.equal(flash_attention_fwd(q, k, v, window=1 << 30),
                       flash_attention_fwd(q, k, v))


@pytest.mark.parametrize("bad", [
    dict(window=0),
    dict(window=-3),
    dict(window=-(1 << 31)),
])
def test_wrapper_rejects_bad_arguments(bad):
    q, k, v = _torch(*_case(1, 8, 8, 8))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v, **bad)


def test_wrapper_rejects_mismatched_shapes():
    q, k, v = _torch(*_case(1, 8, 8, 8))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k[:, :, :4], v)
    with pytest.raises(ValueError):
        flash_attention_fwd(q[0], k[0], v[0])


# --------------------------------------------- the f32 kernel's precision
# csrc/flash_attention.cu runs both products on the TF32 tensor cores:
# each f32 operand x as hi = x rounded to TF32 (to nearest, ties away, as
# cvt.rna.tf32.f32 does: add half of the 13 dropped mantissa bits, mask
# them) plus lo = x - hi (exact in f32) truncated to TF32, and every product
# as a_lo b_hi + a_hi b_lo + a_hi b_hi. The products of TF32 values are
# exact in f32, so a float32 matmul of them is what the tensor cores sum.
_TF32_DROP = 0x1FFF  # the 13 mantissa bits TF32 drops


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~_TF32_DROP).view(torch.float32)


def _tf32_split(x: torch.Tensor):
    hi = _tf32_round(x)
    lo = ((x - hi).contiguous().view(torch.int32) & ~_TF32_DROP).view(
        torch.float32)
    return hi, lo


def _tf32_product(a, b, passes):
    """a @ b from TF32 halves: 3 passes (a_lo b_hi + a_hi b_lo + a_hi b_hi),
    2 (b exact in TF32: a_lo b + a_hi b) or 1 (a_hi b_hi)."""
    ah, al = _tf32_split(a)
    bh, bl = _tf32_split(b)
    if passes == 1:
        return ah @ bh
    if passes == 2:
        return al @ b + ah @ b
    return al @ bh + ah @ bl + ah @ bh


def _attention_in_tf32(q, k, v, causal, qk_passes, pv_passes):
    d = q.shape[-1]
    s = _tf32_product(q, k.transpose(1, 2), qk_passes) / math.sqrt(d)
    if causal:
        pos = torch.arange(q.shape[1])
        s = s.masked_fill(pos[None, :] > pos[:, None], -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _tf32_product(p, v, pv_passes) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("bh,s,d,causal,bf16_values", [
    (4, 200, 32, False, False),  # BERT4Rec's heads, f32
    (3, 256, 64, True, False),   # the LM's f32 check
    (3, 256, 48, True, True),    # bf16 operands at a head dim off wgmma's
])
def test_three_tf32_passes_hold_the_f32_tolerance_where_one_does_not(
        bh, s, d, causal, bf16_values):
    """The split the f32 kernel uses holds rtol = atol = 1e-5 against the
    reference's oracle; one TF32 pass (10 mantissa bits) misses it by far.
    For bf16 operands (exact in TF32) the kernel runs Q K^T in one pass and
    P V in two (P's halves): that holds 1e-5 too."""
    rng = np.random.default_rng(s + d)
    arrays = [rng.standard_normal((bh, s, d)).astype(np.float32)
              for _ in range(3)]
    if bf16_values:
        arrays = [torch.from_numpy(a).bfloat16().float().numpy()
                  for a in arrays]
    q, k, v = _torch(*arrays)
    want = np.asarray(jref.flash_attention_ref(*_jax(*arrays), causal=causal))
    tol = dict(rtol=1e-5, atol=1e-5)
    split = (1, 2) if bf16_values else (3, 3)
    got = _attention_in_tf32(q, k, v, causal, *split)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    one_pass = _attention_in_tf32(q, k, v, causal, 1, 1)
    assert not np.allclose(one_pass.numpy(), want, **tol)
    assert np.abs(one_pass.numpy() - want).max() > 10 * np.abs(
        got.numpy() - want).max()


# ------------------------------------- the wgmma kernel's P·V precision
# csrc/flash_attention_wgmma.cu takes bf16 operands: Q K^T is exact bf16
# products summed in f32, the softmax runs in f32, and P·V runs on the
# bf16 tensor cores as hi·V + lo·V with hi = bf16(p) and lo = bf16(p - hi)
# (every bf16 x bf16 product exact in f32); the output is rounded once to
# bf16. Here in float32 matmuls of bf16 values, with the whole row's max in
# place of the online one (the rescaling is exact up to f32 noise).
def _attention_in_wgmma(q, k, v, causal, window, cap, split):
    d = q.shape[-1]
    s = q @ k.transpose(1, 2) / math.sqrt(d)
    if cap:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(q.shape[1])[:, None]
    kpos = torch.arange(k.shape[1])[None, :]
    ok = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = s.masked_fill(~ok, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    o = hi @ v
    if split:
        o = o + (p - hi).bfloat16().float() @ v
    return (o / p.sum(-1, keepdim=True)).bfloat16().float()


@pytest.mark.parametrize("causal,window,cap", [
    (True, None, 50.0),   # gemma-2's global layers
    (True, 1024, 50.0),   # its local layers' window, cut with the length
    (True, None, 0.0),    # capless: the reference's oracle itself
])
def test_p_split_into_bf16_halves_holds_the_bf16_tolerance_at_head_dim_256(
        causal, window, cap):
    """At gemma-2's head dim (2048 tokens, bf16-valued operands) the
    kernel's hi + lo split of P holds the card's bf16 tolerance (rtol 8e-3,
    atol 1e-3: one rounding of the output) against the reference in f32:
    ``flash_attention_ref``, or with a cap its layer's ``gqa_attention``,
    which caps the scaled scores as ``_attn_core`` does. P rounded once to
    bf16, as SDPA and flex_attention take it, misses it."""
    rng = np.random.default_rng(2048 + 256)
    arrays = [torch.from_numpy(rng.standard_normal((1, 2048, 256))
                               .astype(np.float32)).bfloat16().float().numpy()
              for _ in range(3)]
    if cap:
        q, k, v = (jnp.asarray(a.transpose(1, 0, 2))[None] for a in arrays)
        want = RL.gqa_attention(q, k, v, causal=causal, window=window,
                                attn_softcap=cap)
        want = np.asarray(want)[0].transpose(1, 0, 2)
    else:
        want = np.asarray(jref.flash_attention_ref(
            *_jax(*arrays), causal=causal, window=window))
    tol = dict(rtol=8e-3, atol=1e-3)
    got = _attention_in_wgmma(*_torch(*arrays), causal, window, cap, True)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    once = _attention_in_wgmma(*_torch(*arrays), causal, window, cap, False)
    assert not np.allclose(once.numpy(), want, **tol)


def test_the_tf32_rounding_is_to_nearest_ties_away():
    # 1 + 2^-11 is half a TF32 ulp above 1: ties away, up to 1 + 2^-10;
    # just below the half rounds down; hi + lo misses x by less than 2^-22 x
    x = torch.tensor([1 + 2.0**-11, 1 + 2.0**-11 - 2.0**-23, -(1 + 2.0**-11),
                      3.0], dtype=torch.float32)
    hi, lo = _tf32_split(x)
    assert hi.tolist() == [1 + 2.0**-10, 1.0, -(1 + 2.0**-10), 3.0]
    assert ((hi + lo - x).abs() <= 2.0**-22 * x.abs()).all()


# --------------------------------------------- the softcap and the offset
# The reference's Pallas kernel has neither: its models/layers.py
# _attn_core caps the scaled scores before the mask and shifts the query
# positions by q_offset. The plain version is held to the reference's
# gqa_attention (one kv head a query head, [B·H] as the head axis) in f32.
CAP_CASES = [
    # (bh, sq, sk, d, causal, window, softcap, q_offset)
    (2, 64, 64, 16, True, None, 50.0, 0),      # gemma-2's cap, causal
    (2, 64, 64, 16, True, 24, 50.0, 0),        # cap + gemma-2's window
    (1, 48, 48, 32, False, None, 5.0, 0),      # a cap that binds, bidirectional
    (2, 16, 80, 16, True, None, 0.0, 64),      # decode-like: Sq < Sk, offset
    (2, 16, 80, 16, True, 20, 30.0, 64),       # offset + window + cap
    (1, 40, 100, 8, True, 7, 0.0, 13),         # offset leaving keys past the last row
    (1, 40, 30, 8, True, 5, 20.0, 3),          # Sq + offset > Sk: rows the mask empties
    (2, 33, 57, 16, False, None, 0.0, 9),      # non-causal: the offset moves nothing
    (1, 20, 20, 16, False, 6, 10.0, 4),        # window without causal
    (1, 96, 96, 256, True, 40, 50.0, 0),       # gemma-2's head dim, cap, window
]


@pytest.mark.parametrize("bh,sq,sk,d,causal,window,cap,off", CAP_CASES)
def test_plain_with_cap_and_offset_matches_the_reference_layer(
        bh, sq, sk, d, causal, window, cap, off):
    arrays = _case(bh, sq, sk, d, seed=sq + sk)
    got = flash_attention_fwd(*_torch(*arrays), causal=causal, window=window,
                              softcap=cap, q_offset=off)
    # [BH, S, D] -> [1, S, BH, D]: every (batch, head) row a head
    q, k, v = (jnp.asarray(a.transpose(1, 0, 2))[None] for a in arrays)
    want = RL.gqa_attention(q, k, v, causal=causal, window=window,
                            attn_softcap=cap, q_offset=off)
    want = np.asarray(want)[0].transpose(1, 0, 2)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# chip_smoke.py times flex_attention as the library call of the capped
# operand sets; here it runs eagerly and is held to the reference's layer.
# A row that the mask empties (Sq + q_offset > Sk with a window) is left
# out: flex_attention gives it zeros, the reference the mean of its keys
# (masked scores are a finite -1e30); no operand set of the script has one.
@pytest.mark.parametrize("bh,sq,sk,d,causal,window,cap,off", [
    c for c in CAP_CASES if c[6] > 0 and c[1] + c[7] <= c[2]])
def test_chip_smokes_flex_library_computes_the_reference_capped_attention(
        bh, sq, sk, d, causal, window, cap, off):
    arrays = _case(bh, sq, sk, d, seed=sq + sk)
    q4, k4, v4 = (t[None] for t in _torch(*arrays))
    library, _ = _chip_smoke().flex_library(q4, k4, v4, causal, window, cap,
                                            off, compile=False)
    q, k, v = (jnp.asarray(a.transpose(1, 0, 2))[None] for a in arrays)
    want = RL.gqa_attention(q, k, v, causal=causal, window=window,
                            attn_softcap=cap, q_offset=off)
    want = np.asarray(want)[0].transpose(1, 0, 2)
    np.testing.assert_allclose(library()[0].numpy(), want, **F32)


def test_no_cap_and_no_offset_is_the_reference_oracle_bit_for_bit():
    q, k, v = _torch(*_case(2, 64, 64, 16, seed=4))
    for causal, window in ((True, None), (True, 24), (False, None)):
        assert torch.equal(
            flash_attention_plain(q, k, v, causal=causal, window=window,
                                  softcap=0.0, q_offset=0),
            flash_attention_plain(q, k, v, causal=causal, window=window))


def test_the_window_shortcut_counts_the_offset():
    # window >= q_offset + Sq masks nothing; one less masks key 0 for the
    # last row, so the shortcut must not drop it
    q, k, v = _torch(*_case(1, 16, 64, 16, seed=6))
    none = flash_attention_fwd(q, k, v, causal=False, q_offset=40)
    assert torch.equal(
        flash_attention_fwd(q, k, v, causal=False, window=56, q_offset=40),
        none)
    edge = flash_attention_fwd(q, k, v, causal=False, window=55, q_offset=40)
    assert not torch.equal(edge[:, -1], none[:, -1])
    assert torch.equal(edge[:, :-1], none[:, :-1])


@pytest.mark.parametrize("bad", [
    dict(q_offset=-1),
    dict(q_offset=2**31 - 8),
    dict(softcap=-1.0),
    dict(softcap=float("inf")),
    dict(softcap=float("nan")),
])
def test_wrapper_rejects_a_negative_offset_or_cap(bad):
    q, k, v = _torch(*_case(1, 8, 8, 8))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v, **bad)
