"""The port's flash-attention plain version and wrapper (CPU) against the
JAX package: its oracle ``ref.flash_attention_ref`` on the reference's own
sweep (tests/test_flash_attention.py), and its Pallas kernel in interpret
mode. Inputs are made with numpy and handed to both packages.

Tolerances are the reference's own (2e-6 in f32, 2e-2 in bf16): the two
packages' CPU sums run in other orders, and these shapes stay inside them.
The CUDA kernel is held to the same plain version on the card in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash
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
    (torch.bfloat16, 256, "flash_fwd_kernel"),
])
def test_bf16_at_head_dims_64_and_128_goes_to_the_tensor_cores(dtype, d,
                                                               kernel):
    # a choice by operand type: the f32 BERT4Rec path and the other head
    # dims stay on the f32 kernel
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
