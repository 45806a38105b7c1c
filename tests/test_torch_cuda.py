"""The CUDA kernels of repro_torch against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and ``nvcc``; on a host
without them the ``cuda_device`` fixture skips. Run on a GPU host with

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.db import make_synthetic_store
from repro_torch.kernels import ops
from repro_torch.kernels.fused import fused_gather_fold, fused_gather_fold_plain
from repro_torch.kernels.gather_xor import (
    gather_xor,
    gather_xor_plain,
    indices_from_mask,
)
from repro_torch.kernels.parity_matmul import parity_matmul, parity_matmul_plain
from repro_torch.kernels.xor_fold import xor_fold, xor_fold_plain

pytestmark = pytest.mark.cuda

SHAPES = [
    # (n records, record_bytes, q queries)
    (64, 8, 1),
    (100, 12, 5),
    (256, 64, 16),
    (300, 50, 17),
    (1024, 4, 33),
    (37, 129, 3),
    (1, 8, 1),
    (7, 129, 1),
    (5000, 1536, 8),
    (4099, 1532, 9),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(n, rb, q, device, seed=0, p=0.4):
    store = make_synthetic_store(n, rb, seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    mask = torch.from_numpy((rng.random((q, n)) < p).astype(np.uint8))
    return store, mask.to(device)


def _same(a, b):
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,rb,q", SHAPES)
def test_xor_fold_kernel_equals_plain(cuda_device, n, rb, q):
    store, mask = _case(n, rb, q, cuda_device)
    before = xor_fold.launches
    got = xor_fold(store.packed, mask)
    assert xor_fold.launches == before + 1
    _same(got, xor_fold_plain(store.packed, mask))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.bool])
def test_xor_fold_kernel_mask_dtypes(cuda_device, dtype):
    store, mask = _case(128, 16, 7, cuda_device)
    _same(xor_fold(store.packed, mask.to(dtype)),
          xor_fold_plain(store.packed, mask))


@pytest.mark.parametrize("n,rb,q", SHAPES)
@pytest.mark.parametrize("grid_order", ["qwm", "wqm"])
@pytest.mark.parametrize("block_w", [8, 30, 128, 512])
def test_gather_xor_kernel_equals_plain(cuda_device, n, rb, q, grid_order,
                                        block_w):
    store, mask = _case(n, rb, q, cuda_device)
    idx = indices_from_mask(mask, min(n, 2100))
    got = gather_xor(store.packed, idx, block_w=block_w,
                     grid_order=grid_order)
    _same(got, gather_xor_plain(store.packed, idx))


@pytest.mark.parametrize("n,rb,q", [s for s in SHAPES if s[0] <= 1024])
@pytest.mark.parametrize("grid_order", ["qw", "wq"])
@pytest.mark.parametrize("block_w", [8, 32, 128])
def test_fused_kernel_equals_plain(cuda_device, n, rb, q, grid_order, block_w):
    store, mask = _case(n, rb, q, cuda_device)
    idx = indices_from_mask(mask, n)
    bw = min(block_w, 232_448 // (4 * n))
    got = fused_gather_fold(store.packed, idx, block_w=bw,
                            grid_order=grid_order)
    _same(got, fused_gather_fold_plain(store.packed, idx))
    _same(got, xor_fold(store.packed, mask))


def test_fused_kernel_refuses_oversized_slab(cuda_device):
    store, mask = _case(100_000, 16, 2, cuda_device, p=0.01)
    idx = indices_from_mask(mask, 2000)
    with pytest.raises(ValueError, match="shared"):
        fused_gather_fold(store.packed, idx, block_w=4)


def test_all_padding_rows_answer_zero(cuda_device):
    store, _ = _case(64, 8, 2, cuda_device)
    idx = torch.full((2, 16), -1, dtype=torch.int32, device=cuda_device)
    for got in (gather_xor(store.packed, idx),
                fused_gather_fold(store.packed, idx)):
        torch.cuda.synchronize()
        assert int(got.abs().sum()) == 0


@pytest.mark.parametrize("n,rb,q", SHAPES[:8] + [(3000, 96, 70)])
def test_parity_matmul_kernel_equals_plain(cuda_device, n, rb, q):
    store, mask = _case(n, rb, q, cuda_device)
    planes = store.bitplanes()
    got = parity_matmul(mask, planes)
    _same(got, parity_matmul_plain(mask, planes))
    _same(ops.server_answer_parity(planes, mask), xor_fold(store.packed, mask))


def test_server_paths_agree_on_the_card(cuda_device):
    store, mask = _case(2222, 36, 13, cuda_device, p=0.2)
    fold = ops.server_answer_fold(store.packed, mask)
    _same(fold, ops.server_answer_parity(store.bitplanes(), mask))
    _same(fold, ops.server_answer_sparse(store.packed, mask, theta=0.2))


def test_device_fingerprint_names_the_card(cuda_device):
    from repro_torch._device import device_fingerprint

    assert device_fingerprint() == {
        "platform": "cuda", "device_kind": torch.cuda.get_device_name(0)}


@pytest.mark.parametrize("scheme,kernel", [("sparse", fused_gather_fold),
                                           ("chor", xor_fold)])
def test_reduced_pipeline_on_the_card_by_default(cuda_device, scheme, kernel):
    """``device=None`` is the card: the answers are exact and the path
    went through the CUDA kernel, once per server."""
    import dataclasses

    from repro_torch.configs import pir_ct

    cfg = dataclasses.replace(pir_ct.reduced(), scheme=scheme)
    pipe = pir_ct.make_serving_pipeline(cfg, seed=1)
    assert pipe.device.type == "cuda" and pipe.backend.backend_name == "auto"
    before = kernel.launches
    for c, i in enumerate((0, 5, cfg.n_records - 1)):
        assert pipe.submit(f"c{c}", i)
    out = pipe.flush()
    assert kernel.launches == before + cfg.d
    for c, i in enumerate((0, 5, cfg.n_records - 1)):
        assert (out[f"c{c}"] == pipe.store.record_bytes(i)).all()
