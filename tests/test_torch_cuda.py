"""The CUDA kernels of repro_torch against their plain PyTorch versions,
on the card, and the paths that run them. Every test here needs a CUDA device and ``nvcc``; on a host
without them the ``cuda_device`` fixture skips. Run on a GPU host with

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.db import make_synthetic_store
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    _kernel_for,
    flash_attention_fwd,
    flash_attention_plain,
)
from repro_torch.kernels.fused import (
    STAGINGS,
    _launch as fused_launch,
    fused_gather_fold,
    fused_gather_fold_plain,
    fused_multi_gather_fold,
    fused_multi_gather_fold_plain,
    fused_schedule,
    fused_smem_budget,
)
from repro_torch.kernels.gather_xor import (
    gather_xor,
    gather_xor_plain,
    indices_from_mask,
    indices_from_mask_plain,
)
from repro_torch.kernels.parity_matmul import (
    parity_matmul,
    parity_matmul_packed,
    parity_matmul_packed_plain,
    parity_matmul_plain,
)
from repro_torch.kernels.scatter import scatter_rows, scatter_rows_plain
from repro_torch.kernels.sparse_masks import sparse_masks, sparse_masks_plain
from repro_torch.kernels.xor_fold import (
    STREAM,
    TABLE,
    TABLE_WIDTHS,
    _form_for,
    _launch,
    xor_fold,
    xor_fold_plain,
)

from _torch_parity import messy_index_rows

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


def _fold_operands(q, n, w, device, density=0.5, seed=0):
    """Random words [n, w] and a [q, n] uint8 mask whose selecting bytes
    take values 1-255 (any non-zero value selects)."""
    rng = np.random.default_rng(seed)
    db = torch.from_numpy(rng.integers(-2**31, 2**31, (n, w),
                                       dtype=np.int64).astype(np.int32))
    sel = rng.random((q, n)) < density
    mask = np.where(sel, rng.integers(1, 256, (q, n)), 0).astype(np.uint8)
    return db.to(device), torch.from_numpy(mask).to(device)


def _fold_plain(db, mask, step=64):
    """xor_fold_plain a few queries at a time (its [q, rows, W] selection
    stays small at q 1000, W 385)."""
    return torch.cat([xor_fold_plain(db, mask[i:i + step])
                      for i in range(0, mask.shape[0], step)])


def _every_form(db, mask, want):
    """Each form forced (the table form at each of its warp widths), and
    the wrapper's own choice, bit for bit against ``want``, each counted
    once under its form."""
    for form, width in [(STREAM, None)] + [(TABLE, w) for w in TABLE_WIDTHS]:
        before = xor_fold.kernel_launches[form]
        _same(_launch(db, mask, form, width), want)
        assert xor_fold.kernel_launches[form] == before + 1
    chosen = _form_for(mask.shape[0])
    before = dict(xor_fold.kernel_launches)
    _same(xor_fold(db, mask), want)
    assert xor_fold.kernel_launches == {
        f: c + (f == chosen) for f, c in before.items()}


@pytest.mark.parametrize("q", [1, 8, 9, 33, 128, 257, 1000])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 1000, 4099])
@pytest.mark.parametrize("w", [1, 3, 16, 64, 385])
def test_xor_fold_every_form_equals_plain(cuda_device, q, n, w):
    """Ragged q (a partial warp, query group, 8-query tile), n (a partial
    4-row table, 32-row stage) and W (odd: one word a lane; even: two)."""
    db, mask = _fold_operands(q, n, w, cuda_device, seed=q * 7919 + n + w)
    _every_form(db, mask, _fold_plain(db, mask))


@pytest.mark.parametrize("density", [0.0, 0.2, 0.5, 1.0])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.bool])
@pytest.mark.parametrize("q,n,w", [(8, 4099, 385), (128, 4099, 64),
                                   (257, 1000, 3)])
def test_xor_fold_forms_on_every_density_and_mask_type(cuda_device, density,
                                                       dtype, q, n, w):
    db, mask = _fold_operands(q, n, w, cuda_device, density=density)
    want = _fold_plain(db, mask)
    if density == 0.0:
        assert int(want.abs().sum()) == 0
    _every_form(db, mask.to(dtype), want)


def test_xor_fold_atomic_combine_gives_the_same_bytes_every_run(cuda_device):
    """Many row chunks per output word, combined by atomicXor in whatever
    order the blocks finish: the same bytes on every run, in both forms."""
    db, mask = _fold_operands(300, 100_000, 64, cuda_device)
    want = _fold_plain(db, mask)
    for form, width in [(STREAM, None)] + [(TABLE, w) for w in TABLE_WIDTHS]:
        first = _launch(db, mask, form, width)
        for _ in range(4):
            _same(_launch(db, mask, form, width), first)
        _same(first, want)


def test_xor_fold_forms_refuse_what_they_do_not_take(cuda_device):
    db, mask = _fold_operands(4, 64, 8, cuda_device)
    with pytest.raises(ValueError, match="unknown xor_fold form"):
        _launch(db, mask, "dense")
    with pytest.raises(ValueError, match="queries a warp"):
        _launch(db, mask, "table", 16)
    with pytest.raises(ValueError, match="mask is on cpu"):
        _launch(db, mask.cpu(), "table")
    with pytest.raises(TypeError):
        _launch(db.to(torch.int64), mask, "stream")


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


GATHER_CASES = [
    # (n, record_bytes, q): W a multiple of 4 or not; 1, 8 (one group of
    # 8), 9-32 (one group of 32) and 70 queries (three groups)
    (5000, 1536, 8), (4099, 1532, 9), (3000, 96, 1), (2500, 52, 32),
    (777, 12, 70), (20_000, 64, 8),
]


def _gather_idx(store, q, kind, device, seed):
    """Ascending ids (the compaction of a θ = 0.25 mask, with -1 after
    them), or rows that are not ascending; half of them ascending beside
    half shuffled in ``mixed``."""
    n = store.n
    m = min(n, int(0.3 * n) + 8)
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy((rng.random((q, n)) < 0.25).astype(np.uint8))
    asc = indices_from_mask(mask.to(device), m)
    if kind == "ascending":
        return asc
    if kind == "mixed":
        mess = torch.from_numpy(messy_index_rows(rng, n, q, m, "shuffled"))
        rows = torch.arange(q, device=device)[:, None] % 2 == 1
        return torch.where(rows, mess.to(device), asc).contiguous()
    return torch.from_numpy(messy_index_rows(rng, n, q, m, kind)).to(device)


@pytest.mark.parametrize("n,rb,q", GATHER_CASES)
@pytest.mark.parametrize("kind", ["ascending", "shuffled", "duplicated",
                                  "padded", "mixed"])
@pytest.mark.parametrize("grid_order", ["qwm", "wqm"])
@pytest.mark.parametrize("block_w", [8, 32, 128])
def test_gather_xor_kernel_on_every_id_order(cuda_device, n, rb, q, kind,
                                             grid_order, block_w):
    """The range blocks (ascending rows) and the walk blocks (any other
    row) against the plain version, in one launch."""
    store, _ = _case(n, rb, 1, cuda_device, seed=n + q)
    idx = _gather_idx(store, q, kind, cuda_device, seed=q)
    launches = gather_xor.launches
    got = gather_xor(store.packed, idx, block_w=block_w,
                     grid_order=grid_order)
    assert gather_xor.launches == launches + 1
    _same(got, gather_xor_plain(store.packed, idx))


def test_gather_xor_kernel_ids_outside_the_store_are_skipped(cuda_device):
    """Ids >= n lie outside the contract; the kernel never reads them, in
    an ascending row (their tail) or any other."""
    store, _ = _case(1000, 64, 1, cuda_device)
    idx = torch.tensor([[3, 9, 500, 999, 1000, 5000, -1, -1],
                        [3, 1000, 9, -1, 500, 2**31 - 1, 999, 9]],
                       dtype=torch.int32, device=cuda_device)
    live = torch.where(idx < 1000, idx, -1)
    _same(gather_xor(store.packed, idx), gather_xor_plain(store.packed, live))


@pytest.mark.parametrize("kind", ["ascending", "mixed"])
def test_gather_xor_atomic_combine_gives_the_same_bytes_every_run(
        cuda_device, kind):
    store, _ = _case(50_000, 1536, 1, cuda_device, seed=2)
    idx = _gather_idx(store, 8, kind, cuda_device, seed=3)
    first = gather_xor(store.packed, idx)
    for _ in range(3):
        _same(gather_xor(store.packed, idx), first)
    for go in ("qwm", "wqm"):
        for bw in (8, 32, 128):
            _same(gather_xor(store.packed, idx, block_w=bw, grid_order=go),
                  first)


@pytest.mark.parametrize("n", [8191, 8192, 8193, 3 * 8192 - 5, 3 * 8192,
                               3 * 8192 + 17, 100_003])
@pytest.mark.parametrize("m_frac", [1.0, 0.3, 0.1, 0.01])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bool, torch.int32])
def test_indices_from_mask_kernel_equals_plain(cuda_device, n, m_frac,
                                               dtype):
    """Around the kernel's 8192-column tile, with an all-zero row, an
    all-one row, a truncating m (well below the rows' weight 0.25 n) and
    m = n; uint8 rows that start off 16 bytes when n is odd."""
    rng = np.random.default_rng(n)
    mask = torch.from_numpy((rng.random((6, n)) < 0.25).astype(np.uint8))
    mask[0] = 0
    mask[-1] = 1
    mask[2, ::7] *= 3  # values other than 1 select too
    m = max(1, int(m_frac * n))
    card = mask.to(cuda_device).to(dtype)
    launches = indices_from_mask.launches
    got = indices_from_mask(card, m)
    assert indices_from_mask.launches == launches + 1
    _same(got, indices_from_mask_plain(card, m))
    assert torch.equal(got.cpu(), indices_from_mask(mask, m))


def test_indices_from_mask_launches_only_for_a_card_mask(cuda_device):
    mask = torch.from_numpy(
        (np.random.default_rng(0).random((4, 3000)) < 0.25).astype(np.uint8))
    launches = indices_from_mask.launches
    host = indices_from_mask(mask, 900)
    assert indices_from_mask.launches == launches
    card = indices_from_mask(mask.to(cuda_device), 900)
    assert indices_from_mask.launches == launches + 1
    _same(card.cpu(), host)
    # the planner's sparse forms reach it for a store on the card
    store, _ = _case(3000, 64, 1, cuda_device)
    before = (indices_from_mask.launches, gather_xor.launches)
    ops.server_answer_sparse(store.packed, mask.to(cuda_device), theta=0.3)
    assert (indices_from_mask.launches, gather_xor.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("fn", [parity_matmul, parity_matmul_packed])
def test_parity_kernel_counts_operands_by_their_values_mod_2(cuda_device,
                                                             mask_dtype, fn):
    """Operand values in {0, 1, 2, 3}: the card gives the CPU's bits."""
    rng = np.random.default_rng(11)
    mask = torch.from_numpy(rng.integers(0, 4, size=(70, 3000))).to(
        mask_dtype)
    planes = torch.from_numpy(rng.integers(0, 4, size=(3000, 96)).astype(
        np.uint8))
    want = fn(mask, planes)
    _same(fn(mask.to(cuda_device), planes.to(cuda_device)).cpu(), want)


@pytest.mark.parametrize("n,rb,q", SHAPES + [(3000, 96, 70)])
def test_parity_matmul_kernel_equals_plain(cuda_device, n, rb, q):
    store, mask = _case(n, rb, q, cuda_device)
    planes = store.bitplanes().contiguous()  # the reference's layout
    launches = (parity_matmul.launches, parity_matmul_packed.launches)
    got = parity_matmul(mask, planes)
    _same(got, parity_matmul_plain(mask, planes))
    packed = ops.server_answer_parity(planes, mask)
    assert (parity_matmul.launches, parity_matmul_packed.launches) == (
        launches[0] + 1, launches[1] + 1)
    _same(packed, parity_matmul_packed_plain(mask, planes))
    _same(packed, xor_fold(store.packed, mask))
    _same(ops.server_answer_parity(store.bitplanes(), mask), packed)


PARITY_CASES = [
    # (n, B bit columns, q)
    (2222, 288, 13),      # n not a multiple of 16: the mask's padded copy
    (3000, 96, 70),
    (100, 40, 3),
    (2048, 1, 5),         # B = 1, 33: the planes' padded copy
    (2048, 33, 5),
    (4096, 12288, 8),     # the CT record's 12 288 bit columns
    (1024, 512, 1),
    (1024, 512, 63),
    (1024, 512, 65),
    (2048, 512, 1000),
    (128, 512, 128),      # one 128-wide n tile: one split
    (65536, 512, 128),    # two output tiles, 512 n tiles: many splits
    (1000, 13000, 300),   # more output tiles than SMs
]


def _bits(shape, p, device, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.random(shape) < p).astype(np.uint8)).to(device)


def _planes(n, b, device, seed, layout):
    """Random 0/1 planes [n, b]: contiguous ("rows"), or the view of a
    contiguous [b, n] tensor ("n_contiguous"), the serving path's."""
    if layout == "rows":
        return _bits((n, b), 0.5, device, seed)
    return _bits((b, n), 0.5, device, seed).t()


@pytest.mark.parametrize("n,b,q", PARITY_CASES)
@pytest.mark.parametrize("layout", ["rows", "n_contiguous"])
def test_parity_kernel_both_forms_equal_plain(cuda_device, n, b, q, layout):
    mask = _bits((q, n), 0.4, cuda_device, seed=n + q)
    planes = _planes(n, b, cuda_device, b, layout)
    bits = parity_matmul(mask, planes)
    assert bits.shape == (q, b) and bits.dtype == torch.uint8
    _same(bits, parity_matmul_plain(mask, planes))
    words = parity_matmul_packed(mask, planes)
    assert words.shape == (q, -(-b // 32)) and words.dtype == torch.int32
    _same(words, parity_matmul_packed_plain(mask, planes))


def test_parity_kernel_reads_row_slices_of_either_layout(cuda_device):
    """Views whose rows are 16-byte aligned go to the kernel as they lie:
    a slice of records of either layout."""
    mask = _bits((40, 4096), 0.5, cuda_device, seed=7)
    for layout in ("rows", "n_contiguous"):
        planes = _planes(8192, 512, cuda_device, 8, layout)[2048:6144]
        _same(parity_matmul_packed(mask, planes),
              parity_matmul_packed_plain(mask, planes))


@pytest.mark.parametrize("layout", ["rows", "n_contiguous"])
def test_parity_kernel_all_ones_gives_n_mod_2(cuda_device, layout):
    """Every sum is n = 65 537: every bit is 1, in every split."""
    n, b, q = 65537, 64, 4
    mask = torch.ones((q, n), dtype=torch.uint8, device=cuda_device)
    planes = torch.ones((n, b) if layout == "rows" else (b, n),
                        dtype=torch.uint8, device=cuda_device)
    if layout != "rows":
        planes = planes.t()
    _same(parity_matmul(mask, planes), torch.ones_like(mask[:, :b]))
    _same(parity_matmul_packed(mask, planes),
          torch.full((q, 2), -1, dtype=torch.int32, device=cuda_device))


@pytest.mark.parametrize("layout", ["rows", "n_contiguous"])
def test_parity_kernel_split_xor_gives_the_same_bytes_every_run(cuda_device,
                                                                layout):
    mask = _bits((128, 65536), 0.5, cuda_device, seed=3)
    planes = _planes(65536, 512, cuda_device, 4, layout)
    for fn in (parity_matmul, parity_matmul_packed):
        first = fn(mask, planes)
        for _ in range(3):
            _same(fn(mask, planes), first)


@pytest.mark.parametrize("fn", [parity_matmul, parity_matmul_packed])
def test_parity_forms_raise_on_a_failed_build_or_launch(cuda_device,
                                                        monkeypatch, fn):
    from repro_torch.kernels import _build

    mask = _bits((4, 256), 0.5, cuda_device, seed=5)
    planes = _bits((256, 64), 0.5, cuda_device, seed=6)
    launches = fn.launches

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    with monkeypatch.context() as m:
        m.setattr(_build, "_lib", None)
        m.setattr(_build, "_source_hash", lambda: "0000-no-such-build")
        m.setattr(_build, "_find_nvcc", no_nvcc)
        with pytest.raises(RuntimeError, match="nvcc"):
            fn(mask, planes)
    assert fn.launches == launches

    class Refused:  # what a launch the card refuses returns
        @staticmethod
        def pir_parity_matmul(*args):
            return 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(_build, "library", lambda: Refused)
    with pytest.raises(RuntimeError, match="failed to launch"):
        fn(mask, planes)


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


# --------------------------------------------------------------- scatter_rows
SCATTER_SHAPES = [
    # (n rows, W elements, m updates)
    (1, 1, 1),
    (16, 4, 3),
    (33, 7, 40),        # ragged width, more updates than rows
    (257, 12, 64),
    (1000, 384, 300),   # the CT record width
    (4099, 13, 4096),   # the ingest chunk
]
SCATTER_DTYPES = [torch.int32, torch.uint8, torch.float32, torch.int16]


def _scatter_case(n, w, m, dtype, device, seed, unique):
    g = torch.Generator().manual_seed(seed)
    db = torch.randint(0, 255, (n, w), generator=g).to(dtype)
    vals = torch.randint(0, 255, (m, w), generator=g).to(dtype)
    if unique:
        rows = torch.randperm(max(n, m), generator=g)[:m] % n
        rows = torch.unique(rows)[: min(m, n)]
        vals = vals[: rows.numel()]
    else:
        rows = torch.randint(0, n, (m,), generator=g)
    return (db.to(device), rows.to(torch.int32).to(device),
            vals.to(device))


@pytest.mark.parametrize("n,w,m", SCATTER_SHAPES)
@pytest.mark.parametrize("dtype", SCATTER_DTYPES)
@pytest.mark.parametrize("unique", [True, False])
def test_scatter_rows_kernel_equals_plain(cuda_device, n, w, m, dtype, unique):
    db, rows, vals = _scatter_case(n, w, m, dtype, cuda_device, n + w, unique)
    before = db.clone()
    launches = scatter_rows.launches
    got = scatter_rows(db, rows, vals)
    assert scatter_rows.launches == launches + 1
    _same(got, scatter_rows_plain(db, rows, vals))
    _same(db, before)  # functional: the input is never written
    assert got.data_ptr() != db.data_ptr()


def test_scatter_rows_kernel_last_write_wins(cuda_device):
    db = torch.zeros((8, 5), dtype=torch.int32, device=cuda_device)
    rows = torch.tensor([3, 1, 3, 3, 1, 7], dtype=torch.int32,
                        device=cuda_device)
    vals = torch.arange(30, dtype=torch.int32, device=cuda_device).reshape(6, 5)
    got = scatter_rows(db, rows, vals)
    torch.cuda.synchronize()
    want = torch.zeros_like(db)
    want[3], want[1], want[7] = vals[3], vals[4], vals[5]
    assert torch.equal(got, want)
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda_device)
    assert scatter_rows(db, empty, vals[:0]) is db
    out_of_range = torch.tensor([-1, 8], dtype=torch.int32, device=cuda_device)
    _same(scatter_rows(db, out_of_range, vals[:2]), db)


def test_scatter_rows_kernel_on_a_row_slice(cuda_device):
    """An unaligned view (rows starting mid-vector) takes the narrower
    copy path and stays exact."""
    base = torch.arange(7 * 9 + 1, dtype=torch.uint8, device=cuda_device)
    db = base[1:].reshape(7, 9)[:6]
    assert db.is_contiguous() and db.data_ptr() % 4
    rows = torch.tensor([0, 5], dtype=torch.int32, device=cuda_device)
    vals = torch.full((2, 9), 255, dtype=torch.uint8, device=cuda_device)
    _same(scatter_rows(db, rows, vals), scatter_rows_plain(db, rows, vals))


# --------------------------------------------------------------- sparse_masks
def _mask_operands(b, n, d, device, seed):
    """Weights drawn uniformly from 0..d (both of the kernel's branches:
    the ones drawn, and the zeros drawn then flipped), queried columns at
    0 and n - 1 among others, and a key; all on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    w_even = torch.randint(0, d + 1, (b, n), generator=gen).to(torch.uint8)
    w_q = torch.randint(0, d + 1, (b,), generator=gen).to(torch.uint8)
    q_idx = torch.randint(0, n, (b,), generator=gen)
    q_idx[0], q_idx[-1] = 0, n - 1
    key = torch.randint(0, 1 << 32, (2,), generator=gen)
    return [t.to(device) for t in (w_even, w_q, q_idx, key)]


@pytest.mark.parametrize("b", [1, 3, 128])
@pytest.mark.parametrize("n", [1, 7, 4099, 10**5])
@pytest.mark.parametrize("d", [2, 4, 31, 32, 33, 100, 255])
def test_sparse_masks_kernel_equals_plain(cuda_device, d, n, b):
    """Bit for bit, at every bitmap width (1, 2, 4, 8 words), at runs cut
    by the row's end and at rows off 16-byte alignment."""
    ops_ = _mask_operands(b, n, d, cuda_device, seed=1000 * d + 10 * n + b)
    before = sparse_masks.launches
    got = sparse_masks(*ops_, d)
    assert sparse_masks.launches == before + 1
    want = sparse_masks_plain(*ops_, d)
    torch.cuda.synchronize()
    assert got.shape == (d, b, n) and got.dtype == torch.uint8
    assert torch.equal(got, want)


def test_sparse_masks_kernel_past_2_31_output_bytes(cuda_device):
    """A [100, 8, 2.7e6] output (2.16e9 bytes): the rows past 2^31 bytes
    land where the plain version puts them, checked a server at a time."""
    d, b, n = 100, 8, 2_700_000
    assert d * b * n > 2**31
    ops_ = _mask_operands(b, n, d, cuda_device, seed=31)
    got = sparse_masks(*ops_, d)
    want = sparse_masks_plain(*ops_, d)
    torch.cuda.synchronize()
    for s in range(d):
        assert torch.equal(got[s], want[s]), s


# ---------------------------------------------------- fused_multi_gather_fold
MULTI_CASES = [
    # (counts per request, k_max)
    ((5,), 8),
    ((1, 1, 1, 1, 1, 1, 1, 1), 1),
    ((3, 0, 8, 1), 8),
    ((2, 2), 2),
    ((0, 4, 1), 4),
    ((4, 1, 3, 2, 4, 0, 2, 1), 4),
]


def _multi_case(n, rb, counts, k_max, device, seed, garbage):
    store = make_synthetic_store(n, rb, seed=seed, device=device)
    rng = np.random.default_rng(seed + 7)
    m = min(n, 96)
    idx = np.full((len(counts) * k_max, m), -1, np.int32)
    for r, c in enumerate(counts):
        for i in range(k_max if garbage else c):
            w = int(rng.integers(1, m + 1))
            idx[r * k_max + i, :w] = rng.choice(n, size=w, replace=False)
    offsets = np.cumsum([0] + list(counts)).astype(np.int32)
    return (store, torch.from_numpy(idx).to(device),
            torch.from_numpy(offsets).to(device))


@pytest.mark.parametrize("counts,k_max", MULTI_CASES)
@pytest.mark.parametrize("n,rb", [(100, 12), (2048, 64), (37, 129)])
@pytest.mark.parametrize("grid_order", ["rw", "wr"])
@pytest.mark.parametrize("garbage", [False, True])
def test_fused_multi_kernel_equals_plain(cuda_device, counts, k_max, n, rb,
                                         grid_order, garbage):
    store, idx, off = _multi_case(n, rb, counts, k_max, cuda_device,
                                  seed=k_max + n, garbage=garbage)
    launches = fused_multi_gather_fold.launches
    got = fused_multi_gather_fold(store.packed, idx, off, k_max=k_max,
                                  grid_order=grid_order)
    assert fused_multi_gather_fold.launches == launches + 1
    _same(got, fused_multi_gather_fold_plain(store.packed, idx, off, k_max))


@pytest.mark.parametrize("block_w", [1, 8, 32, 128])
def test_fused_multi_kernel_block_sweep(cuda_device, block_w):
    store, idx, off = _multi_case(91, 21, (4, 0, 7), 8, cuda_device, seed=3,
                                  garbage=True)
    for go in ("rw", "wr"):
        _same(fused_multi_gather_fold(store.packed, idx, off, k_max=8,
                                      block_w=block_w, grid_order=go),
              fused_multi_gather_fold_plain(store.packed, idx, off, 8))


def test_fused_multi_kernel_all_live_equals_flat(cuda_device):
    store, mask = _case(1024, 64, 32, cuda_device, p=0.25)
    idx = indices_from_mask(mask, 1024)
    off = torch.arange(9, dtype=torch.int32, device=cuda_device) * 4
    flat = fused_gather_fold(store.packed, idx)
    for go in ("rw", "wr"):
        _same(fused_multi_gather_fold(store.packed, idx, off, k_max=4,
                                      grid_order=go), flat)


def test_fused_multi_kernel_refuses_oversized_slab(cuda_device):
    store, idx, off = _multi_case(100_000, 16, (1, 1), 1, cuda_device, seed=0,
                                  garbage=False)
    with pytest.raises(ValueError, match="shared"):
        fused_multi_gather_fold(store.packed, idx, off, k_max=1, block_w=4)


# ------------------------------------ the fused kernels' cluster launches
FUSED_CLUSTER_SHAPES = [
    # (n, W, block_w): the reduced config's slab (either staging path), W 3
    # (12-byte rows: copy only), a ragged last word tile (W 40 at 16, TMA's
    # zero fill past W), the gate's edge (the slab fills the opt-in limit:
    # copy, and no room for scratch)
    (2048, 16, 16), (300, 3, 128), (500, 40, 16), (7264, 384, 8),
]


def _fused_words(n, w, device, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(-(2**31), 2**31, size=(n, w), dtype=np.int64)
        .astype(np.int32)).to(device)


def _fused_ids(n, rows, m, device, seed):
    """Random ids with padding, ids below 0 and at or past n (skipped), a
    duplicate in every row (cancels) and, from 2 rows, an all-padding
    row. Ids past n lie outside the plain version's contract: compare
    with :func:`_in_store`."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(rows, m)).astype(np.int32)
    idx[:, ::7] = -1
    idx[:, 3::11] = n
    idx[:, 5::13] = -5
    idx[:, 9::17] = n + 1000
    idx[:, 1] = idx[:, 2]
    if rows > 1:
        idx[rows // 2] = -1
    return torch.from_numpy(idx).to(device)


def _in_store(idx, n):
    return torch.where(idx < n, idx, -1)


def _each_staging(cuda_device, n, w, rows, block_w, grid_order, k_max=1):
    """The schedule the wrapper takes, then each staging path forced where
    it can run."""
    budget = fused_smem_budget(cuda_device)
    out = [fused_schedule(n, w, rows, block_w, grid_order=grid_order,
                          k_max=k_max, budget=budget)]
    for staging in STAGINGS:
        try:
            out.append(fused_schedule(n, w, rows, block_w,
                                      grid_order=grid_order, k_max=k_max,
                                      budget=budget, staging=staging))
        except ValueError:  # TMA where it cannot run
            assert staging == "tma"
    return out


@pytest.mark.parametrize("n,w,block_w", FUSED_CLUSTER_SHAPES)
@pytest.mark.parametrize("q", [1, 3, 8, 9, 17, 33])
@pytest.mark.parametrize("grid_order", ["qw", "wq"])
def test_fused_cluster_kernel_equals_plain(cuda_device, n, w, block_w, q,
                                           grid_order):
    db = _fused_words(n, w, cuda_device, seed=n + q)
    idx = _fused_ids(n, q, 301, cuda_device, seed=q)
    want = fused_gather_fold_plain(db, _in_store(idx, n))
    launches = fused_gather_fold.launches
    _same(fused_gather_fold(db, idx, block_w=block_w,
                            grid_order=grid_order), want)
    assert fused_gather_fold.launches == launches + 1
    for sched in _each_staging(cuda_device, n, w, q, block_w, grid_order):
        launches = fused_gather_fold.launches
        _same(fused_launch(db, idx, None, 1, sched), want)
        assert fused_gather_fold.launches == launches + 1


FUSED_MULTI_COUNTS = [
    # (counts per request, k_max): zero counts on the CTAs' boundaries (1
    # and 2 requests a CTA), the first and the last request dead, a count
    # past k_max (every row live), every request dead
    ((0, 4, 4, 0, 4, 0, 0, 4, 0, 6), 4),
    ((0, 2, 0, 1, 0, 0, 2, 2, 0, 1, 0, 2, 0, 0, 1, 0, 2), 2),
    ((0, 0, 0), 8),
]


@pytest.mark.parametrize("counts,k_max", FUSED_MULTI_COUNTS)
@pytest.mark.parametrize("n,w,block_w", FUSED_CLUSTER_SHAPES)
@pytest.mark.parametrize("grid_order", ["rw", "wr"])
def test_fused_multi_cluster_kernel_equals_plain(cuda_device, counts, k_max,
                                                 n, w, block_w, grid_order):
    """Dead rows hold live-looking garbage and answer zero."""
    db = _fused_words(n, w, cuda_device, seed=n)
    rows = len(counts) * k_max
    idx = _fused_ids(n, rows, 173, cuda_device, seed=rows)
    off = torch.from_numpy(np.cumsum((0,) + counts).astype(np.int32)).to(
        cuda_device)
    want = fused_multi_gather_fold_plain(db, _in_store(idx, n), off, k_max)
    launches = fused_multi_gather_fold.launches
    _same(fused_multi_gather_fold(db, idx, off, k_max=k_max, block_w=block_w,
                                  grid_order=grid_order), want)
    assert fused_multi_gather_fold.launches == launches + 1
    for sched in _each_staging(cuda_device, n, w, rows, block_w, grid_order,
                               k_max):
        launches = fused_multi_gather_fold.launches
        _same(fused_launch(db, idx, off, k_max, sched), want)
        assert fused_multi_gather_fold.launches == launches + 1


def test_fused_kernels_write_every_output_word(cuda_device):
    """The output comes from torch.empty: after a launch into memory full
    of ones every word is the plain answer, on both paths and orders."""
    db = _fused_words(2048, 16, cuda_device, seed=1)
    idx = _fused_ids(2048, 32, 301, cuda_device, seed=2)
    off = torch.arange(9, dtype=torch.int32, device=cuda_device) * 4
    off[3] = off[2]  # request 2 dead
    live = _in_store(idx, 2048)
    flat, multi = (fused_gather_fold_plain(db, live),
                   fused_multi_gather_fold_plain(db, live, off, 4))
    for go, mgo in (("qw", "rw"), ("wq", "wr")):
        # the caching allocator hands a freed block of the output's size to
        # the next torch.empty of that size
        torch.full_like(flat, -1)
        _same(fused_gather_fold(db, idx, grid_order=go), flat)
        torch.full_like(multi, -1)
        _same(fused_multi_gather_fold(db, idx, off, k_max=4, grid_order=mgo),
              multi)


def test_eight_full_slab_ctas_make_one_cluster(cuda_device):
    """A cluster of 8 CTAs that each hold a whole 227 KB slab fits the
    card: every CTA of a TMA cluster holds the whole slab."""
    from repro_torch.kernels import _build

    lib = _build.library()
    assert lib.pir_fused_active_clusters(8, fused_smem_budget(cuda_device)) > 0


@pytest.mark.parametrize("multi", [False, True])
def test_fused_refused_cluster_launch_raises(cuda_device, monkeypatch,
                                             multi):
    """A launch the card or the launcher refuses raises, and is never
    answered by the plain version."""
    from repro_torch.kernels import _build

    db = _fused_words(256, 16, cuda_device, seed=0)
    idx = _fused_ids(256, 8, 64, cuda_device, seed=0)
    off = torch.arange(3, dtype=torch.int32, device=cuda_device) * 4
    sched = fused_schedule(256, 16, 8, 16)
    # a cluster past the portable 8 CTAs: the launcher refuses it
    bad = {**sched, "cluster": 9, "grid": (9,) + sched["grid"][1:]}
    with pytest.raises(RuntimeError, match="failed to launch"):
        fused_launch(db, idx, off if multi else None, 4 if multi else 1, bad)

    class Refused:  # what a launch the card refuses returns
        @staticmethod
        def pir_fused_gather_fold(*args):
            return 9  # cudaErrorInvalidConfiguration

        pir_fused_multi_gather_fold = pir_fused_gather_fold

    monkeypatch.setattr(_build, "library", lambda: Refused)
    with pytest.raises(RuntimeError, match="failed to launch"):
        if multi:
            fused_multi_gather_fold(db, idx, off, k_max=4)
        else:
            fused_gather_fold(db, idx)


def test_live_store_and_multi_pipeline_on_the_card(cuda_device):
    """A live store and multi-index requests through the reduced pipeline
    on the card: the ingest launched the scatter kernel, the multi batch
    the fused multi kernel, once per server, and every answer is exact."""
    from repro_torch.configs import pir_ct
    from repro_torch.data.pipeline import pir_delta_batch
    from repro_torch.db import VersionedStore

    cfg = pir_ct.reduced()
    live = VersionedStore(make_synthetic_store(
        cfg.n_records, cfg.record_bytes, seed=0, device=cuda_device))
    pipe = pir_ct.make_serving_pipeline(cfg, store=live, seed=2)
    before = scatter_rows.launches
    for delta in pir_delta_batch(live.n, cfg.record_bytes, updates=100,
                                 deletes=5, seed=1, step=0):
        pipe.ingest(delta)
    assert scatter_rows.launches == before + 2
    lists = [[1, 2, 3], [2047], [5, 6]]
    for c, lst in enumerate(lists):
        assert pipe.submit_many(f"c{c}", lst)
    before = fused_multi_gather_fold.launches
    out = pipe.flush()
    assert fused_multi_gather_fold.launches == before + cfg.d
    for c, lst in enumerate(lists):
        want = np.stack([live.snapshot().record_bytes(i) for i in lst])
        assert (out[f"c{c}"] == want).all()
    assert pipe.compact_step() == 2


# ------------------------------------------------------- flash_attention_fwd
FLASH_CASES = [
    # (bh, sq, sk, d, causal, window): the reference's sweep, then the head
    # dims a later slice needs, a window smaller than one 64-row tile, a
    # window with its first tiles empty, and cross lengths
    (2, 64, 64, 16, True, None),
    (3, 100, 100, 32, True, None),
    (2, 64, 64, 16, True, 24),
    (1, 128, 128, 64, False, None),
    (2, 96, 160, 16, False, None),
    (1, 257, 129, 8, True, None),
    (2, 300, 300, 128, True, None),
    (1, 200, 200, 256, False, None),
    (2, 130, 130, 256, True, 24),
    (3, 500, 500, 64, True, 100),
    (2, 160, 96, 32, False, None),
    (4, 200, 200, 32, False, None),
    (1, 1, 70, 64, False, None),
    (2, 77, 77, 48, True, 1),
]
# bf16: both sides accumulate in f32 and round once to bf16, so they differ
# by at most one bf16 ulp (2^-8 to 2^-7 of the value) plus f32 noise
FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=8e-3, atol=1e-3)}


def _flash_case(bh, sq, sk, d, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((bh, s, d), generator=g).to(device=device, dtype=dtype)
                 for s in (sq, sk, sk))


@pytest.mark.parametrize("bh,sq,sk,d,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, bh, sq, sk, d,
                                              causal, window, dtype):
    q, k, v = _flash_case(bh, sq, sk, d, dtype, cuda_device, seed=sq + d)
    launches = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert flash_attention_fwd.launches == launches + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (bh, sq, d)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("window", [None, 63, 64, 65, 1024])
def test_flash_attention_tile_skips_in_f32(cuda_device, window):
    """The key tiles skipped after the diagonal and before the window, at
    the LM's head dim over 32 q tiles: bf16-valued operands in f32, so a
    tile lost or taken twice cannot hide under the output's rounding."""
    q, k, v = (t.float() for t in _flash_case(
        2, 2048, 2048, 64, torch.bfloat16, cuda_device, seed=5))
    got = flash_attention_fwd(q, k, v, causal=True, window=window)
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, **FLASH_TOL[torch.float32])


def test_f32_kernel_agrees_on_rows_the_mask_empties(cuda_device):
    """With Sq > Sk and a window, rows q >= Sk - 1 + window keep no key:
    the plain version averages the Sk keys there. flash_attention.cu gives
    the zero-padded keys of its last 64-key tile -inf (masked real keys
    keep the finite -1e30), so it averages the same Sk keys and agrees at
    the f32 tolerance on every row, the emptied ones included."""
    sq, sk, window = 500, 300, 63
    q, k, v = _flash_case(2, sq, sk, 64, torch.float32, cuda_device, seed=9)
    got = flash_attention_fwd(q, k, v, causal=True, window=window)
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    empty = sk - 1 + window
    assert empty < sq and sk % 64  # emptied rows exist; the last tile pads
    torch.testing.assert_close(got, want, **FLASH_TOL[torch.float32])


def test_flash_attention_global_window_is_no_window(cuda_device):
    q, k, v = _flash_case(2, 100, 100, 64, torch.bfloat16, cuda_device)
    _same(flash_attention_fwd(q, k, v, window=1 << 30), flash_attention_fwd(q, k, v))


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _flash_case(1, 8, 8, 8, torch.float16, cuda_device)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k, v)
    q, k, v = _flash_case(1, 8, 8, 300, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v)
    q, k, v = _flash_case(1, 8, 8, 8, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)


def test_a_failed_build_raises_and_never_falls_back(cuda_device, monkeypatch):
    from repro_torch.kernels import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_source_hash", lambda: "0000-no-such-build")
    monkeypatch.setattr(_build, "_find_nvcc", no_nvcc)
    q, k, v = _flash_case(1, 8, 8, 8, torch.float32, cuda_device)
    launches = flash_attention_fwd.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches == launches


# the tensor-core kernel (bf16, d 64 / 128 / 256): lengths off the 128-row
# q and 64/128-key tiles, Sq != Sk both ways, windows around the tile edges
WGMMA_LENGTHS = [(1, 70), (70, 1), (129, 129), (300, 500), (500, 300),
                 (70, 129), (500, 500)]
WGMMA_WINDOWS = [None, 1, 63, 64, 65, 127, 128, 129, 1024]


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq,sk", WGMMA_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", WGMMA_WINDOWS)
def test_wgmma_flash_kernel_matches_plain(cuda_device, d, sq, sk, causal,
                                          window):
    bh = 36 if sq == sk == 129 else 3
    q, k, v = _flash_case(bh, sq, sk, d, torch.bfloat16, cuda_device,
                          seed=sq + 7 * sk + d)
    before = dict(flash_attention_fwd.kernel_launches)
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert flash_attention_fwd.kernel_launches["flash_wgmma_kernel"] == (
        before["flash_wgmma_kernel"] + 1)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (bh, sq, d)
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


# the f32 kernel (flash_attention.cu: 3xTF32 on mma.sync, blocks of four
# 16-row warps over 64 q rows, 64-key tiles, 32 at a head dim over 64):
# lengths off the warp's 16 rows, the block's 64 and the key tiles, Sq !=
# Sk both ways, windows around those edges; every head dim it pads to (16
# to 256) in f32, and bf16 at the head dims the wgmma kernel does not take
# (192 pads to 256: the bf16 instance at that padded width);
# then the exact operand shapes of chip_smoke.py's (c) (BERT4Rec) and (e)
# (the LM's f32 check)
F32_KERNEL_LENGTHS = [(1, 70), (15, 15), (16, 16), (17, 17), (70, 129),
                      (129, 129), (200, 200), (300, 500), (500, 300)]
F32_KERNEL_WINDOWS = [None, 1, 16, 17, 65]
F32_KERNEL_OPERANDS = ([(torch.float32, d)
                        for d in (16, 32, 48, 64, 96, 128, 256)]
                       + [(torch.bfloat16, d) for d in (16, 32, 48, 96, 192)])
F32_KERNEL_CASES = [
    pytest.param(2, sq, sk, d, dtype, causal, window,
                 id=f"{str(dtype)[6:]}-d{d}-{sq}x{sk}-"
                    f"{'causal' if causal else 'full'}-w{window}")
    for dtype, d in F32_KERNEL_OPERANDS
    for sq, sk in F32_KERNEL_LENGTHS
    for causal in (True, False)
    for window in F32_KERNEL_WINDOWS
] + [
    # a head dim cp.async cannot copy in 16-byte pieces: plain loads
    pytest.param(2, sq, sk, 17, dtype, causal, window,
                 id=f"{str(dtype)[6:]}-d17-{sq}x{sk}-"
                    f"{'causal' if causal else 'full'}-w{window}")
    for dtype in (torch.float32, torch.bfloat16)
    for sq, sk in ((70, 129), (129, 129))
    for causal in (True, False)
    for window in (None, 16)
] + [
    pytest.param(64, 200, 200, 32, torch.float32, False, None,
                 id="c_bert4rec"),
    pytest.param(9, 256, 256, 64, torch.float32, True, None,
                 id="e_lm_f32_check"),
]


@pytest.mark.parametrize("bh,sq,sk,d,dtype,causal,window", F32_KERNEL_CASES)
def test_f32_flash_kernel_matches_plain(cuda_device, bh, sq, sk, d, dtype,
                                        causal, window):
    q, k, v = _flash_case(bh, sq, sk, d, dtype, cuda_device,
                          seed=sq + 7 * sk + d)
    before = dict(flash_attention_fwd.kernel_launches)
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    after = flash_attention_fwd.kernel_launches
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "flash_fwd_kernel") for n in after}
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (bh, sq, d)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_flash_kernel_reads_unaligned_operands(cuda_device, dtype):
    """Views that start one element into their buffers are not 16-byte
    aligned: the f32 kernel stages them by plain loads and agrees."""
    q, k, v = _flash_case(2, 129, 129, 32, dtype, cuda_device, seed=3)
    views = []
    for t in (q, k, v):
        flat = torch.empty(t.numel() + 1, dtype=dtype, device=cuda_device)
        views.append(flat[1:].view(t.shape))
        views[-1].copy_(t)
    got = flash_attention_fwd(*views, causal=True, window=17)
    want = flash_attention_plain(q, k, v, causal=True, window=17)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


def test_the_lm_operands_go_through_the_wgmma_kernel(cuda_device):
    """bf16 at d 64 (SmolLM's heads) launches the tensor-core kernel; the
    same operands in f32, and bf16 at d 32, launch the f32 kernel."""
    q, k, v = _flash_case(9, 256, 256, 64, torch.bfloat16, cuda_device)
    for args, kernel in (((q, k, v), "flash_wgmma_kernel"),
                         (tuple(t.float() for t in (q, k, v)),
                          "flash_fwd_kernel"),
                         (tuple(t[..., :32].contiguous() for t in (q, k, v)),
                          "flash_fwd_kernel")):
        before = dict(flash_attention_fwd.kernel_launches)
        launches = flash_attention_fwd.launches
        flash_attention_fwd(*args)
        torch.cuda.synchronize()
        after = flash_attention_fwd.kernel_launches
        assert flash_attention_fwd.launches == launches + 1
        assert {n: after[n] - before[n] for n in after} == {
            n: int(n == kernel) for n in after}


def test_the_wgmma_kernel_refuses_operands_off_16_bytes(cuda_device):
    # TMA reads from 16-byte boundaries: a contiguous view that starts one
    # bf16 element into its buffer is refused, not read wrong
    q, k, v = _flash_case(1, 64, 64, 64, torch.bfloat16, cuda_device)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    launches = flash_attention_fwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(shifted, k, v)
    assert flash_attention_fwd.launches == launches


def test_the_wgmma_kernel_refuses_gemma2_operands_off_16_bytes(cuda_device):
    # bf16 at d 256 is wgmma's too: an unaligned view raises and launches
    # nothing, on either kernel (it does not go to flash_attention.cu)
    q, k, v = _flash_case(2, 128, 128, 256, torch.bfloat16, cuda_device)
    flat = torch.empty(k.numel() + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:1 + k.numel()].view(k.shape)
    shifted.copy_(k)
    before = dict(flash_attention_fwd.kernel_launches)
    launches = flash_attention_fwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(q, shifted, v, causal=True, softcap=50.0)
    assert flash_attention_fwd.launches == launches
    assert flash_attention_fwd.kernel_launches == before


@pytest.mark.parametrize("window", [None, 4096], ids=["global", "window_4096"])
def test_gemma2_prefill_operands_on_the_wgmma_kernel(cuda_device, window):
    """chip_smoke.py's (g) and (g') cut to 2 of their 16 rows: one global
    layer's call and one windowed, 8192 tokens at head dim 256, bf16,
    causal, cap 50, on the wgmma kernel within the bf16 tolerance."""
    q, k, v = _flash_case(2, 8192, 8192, 256, torch.bfloat16, cuda_device,
                          seed=8192 + 256)
    kw = dict(causal=True, window=window, softcap=50.0)
    before = dict(flash_attention_fwd.kernel_launches)
    got = flash_attention_fwd(q, k, v, **kw)
    after = flash_attention_fwd.kernel_launches
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "flash_wgmma_kernel") for n in after}
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (2, 8192, 256)
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


def test_gqa_attention_at_the_lms_head_dim_in_bf16(cuda_device):
    """gqa_attention at head dim 64 in bf16 (9 query / 3 kv heads) goes
    through the tensor-core kernel and agrees with the CPU plain path,
    which keeps scores and probabilities in bf16 (hence 2e-2)."""
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 300, 9, 64), generator=g).to(cuda_device,
                                                     torch.bfloat16)
    k, v = (torch.randn((2, 300, 3, 64), generator=g).to(cuda_device,
                                                          torch.bfloat16)
            for _ in range(2))
    for kw in (dict(causal=True), dict(causal=True, window=100),
               dict(causal=False)):
        before = flash_attention_fwd.kernel_launches["flash_wgmma_kernel"]
        got = L.gqa_attention(q, k, v, **kw)
        assert flash_attention_fwd.kernel_launches["flash_wgmma_kernel"] == (
            before + 1)
        want = L.gqa_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=2e-2, atol=2e-2)


def test_gqa_attention_on_the_card_launches_the_kernel(cuda_device):
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 40, 6, 32), generator=g).to(cuda_device)
    k = torch.randn((2, 40, 2, 32), generator=g).to(cuda_device)
    v = torch.randn((2, 40, 2, 32), generator=g).to(cuda_device)
    for kw in (dict(causal=True), dict(causal=True, window=9),
               dict(causal=False)):
        launches = flash_attention_fwd.launches
        got = L.gqa_attention(q, k, v, **kw)
        assert flash_attention_fwd.launches == launches + 1
        want = L.gqa_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    # bf16: the kernel keeps an f32 softmax where the plain path rounds the
    # scores and probabilities to bf16, so the two differ by rounding only
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = L.gqa_attention(qb, kb, vb)
    want = L.gqa_attention(qb.cpu(), kb.cpu(), vb.cpu())
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    # a softcap and a query offset launch the kernel too, and match the
    # plain path (they raised before the kernels had them)
    for kw in (dict(attn_softcap=30.0), dict(q_offset=3),
               dict(attn_softcap=30.0, window=9, q_offset=5)):
        launches = flash_attention_fwd.launches
        got = L.gqa_attention(q, k, v, **kw)
        assert flash_attention_fwd.launches == launches + 1
        want = L.gqa_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# the softcap and the query offset in both kernels: every padded head dim
# the f32 kernel has a softcap copy of (and the two wgmma takes), in both
# types; Sq != Sk both ways, offsets that put rows past the last key, and
# windows around the tile edges
CAP_OFFSET_CASES = [
    pytest.param(3, sq, sk, d, dtype, causal, window, cap, off,
                 id=f"{str(dtype)[6:]}-d{d}-{sq}x{sk}-off{off}-"
                    f"{'causal' if causal else 'full'}-w{window}-cap{cap}")
    for dtype in (torch.float32, torch.bfloat16)
    for d in (32, 64, 128, 256)
    for sq, sk, off in ((200, 200, 0), (70, 300, 230), (129, 500, 64),
                        (256, 1280, 1024), (300, 200, 7))
    for causal, window in ((True, None), (True, 65), (False, None),
                           (False, 33))
    for cap in (0.0, 50.0)
    if cap or off
]


@pytest.mark.parametrize("bh,sq,sk,d,dtype,causal,window,cap,off",
                         CAP_OFFSET_CASES)
def test_flash_kernels_with_cap_and_offset_match_plain(
        cuda_device, bh, sq, sk, d, dtype, causal, window, cap, off):
    q, k, v = _flash_case(bh, sq, sk, d, dtype, cuda_device,
                          seed=sq + 7 * sk + d + off)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    launches = flash_attention_fwd.launches
    before = dict(flash_attention_fwd.kernel_launches)
    got = flash_attention_fwd(q, k, v, **kw)
    assert flash_attention_fwd.launches == launches + 1
    after = flash_attention_fwd.kernel_launches
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == _kernel_for(dtype, d)) for n in after}
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (bh, sq, d)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    if dtype == torch.bfloat16:
        # the same operands in f32: the tile ranges and masks with the
        # offset, without the output's rounding
        qf, kf, vf = (t.float() for t in (q, k, v))
        torch.testing.assert_close(flash_attention_fwd(qf, kf, vf, **kw),
                                   flash_attention_plain(qf, kf, vf, **kw),
                                   **FLASH_TOL[torch.float32])


def test_the_cap_changes_the_answer_and_the_offset_matches_a_slice(
        cuda_device):
    """A cap of 1 changes every row that sees more than one key, against
    the same call without the cap; the last 256 rows of a causal prefill
    of 1280 tokens equal those rows alone at q_offset 1024, on both
    kernels."""
    for dtype, d in ((torch.bfloat16, 64), (torch.float32, 256)):
        q, k, v = _flash_case(2, 1280, 1280, d, dtype, cuda_device, seed=d)
        whole = flash_attention_fwd(q, k, v, causal=True, window=512)
        tail = flash_attention_fwd(q[:, 1024:].contiguous(), k, v,
                                   causal=True, window=512, q_offset=1024)
        torch.testing.assert_close(tail.float(), whole[:, 1024:].float(),
                                   **FLASH_TOL[dtype])
        uncapped = flash_attention_fwd(q, k, v, causal=True)
        capped = flash_attention_fwd(q, k, v, causal=True, softcap=1.0)
        moved = (capped.float() - uncapped.float()).abs().amax(-1)
        # row 0 sees key 0 alone: its softmax is 1 whatever the cap
        assert bool((moved[:, 0] == 0).all())
        assert bool((moved[:, 1:] > 1e-3).all())


def test_reduced_models_on_the_card_match_the_cpu(cuda_device):
    """SmolLM reduced (prefill + decode) and private BERT4Rec reduced on
    the card by default, against the same weights on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.core import PrivateEmbedding
    from repro_torch.data import bert4rec_batch, lm_batch
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T

    cfg = get_arch("smollm-135m").reduced()
    lm = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    lm_cpu = T.TransformerLM({**lm.tree()}, cfg).to("cpu")
    tokens = lm_batch(cfg, 2, 100, seed=0, step=0)["tokens"]
    launches = flash_attention_fwd.launches
    logits, cache = T.prefill(lm, cfg, tokens, 104)
    assert flash_attention_fwd.launches == launches + cfg.n_layers
    want, want_cache = T.prefill(lm_cpu, cfg, tokens, 104)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
    tok = logits.argmax(-1, keepdim=True)
    got2, _ = T.decode_step(lm, cfg, cache, tok, 100)
    want2, _ = T.decode_step(lm_cpu, cfg, want_cache, tok.cpu(), 100)
    torch.testing.assert_close(got2.cpu(), want2, rtol=1e-4, atol=1e-4)

    rcfg = get_arch("bert4rec").reduced()
    model = R.bert4rec_init(torch.Generator(device="cuda").manual_seed(1), rcfg)
    seq = bert4rec_batch(rcfg, 4, seed=0, step=0)["seq"]
    plain = R.bert4rec_logits(model, rcfg, seq)
    pe = PrivateEmbedding.create(model.tree()["embed"], scheme="sparse", d=4,
                                 d_a=2, theta=0.25)
    gen = torch.Generator(device="cuda").manual_seed(2)
    folds = xor_fold.launches
    launches = flash_attention_fwd.launches
    private = R.bert4rec_logits(model, rcfg, seq,
                                lookup_fn=lambda t, ids: pe.lookup(gen, ids))
    assert xor_fold.launches == folds + 4
    assert flash_attention_fwd.launches == launches + rcfg.n_blocks
    _same(private, plain)


# ------------------------------- the rest of the schemes, autotune, cache
@pytest.mark.parametrize("name,kw", [("direct", dict(p=8)),
                                     ("subset", dict(t=3)),
                                     ("as-sparse", dict(theta=0.25, u=16))])
def test_every_scheme_on_the_card_equals_the_cpu(cuda_device, name, kw):
    """One wire payload, answered on the card and on the CPU: the same
    per-server answers and records, bit for bit; the card's own pipeline
    serves the records exactly (the mask family through the kernels, the
    direct family through its row gather)."""
    from repro_torch.core import make_scheme
    from repro_torch.serve import ServingPipeline, ShardedBackend

    sch = make_scheme(name, d=4, d_a=2, **kw)
    cpu = make_synthetic_store(512, 24, seed=3, device="cpu")
    card = make_synthetic_store(512, 24, seed=3, device=cuda_device)
    q = torch.tensor([0, 511, 77, 300], dtype=torch.int32)
    routed = sch.staged.query(sch.staged.precompute(
        torch.Generator().manual_seed(2), 512, 4), q)
    on_card = dataclasses.replace(
        routed, payload=routed.payload.to(cuda_device),
        q_idx=routed.q_idx.to(cuda_device))
    got = ShardedBackend(card, device=cuda_device).answer_batch(
        on_card, scheme=sch.staged)
    want = ShardedBackend(cpu, device="cpu").answer_batch(
        routed, scheme=sch.staged)
    _same(got.cpu(), want)
    _same(sch.staged.reconstruct(
        sch.staged.answer(card, on_card)).cpu(), cpu.packed[q.long()])
    kernels = (xor_fold, gather_xor, fused_gather_fold)
    before = sum(f.launches for f in kernels)
    pipe = ServingPipeline(card, sch, seed=4)
    for c, i in enumerate((0, 5, 511)):
        assert pipe.submit(f"c{c}", i)
    out = pipe.flush()
    for c, i in enumerate((0, 5, 511)):
        assert (out[f"c{c}"] == cpu.record_bytes(i)).all()
    # one answer kernel a contacted server; none for the direct gather
    assert sum(f.launches for f in kernels) - before == {
        "direct": 0, "subset": 3, "as-sparse": 4}[name]


def test_an_autotuned_plan_on_the_card_answers_like_the_plain_version(
        cuda_device):
    """The measured search on the card (real timer, each sample ending in
    a synchronisation) races kernel candidates only under ``auto``; the
    fastest wins and answers bit for bit like the plain fold."""
    import types

    from repro_torch._device import device_fingerprint
    from repro_torch.core import make_scheme
    from repro_torch.kernels.backend import (
        AutotuneTable,
        KernelPlanner,
        PlanCandidate,
    )

    store = make_synthetic_store(4096, 64, seed=5, device=cuda_device)
    table = AutotuneTable(cuda_device)
    planner = KernelPlanner(store, table=table)
    rng = np.random.default_rng(6)
    for name, kw, theta, bucket in (("sparse", dict(theta=0.25), 0.25, 8),
                                    ("chor", {}, None, 32)):
        sch = make_scheme(name, d=4, d_a=2, **kw).staged
        wire = types.SimpleNamespace(kind="mask", theta=theta)
        assert planner.plan(wire, bucket, scheme=sch).source == "model"
        assert planner.tune_pending() == 1
        plan = planner.plan(wire, bucket, scheme=sch)
        assert plan.source == "measured"
        key = planner._table_key(name, bucket, "cuda", theta)
        entry = table.get(key)
        assert entry["device"] == device_fingerprint(cuda_device)
        us = entry["us"]
        assert len(us) > 1 and all(
            k.split("+")[0].endswith("/cuda") for k in us)
        winner = PlanCandidate(plan.path, plan.impl, plan.blocks).label
        assert plan.impl == "cuda" and min(us, key=us.get) == winner
        mask = torch.from_numpy(
            (rng.random((bucket, store.n)) < (theta or 0.5)).astype(np.uint8)
        ).to(cuda_device)
        _same(plan(mask), xor_fold_plain(store.packed, mask))


def test_scatter_update_launches_the_kernel_on_the_card(cuda_device):
    """Under ``auto`` the write path launches the scatter kernel once per
    update, never its plain version, and measures nothing."""
    from repro_torch.kernels import scatter_update
    from repro_torch.kernels.backend import autotune_table

    db, rows, vals = _scatter_case(5000, 384, 700, torch.int32, cuda_device,
                                   1, True)
    entries = len(autotune_table(cuda_device))
    launches = scatter_rows.launches
    for m in (700, 9):
        got = scatter_update(db, rows[:m], vals[:m])
        _same(got, scatter_rows_plain(db, rows[:m], vals[:m]))
    assert scatter_rows.launches - launches == 2
    assert len(autotune_table(cuda_device)) == entries


# ------------------------------------------------ the async front on the card
def _reduced_front(cuda_device, scheme="sparse", **kw):
    from repro_torch.configs import pir_ct

    cfg = dataclasses.replace(pir_ct.reduced(), scheme=scheme,
                              max_wait_ms=2.0)
    return pir_ct.make_async_frontend(cfg, seed=4, **kw)


@pytest.mark.parametrize("double_buffer", [True, False])
@pytest.mark.parametrize("scheme", ["sparse", "chor"])
def test_async_front_on_the_card_serves_exact_records(cuda_device, scheme,
                                                      double_buffer):
    """The front by the config's defaults (the card): every future of many
    back-to-back batches resolves to its record, single and multi-index,
    with the execute stage on a side stream when double-buffered."""
    fe = _reduced_front(cuda_device, scheme)
    fe.double_buffer = double_buffer
    pipe = fe.pipeline
    assert pipe.device.type == "cuda"
    rng = np.random.default_rng(8)
    picks = rng.integers(0, pipe.store.n, size=96)
    with fe:
        futs = [fe.submit(f"c{i % 7}", int(q)) for i, q in enumerate(picks)]
        many = fe.submit_many("m", [3, 2000, 3, 17])
        assert fe.drain(timeout=120.0)
        assert (fe._side is not None) == double_buffer
    for q, f in zip(picks, futs):
        np.testing.assert_array_equal(f.result(timeout=5.0),
                                      pipe.store.record_bytes(int(q)))
    np.testing.assert_array_equal(
        many.result(timeout=5.0),
        np.stack([pipe.store.record_bytes(i) for i in (3, 2000, 3, 17)]))
    assert fe.metrics["failed"] == 0 and fe.metrics["served"] == 97
    assert pipe.metrics["batches"] >= 96 // 8


def test_the_side_stream_is_not_the_default_stream(cuda_device):
    fe = _reduced_front(cuda_device).start()
    try:
        side = fe._side
        assert side is not None and side.device.type == "cuda"
        assert side != torch.cuda.default_stream(cuda_device)
        assert side != torch.cuda.current_stream(cuda_device)
        seen = []
        real = fe.pipeline.execute_planned

        def spy(planned):
            seen.append(torch.cuda.current_stream(cuda_device))
            return real(planned)

        fe.pipeline.execute_planned = spy
        fut = fe.submit("a", 11)
        assert fe.drain(timeout=60.0)
        np.testing.assert_array_equal(fut.result(timeout=5.0),
                                      fe.pipeline.store.record_bytes(11))
        assert seen and all(s == side for s in seen)
    finally:
        fe.close()


def test_answer_batch_never_synchronizes_the_whole_device(cuda_device,
                                                         monkeypatch):
    """Each latency sample ends in a synchronisation of the stream the
    answer was issued on, not ``torch.cuda.synchronize``."""
    from repro_torch.configs import pir_ct

    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (calls.append(a), real(*a, **k)))
    pipe = pir_ct.make_serving_pipeline(pir_ct.reduced(), seed=2)
    for i in range(8):
        assert pipe.submit(f"c{i}", 5 * i)
    planned = pipe.plan_requests(pipe.take_batch())
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        out = pipe.execute_planned(planned)
    assert calls == []
    assert all(s.n == 1 for s in pipe.stats.values())
    for r, answer in out:
        np.testing.assert_array_equal(answer,
                                      pipe.store.record_bytes(r.index))


def test_degrade_replicas_on_the_card_keeps_serving_exactly(cuda_device):
    from repro_torch.configs import pir_ct
    from repro_torch.dist.fault import pir_degraded_privacy

    cfg = dataclasses.replace(pir_ct.reduced(), d=5, d_a=2)
    pipe = pir_ct.make_serving_pipeline(cfg, seed=3)
    info = pipe.degrade_replicas([4, 1])
    assert info == pir_degraded_privacy(
        d=5, d_a=2, failed=2, scheme="sparse", n=pipe.store.n,
        theta=cfg.theta)
    assert pipe.price == (info["epsilon"], info["delta"])
    assert pipe.staged.d == 3 and pipe.last_remesh.survivors == (0, 2, 3)
    before = gather_xor.launches + fused_gather_fold.launches
    picks = [0, 7, 2047, 1000, 1000, 3]
    for i, q in enumerate(picks):
        assert pipe.submit(f"c{i}", q)
    out = pipe.flush()
    for i, q in enumerate(picks):
        np.testing.assert_array_equal(out[f"c{i}"],
                                      pipe.store.record_bytes(q))
    assert gather_xor.launches + fused_gather_fold.launches - before == 3


# ------------------------------------------------------------- the mesh
def _card_mesh(cuda_device):
    from repro_torch.dist import make_mesh

    return make_mesh((2, 4), ("data", "model"), [cuda_device])


MESH_RULES = {"records": ("data", "model"), "queries": None}


@pytest.mark.parametrize("scheme,parity_min_batch,kernels", [
    ("chor", None, (xor_fold,)),
    ("chor", 8, (parity_matmul_packed,)),
    ("sparse", None, (fused_gather_fold, indices_from_mask)),
])
def test_each_shard_kernel_launches_on_a_mesh_of_the_card(
        cuda_device, scheme, parity_min_batch, kernels):
    """The reduced CT store over a (2, 4) mesh of the card: each server's
    answer launches its kernel once per position (8 a server), and the
    records equal the stored ones."""
    from repro_torch.configs import pir_ct
    from repro_torch.dist import DEFAULT_RULES, mesh_rules
    from repro_torch.serve import ShardedBackend

    cfg = dataclasses.replace(pir_ct.reduced(), scheme=scheme)
    store = make_synthetic_store(cfg.n_records, cfg.record_bytes, seed=0,
                                 device=cuda_device)
    pipe = pir_ct.make_serving_pipeline(
        cfg, store=store, seed=4, backend=ShardedBackend(
            store, parity_min_batch=parity_min_batch, device=cuda_device))
    picks = [0, 7, 2047, 1000, 3, 5, 9, 11]
    for i, q in enumerate(picks):
        assert pipe.submit(f"c{i}", q)
    before = [k.launches for k in kernels]
    mesh = _card_mesh(cuda_device)
    with mesh_rules(mesh, dict(DEFAULT_RULES, **MESH_RULES)):
        out = pipe.flush()
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        8 * cfg.d] * len(kernels)
    for i, q in enumerate(picks):
        np.testing.assert_array_equal(out[f"c{i}"], store.record_bytes(q))
    state = pipe.backend._mesh_db[id(mesh)]
    assert all(sh.device.type == "cuda" for sh in state["db"].shards)
    if parity_min_batch:
        assert all(sh.data.stride(0) == 1 for sh in state["planes"].shards)


def test_a_touched_shard_refresh_launches_scatter_rows_on_the_card(
        cuda_device):
    from repro_torch.core import make_scheme
    from repro_torch.db import Delta, VersionedStore
    from repro_torch.dist import DEFAULT_RULES, mesh_rules
    from repro_torch.serve import SchemeRouter, ShardedBackend

    live = VersionedStore(make_synthetic_store(1024, 64, seed=2,
                                               device=cuda_device), shards=8)
    backend = ShardedBackend(live.snapshot(), device=cuda_device)
    router = SchemeRouter(make_scheme("chor", d=2, d_a=1))
    mesh = _card_mesh(cuda_device)
    rules = dict(DEFAULT_RULES, **MESH_RULES)
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def answer(q):
        tq = router.plan(gen, live.n, torch.tensor(q, device=cuda_device))
        with mesh_rules(mesh, rules):
            return router.finalize(tq, backend.answer_batch(tq))

    answer([0, 1])
    ptrs = [sh.data.data_ptr() for sh in backend._mesh_db[id(mesh)]["db"].shards]
    delta = Delta.update([3, 300], np.full((2, 64), 5, np.uint8))
    touched = live.touched_rows(delta, n_before=live.n)
    live.ingest(delta)
    before = scatter_rows.launches
    counters = backend.swap_store(live.snapshot(), touched_rows=touched,
                                  live=live)
    assert scatter_rows.launches - before == 2
    assert (counters["mesh_shards_updated"], counters["mesh_shards_kept"]) \
        == (2, 6)
    now = [sh.data.data_ptr() for sh in backend._mesh_db[id(mesh)]["db"].shards]
    assert [a == b for a, b in zip(now, ptrs)] == [
        False, True, False, True, True, True, True, True]
    got = answer([3, 300, 4])
    assert torch.equal(got, live.snapshot().packed[[3, 300, 4]])


def test_an_answer_on_the_mesh_never_synchronizes_the_whole_device(
        cuda_device, monkeypatch):
    from repro_torch.configs import pir_ct
    from repro_torch.dist import DEFAULT_RULES, mesh_rules

    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (calls.append(a), real(*a, **k)))
    pipe = pir_ct.make_serving_pipeline(pir_ct.reduced(), seed=2)
    for i in range(8):
        assert pipe.submit(f"c{i}", 5 * i)
    with mesh_rules(_card_mesh(cuda_device), dict(DEFAULT_RULES,
                                                  **MESH_RULES)):
        out = pipe.flush()
    assert calls == []
    for i in range(8):
        np.testing.assert_array_equal(out[f"c{i}"],
                                      pipe.store.record_bytes(5 * i))


def test_flash_decode_on_a_mesh_of_the_card_matches_the_dense_decode(
        cuda_device):
    from repro_torch.dist import DEFAULT_RULES, make_mesh, mesh_rules
    from repro_torch.models import layers as L

    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(4, 1, 8, 64, device=cuda_device, generator=g)
    k = torch.randn(4, 64, 2, 64, device=cuda_device, generator=g)
    v = torch.randn(4, 64, 2, 64, device=cuda_device, generator=g)
    dense = L.decode_attention(q, k, v, 41, window=30)
    with mesh_rules(make_mesh((1, 4), ("data", "model"), [cuda_device]),
                    DEFAULT_RULES):
        got = L.decode_attention(q, k, v, 41, window=30,
                                 kv_seq_axes=("model",))
    torch.testing.assert_close(got, dense, rtol=2e-5, atol=2e-5)


def test_reduced_lm_family_on_the_card_matches_the_cpu(cuda_device):
    """gemma-2 (window, caps), Mistral-NeMo and Kimi-K2 ``reduced()`` in
    f32 on the card by default against the same weights on the CPU: every
    prefill layer launches the flash kernel; logits within 1e-4 after the
    prefill and two decode steps."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T

    for arch in ("gemma2-2b", "mistral-nemo-12b", "kimi-k2-1t-a32b"):
        cfg = get_arch(arch).reduced()
        lm = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
        lm_cpu = T.TransformerLM({**lm.tree()}, cfg).to("cpu")
        tokens = lm_batch(cfg, 2, 40, seed=0, step=0)["tokens"]
        launches = flash_attention_fwd.launches
        logits, cache = T.prefill(lm, cfg, tokens, 42)
        assert flash_attention_fwd.launches == launches + cfg.n_layers
        want, want_cache = T.prefill(lm_cpu, cfg, tokens, 42)
        torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
        for pos in (40, 41):
            tok = want.argmax(-1, keepdim=True)
            logits, cache = T.decode_step(lm, cfg, cache, tok.cuda(), pos)
            want, want_cache = T.decode_step(lm_cpu, cfg, want_cache, tok,
                                             pos)
            torch.testing.assert_close(logits.cpu(), want, rtol=1e-4,
                                       atol=1e-4)


def test_bf16_moonlight_reduced_prefill_on_the_card_matches_the_cpu(
        cuda_device):
    """The MoE block in bf16 on the card (``index_put_``, ``bmm``) against
    the CPU with the same weights. The card's attention keeps an f32
    softmax where the CPU's plain path rounds scores and probabilities to
    bf16 (hence 2e-2, as ``gqa_attention``'s bf16 check); the first
    layer's router, on the same f32 tokens, routes them exactly alike."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").reduced(),
                              dtype="bfloat16")
    lm = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    lm_cpu = T.TransformerLM({**lm.tree()}, cfg).to("cpu")
    assert lm.tree()["layers"]["moe"]["router"].dtype == torch.float32
    tokens = lm_batch(cfg, 2, 32, seed=0, step=0)["tokens"]
    launches = flash_attention_fwd.launches
    logits, _ = T.prefill(lm, cfg, tokens, 32)
    assert flash_attention_fwd.launches == launches + cfg.n_layers
    want, _ = T.prefill(lm_cpu, cfg, tokens, 32)
    torch.testing.assert_close(logits.cpu().float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    # routing in f32 (bf16 logits tie often: one rounding apart, the two
    # devices could order a tie differently)
    x = torch.randn((64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    p = {k: t[0] for k, t in lm.tree()["layers"]["moe"].items()}
    r = M.moe_route(x.cuda(), p["router"], top_k=cfg.top_k, capacity=16)
    r_cpu = M.moe_route(x, p["router"].cpu(), top_k=cfg.top_k, capacity=16)
    assert torch.equal(r.top_e.cpu(), r_cpu.top_e)
    assert torch.equal(r.keep.cpu(), r_cpu.keep)


# ------------------------------------ the other recommenders and the GCN
# record widths of the recommenders' tables: FM's linear table (1 word),
# FM (10) and DIEN (18)
@pytest.mark.parametrize("q", [8, 39, 100])
@pytest.mark.parametrize("w", [1, 10, 18])
def test_xor_fold_at_the_recommenders_widths_equals_plain(cuda_device, q, w):
    """Both forms over 4100 rows at the widths of FM's and DIEN's tables,
    q 39 one FM example's fields."""
    db, mask = _fold_operands(q, 4100, w, cuda_device, seed=q + w)
    _every_form(db, mask, _fold_plain(db, mask))


@pytest.mark.parametrize("q", [8, 32])
@pytest.mark.parametrize("w", [1, 10, 18])
@pytest.mark.parametrize("grid_order", ["qwm", "wqm"])
def test_gather_xor_at_the_recommenders_widths_equals_plain(cuda_device, q, w,
                                                           grid_order):
    store, _ = _case(4100, 4 * w, 1, cuda_device, seed=w)
    for kind in ("ascending", "shuffled", "duplicated"):
        idx = _gather_idx(store, q, kind, cuda_device, seed=q + w)
        launches = gather_xor.launches
        got = gather_xor(store.packed, idx, grid_order=grid_order)
        assert gather_xor.launches == launches + 1
        _same(got, gather_xor_plain(store.packed, idx))


def test_segment_sum_gives_the_same_bits_every_run(cuda_device):
    """Heavily duplicated segments (a few take most of the rows), summed
    five times on the card: the same bits each time, and the CPU's values
    within float tolerance."""
    from repro_torch.models.layers import segment_sum

    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        rng.standard_normal((200_000, 16)).astype(np.float32))
    seg = torch.from_numpy(rng.zipf(1.3, 200_000) % 300)
    card = data.to(cuda_device)
    first = segment_sum(card, seg.to(cuda_device), 300)
    for _ in range(4):
        _same(segment_sum(card, seg.to(cuda_device), 300), first)
    torch.testing.assert_close(first.cpu(), segment_sum(data, seg, 300),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_private_bags_on_the_card_equal_the_plain_bags(cuda_device, combiner):
    from repro_torch.core import PrivateEmbedding
    from repro_torch.models import recsys as R

    rng = np.random.default_rng(1)
    table = torch.from_numpy(
        rng.standard_normal((5000, 18)).astype(np.float32)).to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, 5000, 600)).to(cuda_device)
    seg = torch.from_numpy(rng.zipf(1.5, 600) % 40).to(cuda_device)
    pe = PrivateEmbedding.create(table, scheme="sparse", d=4, d_a=2,
                                 theta=0.25)
    folds = xor_fold.launches
    private = pe.bag_lookup(torch.Generator(device="cuda").manual_seed(0),
                            ids, seg, 40, combiner)
    assert xor_fold.launches == folds + 4
    _same(private, R.embedding_bag(table, ids, seg, 40, combiner))


def _card_and_cpu(model):
    """The model's weights on the card and the same tensors on the CPU."""
    return model, type(model)(model.tree(), model.cfg).to("cpu")


@pytest.mark.parametrize("arch", ["fm", "dlrm-rm2", "dien"])
def test_reduced_recommenders_on_the_card_match_the_cpu(cuda_device, arch):
    """Scores and the retrieval tower on the card by default against the
    CPU, and the private scores (Sparse-PIR through PrivateEmbedding, one
    store a table) equal to the plain ones bit for bit, 4 folds a call."""
    from repro_torch.configs import get_arch
    from repro_torch.core import PrivateEmbedding
    from repro_torch.data import recsys_batch
    from repro_torch.models import recsys as R

    cfg = get_arch(arch).reduced()
    init, score = {"fm": (R.fm_init, R.fm_score),
                   "dlrm-rm2": (R.dlrm_init, R.dlrm_score),
                   "dien": (R.dien_init, R.dien_score)}[arch]
    model, host = _card_and_cpu(
        init(torch.Generator(device="cuda").manual_seed(0), cfg))
    batch = recsys_batch(cfg, 16, seed=0, step=0)
    plain = score(model, cfg, batch)
    assert plain.device.type == "cuda"
    torch.testing.assert_close(plain.cpu(), score(host, cfg, batch),
                               rtol=1e-4, atol=1e-4)
    uv = R.user_vector(model, cfg, batch)
    cand = torch.randn((1000, cfg.embed_dim),
                       generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(
        R.retrieval_scores(uv, cand.to(cuda_device)).cpu(),
        R.retrieval_scores(R.user_vector(host, cfg, batch), cand),
        rtol=1e-4, atol=1e-4)

    gen, pes, calls = torch.Generator(device="cuda").manual_seed(2), {}, []

    def lookup(table, ids):
        pe = pes.setdefault(table.data_ptr(), PrivateEmbedding.create(
            table, scheme="sparse", d=4, d_a=2, theta=0.25))
        folds = xor_fold.launches
        rows = pe.lookup(gen, ids)
        calls.append(xor_fold.launches - folds)
        return rows

    _same(score(model, cfg, batch, lookup_fn=lookup), plain)
    assert calls == [4] * {"fm": 2, "dlrm-rm2": 1, "dien": 2}[arch]


def test_reduced_dlrm_through_the_pipeline_on_the_card(cuda_device):
    """Each example's ids as one submit_many request on the card (the
    sparse path: indices_from_mask and gather_xor d times a flush), then
    the same requests from the cache with no launch; bit-equal scores."""
    from repro_torch.configs import get_arch
    from repro_torch.core import SparseScheme
    from repro_torch.data import recsys_batch
    from repro_torch.db.store import RecordStore
    from repro_torch.models import recsys as R
    from repro_torch.serve import (
        BatchScheduler, QueryCache, ServingPipeline, ShardedBackend,
    )

    cfg = get_arch("dlrm-rm2").reduced()
    model = R.dlrm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    table = model.tree()["embed"]
    store = RecordStore.from_float_table(table)
    scheme = SparseScheme(d=4, d_a=2, theta=0.25)
    # no shared memory for the fused form: the sparse pair, as at full size
    pipe = ServingPipeline(store, scheme,
                           scheduler=BatchScheduler(max_batch=32),
                           backend=ShardedBackend(store, smem_budget_bytes=1),
                           cache=QueryCache(scheme, store.n, max_entries=256),
                           seed=3)

    def lookup(tbl, ids):
        rows = []
        for j, row in enumerate(ids.tolist()):
            assert pipe.submit_many(f"user{j}", row)
            rows.append(pipe.flush()[f"user{j}"])
        raw = np.ascontiguousarray(np.stack(rows))
        return torch.from_numpy(raw.view(np.float32)).reshape(
            *ids.shape, tbl.shape[1]).to(tbl.device)

    batch = recsys_batch(cfg, 3, seed=1, step=0)
    plain = R.dlrm_score(model, cfg, batch)
    before = (indices_from_mask.launches, gather_xor.launches)
    _same(R.dlrm_score(model, cfg, batch, lookup_fn=lookup), plain)
    assert (indices_from_mask.launches - before[0],
            gather_xor.launches - before[1]) == (12, 12)
    before = (indices_from_mask.launches, gather_xor.launches,
              xor_fold.launches)
    _same(R.dlrm_score(model, cfg, batch, lookup_fn=lookup), plain)
    assert (indices_from_mask.launches, gather_xor.launches,
            xor_fold.launches) == before
    assert pipe.metrics["cache_hits"] == 3 * cfg.n_sparse


def test_reduced_gcn_on_the_card_matches_the_cpu(cuda_device):
    """Full-batch (unsharded and on a (2, 4) mesh of the card), sampled and
    batched GCN on the card against the CPU with the same weights."""
    from repro_torch.configs import get_arch
    from repro_torch.data import NeighborSampler, gnn_full_graph, molecule_batch
    from repro_torch.dist import DEFAULT_RULES, make_mesh, mesh_rules
    from repro_torch.models import gnn as G

    cfg = get_arch("gcn-cora").CONFIG
    g = gnn_full_graph(2000, 9000, 24, cfg.n_classes, seed=0, pad_to=8)
    model, host = _card_and_cpu(
        G.gcn_init(torch.Generator(device="cuda").manual_seed(0), cfg, 24))
    args = [g[k] for k in ("feats", "src", "dst", "edge_w")]
    got = G.gcn_apply(model, cfg, *args)
    want = G.gcn_apply(host, cfg, *args)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    with mesh_rules(make_mesh((2, 4), ("data", "model"), [cuda_device]),
                    DEFAULT_RULES):
        sharded = G.gcn_apply(model, cfg, *args, g["mean_deg"])
    torch.testing.assert_close(sharded.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        G.node_xent(got, g["labels"], g["label_mask"]).cpu(),
        G.node_xent(want, g["labels"], g["label_mask"]), rtol=1e-4, atol=1e-4)

    sampler = NeighborSampler.random_graph(3000, 20, 24, cfg.n_classes)
    sub = sampler.sample(np.arange(64))
    args = [sub[k] for k in ("feats", "src", "dst", "edge_w")]
    torch.testing.assert_close(G.gcn_apply(model, cfg, *args).cpu(),
                               G.gcn_apply(host, cfg, *args),
                               rtol=1e-4, atol=1e-4)
    mol = molecule_batch(16, 30, 64, 24, cfg.n_classes, seed=0, step=0)
    args = [mol[k] for k in ("feats", "src", "dst", "edge_w")]
    torch.testing.assert_close(G.batched_graph_apply(model, cfg, *args).cpu(),
                               G.batched_graph_apply(host, cfg, *args),
                               rtol=1e-4, atol=1e-4)


def test_a_sparse_plan_past_the_cards_draws_is_drawn_right(cuda_device):
    """torch.multinomial writes out of bounds past 2^30 - 1 draws in one
    call on the card; a plan of more (1025 lookups over 2^20 records:
    1.07·10^9 column weights) is drawn in chunks within the limit: its
    parities and row-weight law hold and every record is recovered
    exactly; the context stays usable."""
    import math

    from repro_torch.core import sparse

    n, b, d, theta = 1 << 20, 1025, 4, 0.25
    assert n * b > sparse.MAX_CARD_DRAWS
    gen = torch.Generator(device="cuda").manual_seed(0)
    pre = sparse.precompute_query_randomness(gen, n, d, theta, b)
    torch.cuda.synchronize()
    assert pre.w_even.shape == (b, n) and pre.w_even.dtype == torch.uint8
    assert int((pre.w_even % 2).sum()) == 0
    assert int((pre.w_q % 2).min()) == 1
    assert tuple(pre.key.shape) == (2,) and pre.key.device.type == "cuda"
    # the law of tests/test_torch_schemes.py: each server's mean row weight
    # within 6 sigma of n·P[bit = 1 | even column]
    x = (1 - 2 * theta) ** d
    p_even = theta * (1 - x / (1 - 2 * theta)) / (1 + x)
    q_idx = torch.randint(0, n, (b,), generator=torch.Generator().manual_seed(1),
                          dtype=torch.int32).to("cuda")
    m = sparse.assemble_query_matrix(pre, q_idx)
    weights = m.sum(-1, dtype=torch.float64)      # [d, B]
    sigma_mean = math.sqrt(n * p_even * (1 - p_even) / (d * b))
    assert abs(float(weights.mean()) - p_even * n) < 6 * sigma_mean
    del m, pre
    store = make_synthetic_store(n, 4, seed=2, device=cuda_device)
    out = sparse.retrieve(gen, store, d, theta, q_idx)
    _same(out, store.packed[q_idx.long()])


# ---------------------------------------------------------------- training
def _grads_of(loss_fn, params, batch):
    """(loss, gradients in leaf order) of ``loss_fn`` at ``params``."""
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import value_and_grad

    loss, _, grads = value_and_grad(loss_fn, params, batch)
    return loss, tree_leaves(grads)


def _close_scaled(got, want, tol):
    """|got - want| <= tol · max|want| (one scale a tensor)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{err} > {tol} x {scale}"


def test_bert4rec_loss_gradients_on_the_card_equal_the_cpus(cuda_device):
    """Queue C's fault 1: on the card the attention's output carries a
    gradient (the flash kernel forward, the plain path backward), so every
    weight of BERT4Rec's loss gets the CPU's gradient."""
    from repro_torch.configs import get_arch
    from repro_torch.data import bert4rec_batch
    from repro_torch.models import recsys as R
    from repro_torch.train.train_step import recsys_loss_fn

    cfg = get_arch("bert4rec").reduced()
    model = R.bert4rec_init(torch.Generator(device="cuda").manual_seed(1), cfg)
    tree = model.tree()
    host = R.BERT4Rec(tree, cfg).to("cpu").tree()
    batch = bert4rec_batch(cfg, 4, seed=0, step=0)
    launches = flash_attention_fwd.launches
    loss, grads = _grads_of(recsys_loss_fn(cfg), tree, batch)
    assert flash_attention_fwd.launches == launches + cfg.n_blocks
    want_loss, want = _grads_of(recsys_loss_fn(cfg), host, batch)
    torch.testing.assert_close(loss.cpu(), want_loss, rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, want):
        assert float(w.abs().max()) > 0
        _close_scaled(g, w, 1e-4)


ATTN_GRAD_SETTINGS = [dict(causal=True, window=None, cap=0.0),
                      dict(causal=True, window=24, cap=0.0),
                      dict(causal=False, window=None, cap=0.0),
                      dict(causal=True, window=None, cap=20.0)]


@pytest.mark.parametrize("setting", ATTN_GRAD_SETTINGS,
                         ids=["causal", "window", "bidirectional", "cap"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_gradients_on_the_card_equal_the_cpus(cuda_device, dtype,
                                                        d, setting):
    """Through ``gqa_attention`` (GQA 4/2): the output carries a grad_fn,
    the forward launches the kernel once, and q's, k's and v's gradients
    equal the CPU's plain path's (f32: 1e-5 of the largest; bf16: 3e-2,
    the plain path's bf16 scores and softmax rounded on both sides). Under
    ``no_grad`` the output has no grad_fn, and the kernel launches once."""
    from repro_torch.models import layers as L

    gen = torch.Generator().manual_seed(d)
    b, s, hq, hkv = 2, 80, 4, 2
    base = [torch.randn((b, s, h, d), generator=gen) for h in (hq, hkv, hkv)]
    w = torch.randn((b, s, hq, d), generator=gen)
    kw = dict(causal=setting["causal"], window=setting["window"],
              attn_softcap=setting["cap"])

    def grads(device):
        q, k, v = (t.to(device, dtype).requires_grad_() for t in base)
        out = L.gqa_attention(q, k, v, **kw)
        assert out.grad_fn is not None
        torch.sum(out.float() * w.to(device)).backward()
        return [t.grad for t in (q, k, v)]

    launches = flash_attention_fwd.launches
    got = grads(cuda_device)
    assert flash_attention_fwd.launches == launches + 1
    want = grads("cpu")
    for g, wt in zip(got, want):
        _close_scaled(g, wt, 1e-5 if dtype == torch.float32 else 3e-2)
    with torch.no_grad():
        q, k, v = (t.to(cuda_device, dtype).requires_grad_() for t in base)
        out = L.gqa_attention(q, k, v, **kw)
    assert out.grad_fn is None
    assert flash_attention_fwd.launches == launches + 2


@pytest.mark.parametrize("model", ["smollm", "bert4rec"])
def test_one_training_step_on_the_card_matches_the_cpu(cuda_device, model):
    """A reduced SmolLM step (f32, remat on, loss chunks of 8) and a
    BERT4Rec step by ``make_train_step`` with AdamW on the card, against
    the same step on the CPU from the same weights: the gradients within
    1e-4 of each leaf's largest, the loss and the updated parameters
    within 1e-5 (the embedding's and the gathers' backward add by atomics
    on the card)."""
    import dataclasses as dc

    from repro_torch.configs import get_arch
    from repro_torch.data import bert4rec_batch, lm_batch
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_step import lm_loss_fn, recsys_loss_fn

    if model == "smollm":
        cfg = dc.replace(get_arch("smollm-135m").reduced(), remat=True,
                         loss_chunk=8)
        tree = T.init_lm(torch.Generator(device="cuda").manual_seed(0),
                         cfg).tree()
        loss_fn = lm_loss_fn(cfg)
        batch = {"tokens": lm_batch(cfg, 4, 32, seed=0, step=0)["tokens"]}
        per_step = 2 * cfg.n_layers     # the forward and the remat
    else:
        cfg = get_arch("bert4rec").reduced()
        tree = R.bert4rec_init(torch.Generator(device="cuda").manual_seed(1),
                               cfg).tree()
        loss_fn = recsys_loss_fn(cfg)
        batch = bert4rec_batch(cfg, 4, seed=0, step=0)
        per_step = cfg.n_blocks
    host = tree_map(lambda t: t.detach().cpu(), tree)
    launches = flash_attention_fwd.launches
    _, grads = _grads_of(loss_fn, tree, batch)
    assert flash_attention_fwd.launches == launches + per_step
    _, want_grads = _grads_of(loss_fn, host, batch)
    for g, w in zip(grads, want_grads):
        _close_scaled(g, w, 1e-4)
    lr = 1e-3
    init_fn, step_fn = make_train_step(loss_fn, AdamW(lr=lr))
    state, metrics = step_fn(init_fn(tree), batch)
    want_state, want = step_fn(init_fn(host), batch)
    torch.testing.assert_close(metrics["loss"].cpu(), want["loss"],
                               rtol=1e-5, atol=1e-5)
    # AdamW's first step is ≈ lr·g/(|g| + eps): held where the CPU's
    # gradient is above 1e-4 of its leaf's largest, else each side's move
    # to lr (1 + wd·|p|)
    for got, ref, p0, g in zip(tree_leaves(state.params),
                               tree_leaves(want_state.params),
                               tree_leaves(host), want_grads):
        got, big = got.cpu(), g.abs() > 1e-4 * float(g.abs().max())
        torch.testing.assert_close(got[big], ref[big], rtol=1e-5, atol=1e-5)
        bound = lr * (1 + 0.01 * p0[~big].abs()) * (1 + 1e-5) + 1e-7
        assert bool(((got[~big] - p0[~big]).abs() <= bound).all())
        assert bool(((ref[~big] - p0[~big]).abs() <= bound).all())


# ------------------------------------------------ the cells (launch/cells.py)
@pytest.mark.parametrize("variant", ["baseline", "bf16", "reshard", "xorbfly"])
def test_pir_cells_on_the_card_equal_the_cpus(cuda_device, monkeypatch,
                                              variant):
    """A pir-ct cell at a cut n (5000 records of the CT width, 64 queries)
    built on the CPU, then its masks and planes copied to the card: the
    card's answer equals the CPU's bit for bit, on a (2, 4) mesh of each
    (records over both axes for reshard and xorbfly), and every variant
    but the f32 baseline launches the parity kernel (8 a run on the
    mesh for xorbfly)."""
    from repro_torch.configs import pir_ct
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist import DEFAULT_RULES, make_mesh, mesh_rules
    from repro_torch.launch import cells as C

    monkeypatch.setenv("REPRO_PIR_VARIANT", variant)
    cfg = dataclasses.replace(pir_ct.reduced(), n_records=5000,
                              record_bytes=1536)
    sp = ShapeSpec.make("serve_batch", "pir_serve", query_batch=64)
    rules = dict(DEFAULT_RULES, **C.rules_for_cell(sp))
    axes = ("data", "model")
    with mesh_rules(make_mesh((2, 4), axes, ["cpu"]), rules):
        cell = C.build_cell_sanitized("pir-ct", sp, device="cpu", seed=4,
                                      cfg=cfg)
        want = cell.fn(*cell.args)
    card = C.cell_to_device(cell, cuda_device)
    before = parity_matmul_packed.launches
    with mesh_rules(make_mesh((2, 4), axes, [cuda_device]), rules):
        got = card.fn(*card.args)
    launched = parity_matmul_packed.launches - before
    assert torch.equal(got.cpu(), want)
    assert launched == {"baseline": 0, "bf16": 1, "reshard": 1,
                        "xorbfly": 8}[variant]
