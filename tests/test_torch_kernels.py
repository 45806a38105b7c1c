"""Port vs reference: the four GF(2) answer functions (tolerance zero).

Seeded numpy inputs go through the JAX kernel (Pallas in interpret mode),
the JAX oracle (``repro.kernels.ref``) and the port's function on the CPU,
where a wrapper takes its plain PyTorch version — the arithmetic the CUDA
kernels are held to on the card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.db import make_synthetic_store as ref_make_store
from repro.db import packing as ref_packing
from repro.kernels import (
    fused_block_w as ref_fused_block_w,
    fused_gather_fold as ref_fused_gather_fold,
    gather_xor as ref_gather_xor,
    indices_from_mask as ref_indices_from_mask,
    ops as ref_ops,
    parity_matmul as ref_parity_matmul,
    ref as ref_oracles,
    xor_fold as ref_xor_fold,
)
from repro_torch.db import make_synthetic_store, packing
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused import (
    CLUSTER_MAX,
    FUSED_SMEM_FALLBACK_BYTES,
    ROWS_PER_CTA_MAX,
    TMA_MIN_WORDS,
    WARPS,
    fused_block_w,
    fused_gather_fold,
    fused_schedule,
    fused_smem_budget,
)
from repro_torch.kernels.gather_xor import (
    gather_schedule,
    gather_xor,
    indices_from_mask,
    indices_from_mask_plain,
)
from repro_torch.kernels.parity_matmul import (
    _planes_storage,
    _rows_on_16_bytes,
    parity_matmul,
    parity_matmul_packed,
    parity_matmul_packed_plain,
    parity_matmul_plain,
)
from repro_torch.kernels.xor_fold import (
    FORMS,
    MAX_QUERIES,
    MAX_WORDS,
    TABLE_MIN_QUERIES,
    TABLE_WIDE_MIN_QUERIES,
    TABLE_WIDTHS,
    _check_limits,
    _form_for,
    _launch,
    _table_width,
    xor_fold,
)

from _torch_parity import messy_index_rows, seeded_mask, words_t2n

SHAPES = [
    # (n records, record_bytes, q queries)
    (64, 8, 1),
    (100, 12, 5),       # ragged W
    (256, 64, 16),
    (300, 50, 17),      # everything ragged
    (1024, 4, 33),      # tiny records
    (37, 129, 3),       # W > block
]
EDGE_SHAPES = [(1, 8, 1), (1, 24, 5), (2, 4, 1), (7, 129, 1)]
NONPOW2_SHAPES = [(91, 12, 3), (137, 24, 7), (333, 36, 5), (1000, 20, 11),
                  (63, 129, 9)]
MASK_DTYPES = [(torch.uint8, jnp.uint8), (torch.int32, jnp.int32),
               (torch.bool, jnp.bool_)]


def _case(n, rb, q, seed=0):
    """The same store and mask for both packages."""
    rstore = ref_make_store(n=n, record_bytes=rb, seed=seed)
    tstore = make_synthetic_store(n, rb, seed=seed, device="cpu")
    mask = seeded_mask(q, n, seed + 1)
    return rstore, tstore, mask


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(words_t2n(got), np.asarray(want))


@pytest.mark.parametrize("n,rb,q", SHAPES + EDGE_SHAPES + NONPOW2_SHAPES)
def test_xor_fold_equals_reference(n, rb, q):
    rs, ts, mask = _case(n, rb, q)
    got = xor_fold(ts.packed, torch.from_numpy(mask))
    _eq(got, ref_xor_fold(rs.packed, jnp.asarray(mask), interpret=True))
    _eq(got, ref_oracles.xor_fold_ref(rs.packed, jnp.asarray(mask)))
    _eq(ref.xor_fold_ref(ts.packed, torch.from_numpy(mask)), np.asarray(
        ref_oracles.xor_fold_ref(rs.packed, jnp.asarray(mask))))


@pytest.mark.parametrize("tdtype,jdtype", MASK_DTYPES)
def test_xor_fold_mask_dtypes(tdtype, jdtype):
    rs, ts, mask = _case(128, 16, 7)
    got = xor_fold(ts.packed, torch.from_numpy(mask).to(tdtype))
    _eq(got, ref_xor_fold(rs.packed, jnp.asarray(mask).astype(jdtype),
                          interpret=True))


@pytest.mark.parametrize("n,rb,q", [(1000, 16, 300), (4099, 12, 257),
                                    (64, 1540, 1000)])
def test_xor_fold_large_batches_equal_the_oracle(n, rb, q):
    """Batches the table form takes on the card, against the jnp oracle."""
    rs, ts, mask = _case(n, rb, q, seed=q)
    _eq(xor_fold(ts.packed, torch.from_numpy(mask)),
        ref_oracles.xor_fold_ref(rs.packed, jnp.asarray(mask)))


@pytest.mark.parametrize("q,form,width", [
    (1, "stream", 8), (8, "stream", 8), (9, "table", 8), (64, "table", 8),
    (65, "table", 32), (128, "table", 32), (6400, "table", 32)])
def test_xor_fold_form_follows_the_batch(q, form, width):
    """The streaming form reads the store once per 8 queries; from the 9th
    query on the table form answers, its warps 8 queries wide up to 64
    queries and 32 from the 65th (the measured switches)."""
    assert TABLE_MIN_QUERIES == 9 and FORMS == ("stream", "table")
    assert TABLE_WIDE_MIN_QUERIES == 65 and TABLE_WIDTHS == (8, 32)
    assert _form_for(q) == form
    assert _table_width(q) == width


def test_xor_fold_refuses_what_the_grids_cannot_hold():
    for form in FORMS:
        _check_limits(form, MAX_QUERIES[form], MAX_WORDS)
        with pytest.raises(ValueError, match="queries"):
            _check_limits(form, MAX_QUERIES[form] + 1, 1)
        with pytest.raises(ValueError, match="words a record"):
            _check_limits(form, 1, MAX_WORDS + 1)
    assert MAX_QUERIES == {"stream": 65535 * 8, "table": 65535 * 256}
    with pytest.raises(ValueError, match="unknown xor_fold form"):
        _check_limits("dense", 1, 1)
    # a forced warp width: 8 warps of it a block, 65535 blocks
    for width in TABLE_WIDTHS:
        _check_limits("table", 65535 * 8 * width, 1, width)
        with pytest.raises(ValueError, match="table form takes at most"):
            _check_limits("table", 65535 * 8 * width + 1, 1, width)
    for form, width in [("table", 16), ("stream", 8)]:
        with pytest.raises(ValueError, match="queries a warp"):
            _check_limits(form, 1, 1, width)
    # the CPU path checks as the card does, before any arithmetic
    with pytest.raises(ValueError, match="table form takes at most"):
        xor_fold(torch.zeros((1, 1), dtype=torch.int32),
                 torch.zeros((MAX_QUERIES["table"] + 1, 1), dtype=torch.bool))
    with pytest.raises(ValueError, match="words a record"):
        xor_fold(torch.zeros((1, MAX_WORDS + 1), dtype=torch.int32),
                 torch.ones((1, 1), dtype=torch.uint8))


def test_xor_fold_forms_launch_only_for_tensors_on_the_card():
    """No form runs its plain version: on the CPU the launch helper raises,
    and the wrapper's plain path counts no launch of either form."""
    _, ts, mask = _case(32, 8, 12)
    tmask = torch.from_numpy(mask)
    before = dict(xor_fold.kernel_launches)
    for form in FORMS:
        with pytest.raises(ValueError, match="on the card"):
            _launch(ts.packed, tmask, form)
    xor_fold(ts.packed, tmask)
    assert xor_fold.kernel_launches == before


@pytest.mark.parametrize("n,rb,q", SHAPES + NONPOW2_SHAPES)
def test_parity_matmul_equals_reference(n, rb, q):
    rs, ts, mask = _case(n, rb, q, seed=n + 1)
    got = parity_matmul(torch.from_numpy(mask), ts.bitplanes())
    assert got.dtype == torch.uint8
    want = np.asarray(ref_parity_matmul(
        jnp.asarray(mask), rs.bitplanes(), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref_oracles.parity_matmul_ref(jnp.asarray(mask), rs.bitplanes())))
    np.testing.assert_array_equal(
        ref.parity_matmul_ref(torch.from_numpy(mask), ts.bitplanes()).numpy(),
        want)


@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32,
                                      torch.bfloat16, torch.int32])
def test_parity_matmul_input_dtypes(in_dtype):
    rs, ts, mask = _case(128, 16, 9)
    got = parity_matmul(torch.from_numpy(mask).to(in_dtype),
                        ts.bitplanes().to(in_dtype))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref_oracles.parity_matmul_ref(jnp.asarray(mask), rs.bitplanes())))


# (n, record_bytes, q, B): the first B bit columns of the planes; None =
# all 32·W of them
PACKED_SHAPES = ([(n, rb, q, None) for n, rb, q in SHAPES + NONPOW2_SHAPES]
                 + [(100, 12, 5, 33), (300, 50, 17, 1), (256, 64, 16, 257),
                    (1000, 20, 11, 100), (137, 24, 1, None),
                    (64, 8, 1, 31)])


@pytest.mark.parametrize("n,rb,q,b", PACKED_SHAPES)
@pytest.mark.parametrize("layout", ["rows", "n_contiguous"])
def test_packed_parity_equals_reference(n, rb, q, b, layout):
    """The packed form (the parity path's answer) is pack_bits of the
    bits, the plain fold, and the reference's parity path (Pallas in
    interpret mode), with the planes in either layout; ragged last words
    keep zero high bits."""
    rs, ts, mask = _case(n, rb, q, seed=n + q)
    tplanes = ts.bitplanes()
    if layout == "rows":
        tplanes = tplanes.contiguous()
    rplanes = rs.bitplanes()
    if b is not None:
        tplanes, rplanes = tplanes[:, :b], rplanes[:, :b]
    tmask = torch.from_numpy(mask)
    got = parity_matmul_packed(tmask, tplanes)
    assert got.dtype == packing.WORD_DTYPE
    assert got.shape == (q, -(-tplanes.shape[1] // 32))
    assert torch.equal(got, parity_matmul_packed_plain(tmask, tplanes))
    assert torch.equal(got, packing.pack_bits(parity_matmul_plain(tmask,
                                                                  tplanes)))
    _eq(got, ref_packing.pack_bits(ref_parity_matmul(
        jnp.asarray(mask), rplanes, interpret=True)))
    if b is None:
        _eq(got, ref_ops.server_answer_parity(rplanes, jnp.asarray(mask)))
        assert torch.equal(got, ref.xor_fold_ref(ts.packed, tmask))
    else:
        tail = tplanes.shape[1] % 32
        if tail:
            assert int((got[:, -1].view(torch.int32) >> tail).abs().sum()) == 0


def test_packed_parity_counts_no_launch_on_the_cpu():
    _, ts, mask = _case(64, 8, 3)
    before = (parity_matmul_packed.launches, parity_matmul.launches)
    ops.server_answer_parity(ts.bitplanes(), torch.from_numpy(mask))
    parity_matmul_packed(torch.from_numpy(mask), ts.bitplanes())
    assert before == (parity_matmul_packed.launches, parity_matmul.launches)


def test_planes_reach_the_kernel_in_the_layout_they_lie_in():
    """[n, B] planes go as [n, B]; the [n, B] view of an n-contiguous
    [B, n] tensor (the serving path's) goes as the [B, n] tensor, with no
    copy either way."""
    _, ts, _ = _case(300, 12, 1)
    cols = ts.bitplanes()
    rows = cols.contiguous()
    assert torch.equal(rows, cols) and cols.t().is_contiguous()
    storage, k_major = _planes_storage(rows)
    assert storage is rows and not k_major
    storage, k_major = _planes_storage(cols)
    assert k_major and storage.is_contiguous()
    assert storage.data_ptr() == cols.data_ptr()
    storage, k_major = _planes_storage(cols[16:160])  # a slice of records
    assert k_major and storage.stride() == (300, 1)


@pytest.mark.parametrize("rows,cols,offset", [(3, 32, 0), (3, 33, 0),
                                              (5, 2222, 0), (2, 48, 1),
                                              (1, 1, 0)])
def test_operands_reach_the_kernel_on_16_byte_rows(rows, cols, offset):
    """What the wrapper hands the kernel's TMA loads: the tensor itself
    when its rows start on 16 bytes, else a copy into rows padded to a
    multiple of 16 holding the same bytes; a row stride of 16 bytes'
    multiple either way."""
    flat = (torch.arange(rows * cols + offset) % 251).to(torch.uint8)
    x = flat[offset:].reshape(rows, cols)
    assert x.data_ptr() % 16 == offset
    got, ld = _rows_on_16_bytes(x)
    assert ld % 16 == 0 and ld >= cols and got.data_ptr() % 16 == 0
    assert rows == 1 or got.stride() == (ld, 1)
    assert torch.equal(got[:, :cols], x)
    if (rows == 1 or cols % 16 == 0) and x.data_ptr() % 16 == 0:
        assert got is x


@pytest.mark.parametrize("mask_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("packed", [False, True])
def test_parity_counts_integer_operands_by_their_values_mod_2(mask_dtype,
                                                             packed):
    """Operand values in {0, 1, 2, 3}: the reference reduces the product
    of the values as they are mod 2, so a 2 counts as 0 and a 3 as 1."""
    rng = np.random.default_rng(31)
    q, n, b = 5, 300, 40
    mask = rng.integers(0, 4, size=(q, n)).astype(mask_dtype)
    planes = rng.integers(0, 4, size=(n, b)).astype(np.uint8)
    want = np.asarray(ref_oracles.parity_matmul_ref(jnp.asarray(mask),
                                                    jnp.asarray(planes)))
    tmask, tplanes = torch.from_numpy(mask), torch.from_numpy(planes)
    if packed:
        got = parity_matmul_packed(tmask, tplanes)
        _eq(got, ref_packing.pack_bits(jnp.asarray(want)))
    else:
        np.testing.assert_array_equal(parity_matmul(tmask, tplanes).numpy(),
                                      want)
    # the low bits alone give the same answer: what the card multiplies
    low = parity_matmul_plain(tmask & 1, tplanes & 1)
    np.testing.assert_array_equal(low.numpy(), want)


@pytest.mark.parametrize("kind", ["shuffled", "duplicated", "padded"])
@pytest.mark.parametrize("grid_order", ["qwm", "wqm"])
def test_gather_xor_on_unordered_ids_equals_reference(kind, grid_order):
    """Index rows as no compaction emits them: every occurrence folds, so
    a duplicated id cancels, and -1 may sit anywhere."""
    rs, ts, _ = _case(257, 20, 6, seed=13)
    idx = messy_index_rows(np.random.default_rng(17), 257, 6, 96, kind)
    got = gather_xor(ts.packed, torch.from_numpy(idx), block_w=64,
                     grid_order=grid_order)
    _eq(got, ref_gather_xor(rs.packed, jnp.asarray(idx), block_w=64,
                            grid_order=grid_order, interpret=True))
    _eq(got, ref_oracles.gather_xor_ref(rs.packed, jnp.asarray(idx)))
    assert int(got[-1].abs().sum()) == 0
    if kind == "duplicated":
        # the rows named an odd number of times, each once, ascending
        odd = [np.sort(np.unique(r[r >= 0])[np.unique(
            r[r >= 0], return_counts=True)[1] % 2 == 1]) for r in idx]
        once = np.full_like(idx, -1)
        for r, ids in enumerate(odd):
            once[r, : len(ids)] = ids
        assert torch.equal(got, gather_xor(ts.packed, torch.from_numpy(once)))


@pytest.mark.parametrize("n,w,q,m,block_w,sms", [
    (10**6, 384, 8, 252_600, 128, 132), (10**6, 384, 32, 252_600, 32, 132),
    (10**6, 384, 1, 252_600, 128, 132), (2048, 16, 8, 632, 128, 132),
    (5, 3, 2, 4, 8, 1), (2**31 - 1, 1, 1, 1, 128, 132),
    (10**7, 8, 70, 10**5, 1, 16)])
def test_gather_schedule_fits_the_grid(n, w, q, m, block_w, sms):
    """Ranges of whole 256-row multiples cover n (none for one query); the
    walk chunks cover m; ranges and walk chunks share the grid's y axis
    (at most 65535); a range's query sets fit shared memory."""
    s = gather_schedule(n, w, q, m, block_w, sms)
    assert s["rows"] % 256 == 0 and s["rows"] >= 256
    if q == 1:  # one query shares no row: its list is walked
        assert s["ranges"] == 0
    else:
        assert s["ranges"] == -(-n // s["rows"])
        assert (s["ranges"] - 1) * s["rows"] < n <= s["ranges"] * s["rows"]
    assert s["ranges"] + s["walk_chunks"] <= 65535
    assert (s["walk_chunks"] - 1) * s["walk_per"] < m
    assert m <= s["walk_chunks"] * s["walk_per"]
    if n <= 8192 * (65535 - s["walk_chunks"]):
        assert s["rows"] <= 8192
    # sel[] (4 bytes a row) and the live list (2) fit a Hopper block
    assert s["rows"] * 6 + 4096 <= 232_448 and s["rows"] <= 65536


@pytest.mark.parametrize("n,rb,q", SHAPES + NONPOW2_SHAPES)
def test_gather_xor_equals_reference(n, rb, q):
    rs, ts, mask = _case(n, rb, q, seed=n)
    m = min(n, 192)
    ridx = ref_indices_from_mask(jnp.asarray(mask), m)
    tidx = indices_from_mask(torch.from_numpy(mask), m)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(ridx))
    got = gather_xor(ts.packed, tidx)
    _eq(got, ref_gather_xor(rs.packed, ridx, interpret=True))
    _eq(got, ref_oracles.gather_xor_ref(rs.packed, ridx))
    _eq(ref.gather_xor_ref(ts.packed, tidx),
        ref_oracles.gather_xor_ref(rs.packed, ridx))


@pytest.mark.parametrize("grid_order", ["qwm", "wqm"])
@pytest.mark.parametrize("block_w", [8, 16, 64])
def test_gather_xor_grid_order_and_block_sweep(grid_order, block_w):
    rs, ts, mask = _case(211, 21, 6, seed=5)
    ridx = ref_indices_from_mask(jnp.asarray(mask), 120)
    tidx = indices_from_mask(torch.from_numpy(mask), 120)
    got = gather_xor(ts.packed, tidx, block_w=block_w, grid_order=grid_order)
    _eq(got, ref_gather_xor(rs.packed, ridx, block_w=block_w,
                            grid_order=grid_order, interpret=True))


@pytest.mark.parametrize("fn", [gather_xor, fused_gather_fold])
def test_all_padding_rows_answer_zero(fn):
    _, ts, _ = _case(64, 8, 2)
    idx = torch.full((2, 16), -1, dtype=torch.int32)
    assert int(fn(ts.packed, idx).abs().sum()) == 0


@pytest.mark.parametrize("fn,bad", [(gather_xor, "qw"), (fused_gather_fold, "qwm")])
def test_grid_order_is_validated(fn, bad):
    _, ts, _ = _case(16, 8, 2)
    idx = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="grid_order"):
        fn(ts.packed, idx, grid_order=bad)


@pytest.mark.parametrize("q,n,m", [(6, 150, 150), (4, 90, 8), (3, 64, 1),
                                   (5, 33, 40)])
def test_indices_from_mask_round_trip_and_truncation_parity(q, n, m):
    """Same ids, same order, and — when a row is heavier than m — the same
    lowest column ids kept as the reference's stable sort keeps."""
    mask = seeded_mask(q, n, seed=q + n)
    m_eff = min(m, n)
    got = indices_from_mask(torch.from_numpy(mask), m_eff).numpy()
    want = np.asarray(ref_indices_from_mask(jnp.asarray(mask), m_eff))
    np.testing.assert_array_equal(got, want)
    for row in range(q):
        live = got[row][got[row] >= 0].tolist()
        assert live == np.nonzero(mask[row])[0][:m_eff].tolist()


def _edge_mask(q, n, seed):
    """Seeded rows plus an all-zero and an all-one row."""
    mask = seeded_mask(q, n, seed)
    mask[0] = 0
    mask[-1] = 1
    return mask


@pytest.mark.parametrize("q,n,m", [(5, 300, 300), (5, 300, 40), (4, 97, 97),
                                   (3, 64, 1), (6, 1000, 450)])
@pytest.mark.parametrize("tdtype,jdtype", MASK_DTYPES)
def test_indices_from_mask_edges_equal_reference(q, n, m, tdtype, jdtype):
    """All-zero and all-one rows, m = n and a truncating m, in every mask
    dtype; the plain version is the wrapper's on the CPU."""
    mask = _edge_mask(q, n, seed=n + m)
    want = np.asarray(ref_indices_from_mask(
        jnp.asarray(mask).astype(jdtype), m))
    tmask = torch.from_numpy(mask).to(tdtype)
    got = indices_from_mask(tmask, m)
    assert got.dtype == torch.int32 and got.shape == (q, m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, indices_from_mask_plain(tmask, m))
    assert (got[0] == -1).all()
    assert got[-1].tolist() == list(range(m))


def test_indices_from_mask_counts_values_other_than_one():
    """Any nonzero mask value selects, as the reference's ``mask != 0``."""
    mask = np.array([[0, 2, 0, 255, 1, 7]], dtype=np.uint8)
    got = indices_from_mask(torch.from_numpy(mask), 5)
    assert got.tolist() == [[1, 3, 4, 5, -1]]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_indices_from_mask(jnp.asarray(mask), 5)))


@pytest.mark.parametrize("n,rb,q", SHAPES + EDGE_SHAPES)
def test_fused_equals_reference_and_unfused_pair(n, rb, q):
    rs, ts, mask = _case(n, rb, q)
    ridx = ref_indices_from_mask(jnp.asarray(mask), n)
    tidx = indices_from_mask(torch.from_numpy(mask), n)
    got = fused_gather_fold(ts.packed, tidx)
    _eq(got, ref_fused_gather_fold(rs.packed, ridx, interpret=True))
    _eq(got, ref_oracles.gather_xor_ref(rs.packed, ridx))
    # the composition the fused form replaces, both halves
    assert torch.equal(got, gather_xor(ts.packed, tidx))
    assert torch.equal(got, xor_fold(ts.packed, torch.from_numpy(mask)))


@pytest.mark.parametrize("grid_order", ["qw", "wq"])
@pytest.mark.parametrize("block_w", [8, 32, 128])
def test_fused_grid_order_and_block_sweep(grid_order, block_w):
    rs, ts, mask = _case(211, 21, 6, seed=4)
    ridx = ref_indices_from_mask(jnp.asarray(mask), 120)
    tidx = indices_from_mask(torch.from_numpy(mask), 120)
    got = fused_gather_fold(ts.packed, tidx, block_w=block_w,
                            grid_order=grid_order)
    _eq(got, ref_fused_gather_fold(rs.packed, ridx, block_w=block_w,
                                   grid_order=grid_order, interpret=True))


def test_fused_truncated_budget_matches_pair():
    rs, ts, mask = _case(90, 10, 4, seed=9)
    tidx = indices_from_mask(torch.from_numpy(mask), 8)
    got = fused_gather_fold(ts.packed, tidx)
    assert torch.equal(got, gather_xor(ts.packed, tidx))
    ridx = ref_indices_from_mask(jnp.asarray(mask), 8)
    _eq(got, ref_fused_gather_fold(rs.packed, ridx, interpret=True))


GATE_CASES = [
    # (n, W, block_w, budget)
    (256, 16, 128, 8 << 20),
    (4096, 512, 128, 8 << 20),
    (65536, 128, 128, 8 << 20),
    (10**6, 384, 128, 8 << 20),
    (200_000, 12, 128, 8 << 20),
    (300_000, 12, 128, 8 << 20),
    (2048, 16, 128, FUSED_SMEM_FALLBACK_BYTES),
    (7264, 384, 128, FUSED_SMEM_FALLBACK_BYTES),
    (7265, 384, 128, FUSED_SMEM_FALLBACK_BYTES),
    (10**6, 384, 128, FUSED_SMEM_FALLBACK_BYTES),
    (500, 3, 128, FUSED_SMEM_FALLBACK_BYTES),
    (1000, 40, 16, 1),
]


@pytest.mark.parametrize("n,w,block_w,budget", GATE_CASES)
def test_fused_block_w_gate_equals_reference(n, w, block_w, budget):
    got = fused_block_w(n, w, block_w=block_w, budget_bytes=budget)
    assert got == ref_fused_block_w(n, w, block_w=block_w, budget_bytes=budget)
    assert got == 0 or (n * got * 4 <= budget and got & (got - 1) == 0)


def test_fused_gate_on_the_hopper_budget():
    """The contract of the reference's gate test, on the shared-memory
    budget of a Hopper block (what the CPU path falls back to)."""
    assert fused_smem_budget(torch.device("cpu")) == 232_448
    assert fused_smem_budget(None) == 232_448
    assert fused_block_w(256, 16) == 16       # fits whole
    assert fused_block_w(400, 512) == 128     # capped at the default block
    assert 0 < fused_block_w(1000, 128) < 128  # shrinks to fit
    assert fused_block_w(10**6, 384) == 0     # CT scale: fall back to pair
    assert fused_block_w(7000, 12) == 8       # rounds W down to a pow2
    assert fused_block_w(8000, 12) == 0       # 8-word slab does not fit


FUSED_SCHEDULE_CASES = [
    # (n, W, index rows, block_w, k_max, aligned store): the reduced
    # config's lookup batch and multi bucket, the gate's edge (the slab
    # fills the budget to the byte), a batch of 1 and 32 there, a 16-word
    # tile of the CT record, W 3, an unaligned store, the most queries, a
    # tile wider than a pass, k_max past a CTA's warps
    (2048, 16, 8, 16, 1, True),
    (2048, 16, 32, 16, 4, True),
    (7264, 384, 8, 8, 1, True),
    (7264, 384, 1, 8, 1, True),
    (7264, 384, 32, 8, 4, True),
    (3584, 384, 33, 16, 1, True),
    (300, 3, 5, 128, 1, True),
    (500, 40, 17, 16, 1, False),
    (256, 16, 65535, 16, 1, True),
    (100, 1000, 9, 512, 1, True),
    (37, 33, 3, 128, 1, True),
    (2048, 16, 36, 16, 9, True),
]


@pytest.mark.parametrize("n,w,rows,block_w,k_max,aligned",
                         FUSED_SCHEDULE_CASES)
@pytest.mark.parametrize("spread", [True, False])
def test_fused_schedule_fits_the_card(n, w, rows, block_w, k_max, aligned,
                                      spread):
    """Clusters of at most 8 CTAs span the grid's x axis; the CTAs cover
    the rows in whole requests; the warps a row take one round and one
    pass; TMA only where it can run and a cluster shares it; the shared
    memory fits the Hopper budget and is what the kernel takes."""
    order = ("qw" if spread else "wq") if k_max == 1 else (
        "rw" if spread else "wr")
    s = fused_schedule(n, w, rows, block_w, grid_order=order, k_max=k_max,
                       aligned=aligned)
    bw = min(block_w, w)
    c = s["cluster"]
    assert 1 <= c <= CLUSTER_MAX and s["block_w"] == bw
    assert s["grid"] == (c, -(-w // bw), s["groups"])
    assert s["grid"][0] % c == 0 and max(s["grid"]) <= 65535
    rpc = s["rows_per_cta"]
    assert rpc % k_max == 0 and rpc <= max(ROWS_PER_CTA_MAX, k_max)
    assert c * s["groups"] * rpc >= rows
    wpq = s["warps_per_row"]
    assert 1 <= wpq <= WARPS and wpq & (wpq - 1) == 0
    if wpq > 1:  # one round of the CTA's warps, one pass of the tile
        assert rpc <= WARPS // wpq and bw <= 512
    if s["staging"] == "tma":
        assert aligned and w % 4 == 0 and bw % 4 == 0 and c > 1
        assert TMA_MIN_WORDS <= bw <= 256
    else:
        assert s["staging"] == "copy" and c == 1
    # the warps' scratch lies over the slab: at least WARPS rows of it
    slab_rows = max(n, WARPS) if wpq > 1 else n
    assert s["smem_bytes"] == slab_rows * bw * 4 + (
        8 if s["staging"] == "tma" else 0)
    assert s["smem_bytes"] <= FUSED_SMEM_FALLBACK_BYTES


def test_fused_schedule_on_the_serving_shapes():
    """The reduced config's batch of 8 shares one TMA multicast over a
    cluster of 8 CTAs, a query each ("qw"), or takes one CTA ("wq"); a
    slab that fills the budget takes the barrier-free copy, and TMA forced
    there, on W 3 or on an unaligned store raises."""
    qw = fused_schedule(2048, 16, 8, 16, grid_order="qw")
    assert (qw["staging"], qw["cluster"], qw["rows_per_cta"],
            qw["warps_per_row"]) == ("tma", 8, 1, 16)
    wq = fused_schedule(2048, 16, 8, 16, grid_order="wq")
    assert (wq["staging"], wq["grid"], wq["rows_per_cta"]) == (
        "copy", (1, 1, 1), 8)
    rw = fused_schedule(2048, 16, 32, 16, grid_order="rw", k_max=4)
    assert (rw["staging"], rw["cluster"], rw["rows_per_cta"]) == (
        "tma", 8, 4)
    edge = fused_schedule(7264, 384, 8, 8)
    assert (edge["staging"], edge["cluster"], edge["smem_bytes"],
            edge["warps_per_row"]) == ("copy", 1, 232_448, 2)
    assert fused_schedule(7264, 384, 32, 8)["groups"] == 2
    for args, kw in (((7264, 384, 8, 8), {}), ((300, 3, 5, 128), {}),
                     ((2048, 16, 8, 16), {"aligned": False})):
        with pytest.raises(ValueError):
            fused_schedule(*args, staging="tma", **kw)
    forced = fused_schedule(2048, 16, 8, 16, staging="copy")
    assert (forced["staging"], forced["cluster"]) == ("copy", 1)


def test_fused_schedule_refuses_what_the_kernel_does_not_take():
    for kw in ({"grid_order": "qwm"}, {"k_max": 3}, {"staging": "dsmem"}):
        with pytest.raises(ValueError):
            fused_schedule(2048, 16, 8, 16, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        fused_schedule(7265, 384, 8, 8)


@pytest.mark.parametrize("n,theta", [(10_000, 0.25), (16, 0.5), (10**6, 0.25),
                                     (2048, 0.25), (7, 0.01), (512, 0.3)])
def test_sparse_index_budget_equals_reference(n, theta):
    assert ops.sparse_index_budget(n, theta) == ref_ops.sparse_index_budget(
        n, theta)


def test_sparse_index_budget_bounds():
    m = ops.sparse_index_budget(10_000, 0.25)
    assert 2500 < m < 3000 and m % 8 == 0
    assert ops.sparse_index_budget(16, 0.5) == 16  # clamped at n


def test_server_paths_agree_end_to_end():
    """fold == parity == sparse on the same masks, and == the reference's
    three paths."""
    rs, ts, mask = _case(222, 36, 13)
    tmask = torch.from_numpy(mask)
    fold = ops.server_answer_fold(ts.packed, tmask)
    par = ops.server_answer_parity(ts.bitplanes(), tmask)
    sp = ops.server_answer_sparse(ts.packed, tmask, theta=0.4)
    assert torch.equal(fold, par) and torch.equal(fold, sp)
    _eq(fold, ref_ops.server_answer_fold(rs.packed, jnp.asarray(mask)))
    _eq(par, ref_ops.server_answer_parity(rs.bitplanes(), jnp.asarray(mask)))
    _eq(sp, ref_ops.server_answer_sparse(rs.packed, jnp.asarray(mask),
                                         theta=0.4))


@pytest.mark.parametrize("theta,planes", [(0.3, False), (None, False),
                                          (None, True), (0.5, True)])
def test_server_answer_auto_is_exact(theta, planes):
    _, ts, mask = _case(200, 20, 6, seed=2)
    tmask = torch.from_numpy(mask)
    got = ops.server_answer_auto(
        ts.packed, ts.bitplanes() if planes else None, tmask, theta)
    assert torch.equal(got, ref.xor_fold_ref(ts.packed, tmask))


def test_parity_crossover_is_a_measured_bucket_or_never():
    q = ops.parity_crossover_batch(10**6, 12288)
    assert q == ops.PARITY_NEVER_WINS or (q & (q - 1) == 0 and q >= 1)


def test_wrappers_count_no_launch_on_the_cpu():
    """A launch counter moves only where a kernel is launched."""
    _, ts, mask = _case(32, 8, 2)
    before = (xor_fold.launches, gather_xor.launches,
              fused_gather_fold.launches, parity_matmul.launches,
              indices_from_mask.launches)
    tmask = torch.from_numpy(mask)
    xor_fold(ts.packed, tmask)
    idx = indices_from_mask(tmask, 32)
    gather_xor(ts.packed, idx)
    fused_gather_fold(ts.packed, idx)
    parity_matmul(tmask, ts.bitplanes())
    assert before == (xor_fold.launches, gather_xor.launches,
                      fused_gather_fold.launches, parity_matmul.launches,
                      indices_from_mask.launches)


def test_shape_mismatch_raises():
    _, ts, mask = _case(32, 8, 2)
    with pytest.raises(ValueError):
        xor_fold(ts.packed, torch.from_numpy(mask)[:, :-1])
    with pytest.raises(ValueError):
        parity_matmul(torch.from_numpy(mask)[:, :-1], ts.bitplanes())
