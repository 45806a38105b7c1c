"""``repro_torch.launch.op_cost`` against programs with known costs, case
for case as ``tests/test_hlo_cost.py`` holds the reference's HLO parser;
the collectives' and the kernel wrappers' reports to the counter; the
wrappers on ``meta`` tensors (answered by shape, their kernel's formula
counted) and on devices they refuse; and a reduced SmolLM prefill cell
counted on the CPU against ``repro.launch.hlo_cost.analyze_hlo`` of the
reference's compiled cell."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch import cells as RC
from repro.launch.hlo_cost import analyze_hlo
from repro_torch import _cost, convert
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as S
from repro_torch.kernels import fused, scatter, xor_fold
from repro_torch.kernels.gather_xor import gather_xor, indices_from_mask
from repro_torch.kernels.flash_attention import (
    attention_pairs, flash_attention_fwd, flash_attention_plain, flash_cost,
)
from repro_torch.kernels.parity_matmul import (
    parity_matmul, parity_matmul_packed, parity_matmul_packed_plain,
    parity_matmul_plain,
)
from repro_torch.launch import cells as C
from repro_torch.launch.op_cost import OpCost, count_cost

META = torch.device("meta")


def _t(*shape, device="cpu", dtype=torch.float32):
    return torch.ones(shape, dtype=dtype, device=device)


# ------------------------------------------- test_hlo_cost.py, case for case
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_single_matmul_flops(device):
    cost = count_cost(lambda a, b: a @ b, _t(256, 512, device=device),
                      _t(512, 128, device=device))
    assert cost.flops == 2 * 256 * 512 * 128
    # its bytes: both operands read and the result written
    assert cost.bytes == 4 * (256 * 512 + 512 * 128 + 256 * 128)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_loop_of_layers_is_counted_layer_by_layer(device):
    def f(x, w):
        for _ in range(10):
            x = x @ w
        return x

    cost = count_cost(f, _t(256, 256, device=device),
                      _t(256, 256, device=device))
    assert cost.flops == 10 * 2 * 256**3


def test_nested_loops():
    def f(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    cost = count_cost(f, _t(128, 128, device=META), _t(128, 128, device=META))
    assert cost.flops == 12 * 2 * 128**3


def test_batched_product_flops():
    cost = count_cost(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                      _t(8, 64, 32, device=META), _t(8, 32, 16, device=META))
    assert cost.flops == 2 * 8 * 64 * 32 * 16


def test_bytes_nonzero_and_sane():
    cost = count_cost(lambda a: (a * 2.0 + 1.0).sum(), _t(1024, 1024))
    nbytes = 1024 * 1024 * 4
    assert nbytes <= cost.bytes <= 6 * nbytes
    assert cost.flops == 0  # elementwise ops are not counted, as the reference


def test_views_and_allocations_move_no_bytes():
    cost = count_cost(lambda a: (a.view(-1)[:10], a.t()[3], torch.empty(64)),
                      _t(32, 32, device=META))
    assert cost.bytes == 0


def test_peak_is_the_runs_own_allocations():
    def f(x):
        y = x * 2           # 4 MB
        z = y + 1           # 4 MB more while y lives
        del y
        return z.sum()

    x = _t(1024, 1024, device=META)
    cost = count_cost(f, x)
    assert cost.peak_bytes == 2 * 1024 * 1024 * 4


def test_add_and_to_dict_follow_the_reference():
    a = count_cost(lambda x: x @ x, _t(16, 16, device=META))
    total = OpCost()
    total.add(a, mult=3)
    assert total.flops == 3 * a.flops and total.bytes == 3 * a.bytes
    d = total.to_dict()
    assert set(d) >= {"flops", "bytes", "collective_bytes",
                      "collective_counts", "total_collective_bytes",
                      "peak_bytes"}
    assert set(d["collective_bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}


# ---------------------------------------------------------- the collectives
def _mesh8(device="cpu"):
    return S.make_mesh((2, 4), ("data", "model"), [device])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_xor_psum_counts_its_butterfly_rounds_as_permutes(device):
    q, w = 8, 48
    mesh = _mesh8(device)
    shards = [torch.zeros((q, w), dtype=torch.int32, device=device)
              for _ in range(mesh.size)]
    cost = count_cost(lambda s: coll.xor_psum(s, mesh, ("data", "model")),
                      shards)
    # 1 round over "data" (2) and 2 over "model" (4): log2(8) = 3 rounds
    assert cost.coll_counts["collective-permute"] == 3
    assert cost.coll_bytes["collective-permute"] == 3 * q * w * 4
    assert cost.total_collective_bytes == 3 * q * w * 4


def test_gathers_scatters_and_sums_report_their_kinds():
    mesh = _mesh8()
    shards = [torch.ones((8, 3)) * i for i in range(mesh.size)]
    cost = count_cost(lambda s: coll.all_gather(s, mesh, "model"), shards)
    assert cost.coll_bytes["all-gather"] == 4 * 8 * 3 * 4  # the gathered result
    cost = count_cost(lambda s: coll.psum_scatter(s, mesh, "model"), shards)
    assert cost.coll_bytes["reduce-scatter"] == 8 * 3 * 4  # the operand
    cost = count_cost(lambda s: coll.compressed_psum(s, mesh, "data"), shards)
    # the shared scale (a max) and the int32 payload (a sum)
    assert cost.coll_counts["all-reduce"] == 2
    assert cost.coll_bytes["all-reduce"] == 4 + 8 * 3 * 4


def test_a_group_on_one_device_folds_once_with_the_same_bits():
    """The members of a group on one device share one fold (and one
    concatenation, one reduce-scatter sum): the same values, summed in
    the same block order, as a fold for each position."""
    mesh = _mesh8()
    g = torch.Generator().manual_seed(0)
    shards = [torch.randn((8, 5), generator=g) for _ in range(mesh.size)]
    summed = coll._psum(shards, mesh, ("model",))
    scattered = coll.psum_scatter(shards, mesh, "model")
    gathered = coll.all_gather(shards, mesh, "model")
    for i, pos in enumerate(mesh.positions()):
        group = mesh.group_of(pos, ("model",))
        members = [shards[mesh.block_of(p, mesh.axis_names)] for p in group]
        want = members[0]
        for x in members[1:]:
            want = want + x
        assert torch.equal(summed[i], want)
        b = mesh.block_of(pos, ("model",))
        assert torch.equal(scattered[i], want[2 * b:2 * b + 2])
        assert torch.equal(gathered[i], torch.cat(members))
    # one result object a group (positions 0-3 form one, 4-7 the other)
    assert summed[0] is summed[3] and summed[0] is not summed[4]
    assert gathered[1] is gathered[2]


def test_no_count_active_changes_nothing():
    assert not _cost.active()
    mesh = _mesh8()
    shards = [torch.full((4, 2), i, dtype=torch.int32) for i in range(8)]
    got = coll.xor_psum(shards, mesh, ("data", "model"))
    want = 0
    for i in range(8):
        want ^= i
    assert all(bool((g == want).all()) for g in got)


# ------------------------------------- the kernel wrappers on meta (and not)
@pytest.mark.parametrize("packed", [False, True])
def test_parity_on_meta_answers_by_shape_and_counts_its_formula(packed):
    q, n, b = 16, 1000, 100
    fn = parity_matmul_packed if packed else parity_matmul
    mask = torch.empty((q, n), dtype=torch.uint8, device=META)
    planes = torch.empty((n, b), dtype=torch.uint8, device=META)
    before = fn.launches
    cost = count_cost(fn, mask, planes)
    out = fn(mask, planes)
    assert out.device == META and fn.launches == before
    if packed:
        assert (tuple(out.shape), out.dtype) == ((q, 4), torch.int32)
    else:
        assert (tuple(out.shape), out.dtype) == ((q, b), torch.uint8)
    assert cost.kernels == {fn.__name__: 1}
    assert cost.flops == 2 * q * n * b
    assert cost.bytes >= q * n + n * b + (q * 16 if packed else q * b)
    with pytest.raises(ValueError, match="disagree"):
        fn(mask, planes[:-1])


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (False, None, 0), (True, 24, 0), (True, 24, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_on_meta_answers_by_shape_and_counts_attended_pairs(
        causal, window, q_offset, dtype):
    bh, sq, sk, d = 6, 64, 104, 32
    q = torch.empty((bh, sq, d), dtype=dtype, device=META)
    k = torch.empty((bh, sk, d), dtype=dtype, device=META)
    cost = count_cost(partial(flash_attention_fwd, causal=causal,
                              window=window, q_offset=q_offset), q, k, k)
    out = flash_attention_fwd(q, k, k, causal=causal, window=window,
                              q_offset=q_offset)
    assert (out.shape, out.dtype, out.device) == (q.shape, dtype, META)
    assert cost.flops == 4 * bh * attention_pairs(sq, sk, causal, window,
                                                  q_offset) * d
    assert sum(cost.kernels.values()) == 1
    # the pairs by brute force
    qpos = np.arange(sq)[:, None] + q_offset
    kpos = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    assert attention_pairs(sq, sk, causal, window, q_offset) == ok.sum()


def test_flash_on_meta_refuses_what_the_card_refuses():
    q = torch.empty((2, 8, 300), device=META)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(TypeError):
        h = torch.empty((2, 8, 16), dtype=torch.float16, device=META)
        flash_attention_fwd(h, h, h)


def test_attention_backward_runs_on_meta():
    """The training cells' attention: the kernel's forward by shape, the
    plain gradient recomputed on meta."""
    from repro_torch.models.layers import gqa_attention

    q = torch.empty((2, 16, 4, 8), device=META, requires_grad=True)
    kv = torch.empty((2, 16, 2, 8), device=META, requires_grad=True)
    cost = count_cost(lambda a, b: torch.autograd.grad(
        gqa_attention(a, b, b).sum(), (a, b)), q, kv)
    assert cost.kernels == {"flash_fwd_kernel": 1}
    # the plain backward's products are counted beside the kernel's formula
    assert cost.flops > 4 * 2 * 4 * attention_pairs(16, 16, True, None) * 8


@pytest.mark.parametrize("window", [None, 24])
def test_gemma2_heads_in_bf16_count_as_the_wgmma_kernel(window):
    """gemma-2's attention layout (8 query / 4 kv heads, head dim 256) in
    bf16 is counted as one launch of the wgmma kernel, at flash_cost's
    flops (K/V broadcast over the query groups first), with its softcap."""
    from repro_torch.models.layers import gqa_attention

    b, s, d = 2, 64, 256
    q = torch.empty((b, s, 8, d), dtype=torch.bfloat16, device=META)
    kv = torch.empty((b, s, 4, d), dtype=torch.bfloat16, device=META)
    cost = count_cost(partial(gqa_attention, window=window,
                              attn_softcap=50.0), q, kv, kv)
    assert cost.kernels == {"flash_wgmma_kernel": 1}
    flops, _ = flash_cost(b * 8, s, s, d, 2, True, window)
    assert cost.flops == flops


def _refusals():
    i32 = dict(dtype=torch.int32, device=META)
    db = torch.empty((10, 3), **i32)
    return {
        "xor_fold": lambda: xor_fold(db, torch.empty((2, 10), device=META,
                                                      dtype=torch.uint8)),
        "gather_xor": lambda: gather_xor(db, torch.empty((2, 4), **i32)),
        "indices_from_mask": lambda: indices_from_mask(
            torch.empty((2, 10), dtype=torch.uint8, device=META), 4),
        "fused_gather_fold": lambda: fused.fused_gather_fold(
            db, torch.empty((2, 4), **i32)),
        "fused_multi_gather_fold": lambda: fused.fused_multi_gather_fold(
            db, torch.empty((4, 4), **i32),
            torch.tensor([0, 2, 4], **i32), k_max=2),
        "scatter_rows": lambda: scatter.scatter_rows(
            db, torch.empty((2,), **i32), torch.empty((2, 3), **i32)),
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_other_wrappers_refuse_meta(name):
    with pytest.raises(ValueError, match="not on meta"):
        _refusals()[name]()


def test_wrappers_on_the_cpu_are_their_plain_versions_bit_for_bit():
    g = torch.Generator().manual_seed(0)
    mask = torch.randint(0, 2, (9, 300), generator=g, dtype=torch.uint8)
    planes = torch.randint(0, 2, (300, 70), generator=g, dtype=torch.uint8)
    assert torch.equal(parity_matmul(mask, planes),
                       parity_matmul_plain(mask, planes))
    assert torch.equal(parity_matmul_packed(mask, planes),
                       parity_matmul_packed_plain(mask, planes))
    q = torch.randn((3, 40, 16), generator=g)
    k = torch.randn((3, 50, 16), generator=g)
    for kw in (dict(causal=True), dict(causal=False, window=8),
               dict(causal=True, q_offset=10, softcap=5.0)):
        assert torch.equal(flash_attention_fwd(q, k, k, **kw),
                           flash_attention_plain(q, k, k, **kw))
    # counted on the CPU, the plain version's own ops show, not the formula
    cost = count_cost(parity_matmul, mask, planes)
    assert cost.kernels == {} and cost.flops == 2 * 9 * 300 * 70


# ----------------------------------- a reduced cell against the reference's
def test_reduced_prefill_flops_agree_with_the_reference_hlo():
    """SmolLM ``reduced()`` at 2 x 64 tokens: the port's count on the CPU
    (its plain attention, as the reference's HLO has it) against
    ``analyze_hlo`` of the reference's compiled cell. Both count 2·m·n·k
    per product over the same products; they differ only in what XLA
    folds or leaves out (the reference's embedding gather is no dot in
    either). The tolerance, 1 %, is far below any one product's share:
    the smallest, a layer's score product, is 2.9 % of the total."""
    cfg = get_arch("smollm-135m").reduced()
    rcfg = ref_get_arch("smollm-135m").reduced()
    sp = ShapeSpec.make("prefill_32k", "lm_prefill", seq_len=64,
                        global_batch=2)
    mesh = S.make_mesh((1, 1), ("data", "model"), ["cpu"])
    with S.mesh_rules(mesh, dict(S.DEFAULT_RULES, **C.rules_for_cell(sp))):
        cell = C.build_cell_sanitized("smollm-135m", sp, device="cpu",
                                      cfg=cfg)
        got = count_cost(cell.fn, *cell.args)
    params, tokens = cell.args
    ref_params = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(params))
    fn = partial(RC._prefill_fn, cfg=rcfg, max_len=64)
    hlo = jax.jit(fn).lower(ref_params, jnp.asarray(tokens.numpy())) \
        .compile().as_text()
    want = analyze_hlo(hlo).flops
    assert got.flops == pytest.approx(want, rel=0.01)
    d, s, b = cfg.head_dim, 64, 2
    score = 2 * b * cfg.n_heads * s * s * d
    assert score / want > 0.01
