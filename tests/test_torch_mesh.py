"""Port vs reference: the mesh layer — logical-axis sharding rules and
specs, sharded arrays, the GF(2), sum and int8 collectives, parameter
specs, the production mesh, and sequence-sharded flash-decode.

The port's mesh is (2, 4) ("data", "model") with every position on the
CPU; the reference's rule functions run under a
``jax.sharding.AbstractMesh`` of the same shape (no devices needed), and
its single-device functions give the values (its own multidevice checks
prove its mesh forms equal to them). Specs compare as tuples. Tolerances:
zero for the lookups, the XOR collectives and int8 quantization; the int8
sum within ``shards · scale / 2`` (and exactly the int32 sum of the same
payloads); flash-decode 2e-5 in float32, the reference's own bound for its
mesh form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_arch as ref_get_arch
from repro.dist import collectives as RC
from repro.dist import params as RPm
from repro.dist import sharding as RS
from repro.models import layers as RL
from repro.models import recsys as RR
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.db import RecordStore
from repro_torch.dist import collectives as C
from repro_torch.dist import params as Pm
from repro_torch.dist import sharding as S
from repro_torch.dist.flash_decode import flash_decode
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

from _torch_parity import CPU, words_n2t, words_t2n

MESH = S.make_mesh((2, 4), ("data", "model"), [CPU])
REF_MESH = AbstractMesh((2, 4), ("data", "model"))
POD_MESH = S.make_mesh((2, 2, 4), ("pod", "data", "model"), [CPU])
REF_POD_MESH = AbstractMesh((2, 2, 4), ("pod", "data", "model"))
XORBFLY = dict(S.DEFAULT_RULES, records=("data", "model"), queries=None)
RULE_SETS = {
    "default": (MESH, REF_MESH, S.DEFAULT_RULES, RS.DEFAULT_RULES),
    "multipod": (POD_MESH, REF_POD_MESH, S.MULTIPOD_RULES, RS.MULTIPOD_RULES),
    "xorbfly": (MESH, REF_MESH, XORBFLY,
                dict(RS.DEFAULT_RULES, records=("data", "model"),
                     queries=None)),
}
FD_TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _words(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, size=shape, dtype=np.uint32)


# --------------------------------------------------------------------------
# Rules and specs
# --------------------------------------------------------------------------
def test_rule_tables_equal_the_reference():
    assert S.DEFAULT_RULES == RS.DEFAULT_RULES
    assert S.MULTIPOD_RULES == RS.MULTIPOD_RULES


@pytest.mark.parametrize("rules", sorted(RULE_SETS))
def test_resolution_equals_the_reference_for_every_logical_name(rules):
    mesh, ref_mesh, tr, rr = RULE_SETS[rules]
    names = sorted(tr) + ["unknown"]
    combos = [("batch", "records", "nodes"), (None, "fsdp", "heads"),
              ("queries", "records"), ("vocab", "fsdp", None, None),
              ("candidates", "batch")]
    with S.mesh_rules(mesh, tr), RS.mesh_rules(ref_mesh, rr):
        assert S.current_mesh() is mesh and S.current_rules() == tr
        for name in names:
            assert S.mesh_axis_names(name) == RS.mesh_axis_names(name), name
            assert S.axis_size(name) == RS.axis_size(name), name
            assert tuple(S.logical_to_spec(name)) == tuple(
                RS.logical_to_spec(name)), name
        for combo in combos:
            assert tuple(S.logical_to_spec(*combo)) == tuple(
                RS.logical_to_spec(*combo)), combo
    # off the mesh: nothing maps, specs keep the rule-free names
    assert S.current_mesh() is None and S.current_rules() == {}
    assert S.mesh_axis_names("batch") == () and S.axis_size("batch") == 1
    assert tuple(S.logical_to_spec("batch")) == tuple(
        RS.logical_to_spec("batch"))


def test_the_context_is_thread_local():
    seen = []
    with S.mesh_rules(MESH, S.DEFAULT_RULES):
        import threading

        t = threading.Thread(target=lambda: seen.append(S.current_mesh()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert S.current_mesh() is MESH
    assert seen == [None]


@pytest.mark.parametrize("rows,n_pad,rshards", [
    ([0, 1, 2, 33, 34], 256, 8), ([250, 251], 256, 8), ([3, 200], 256, 8),
    ([], 64, 4), ([299], 304, 8), ([0], 300, 8), ([256], 256, 8),
    ([-1], 256, 8), ([5], 256, 0),
])
def test_touched_record_blocks_equal_the_reference(rows, n_pad, rshards):
    try:
        want = RS.touched_record_blocks(np.asarray(rows), n_pad, rshards)
    except (ValueError, IndexError) as e:
        with pytest.raises(type(e)):
            S.touched_record_blocks(np.asarray(rows), n_pad, rshards)
        return
    assert S.touched_record_blocks(np.asarray(rows), n_pad, rshards) == want


def test_constrain_is_a_checked_identity():
    x = torch.zeros(2, 3)
    for ctx in (S.mesh_rules(MESH, S.DEFAULT_RULES), torch.no_grad()):
        with ctx:
            assert S.constrain(x, "batch", "embed") is x
            assert S.constrain(x, None) is x
            with pytest.raises(ValueError, match="logical names"):
                S.constrain(x, "batch", "seq", "embed")
            with pytest.raises(TypeError):
                S.constrain(x, 3)


def test_record_store_shard_spec_equals_the_reference():
    from repro.db import RecordStore as RefStore

    store = RecordStore(packed=torch.zeros(4, 2, dtype=torch.int32),
                        record_bits=64)
    ref = RefStore(packed=jnp.zeros((4, 2), jnp.uint32), record_bits=64)
    for axis in ("model", ("data", "model"), None):
        assert tuple(store.shard_spec(axis)) == tuple(ref.shard_spec(axis))
    assert tuple(store.shard_spec()) == tuple(ref.shard_spec())


# --------------------------------------------------------------------------
# Sharded arrays
# --------------------------------------------------------------------------
def test_device_put_gives_each_block_its_own_storage():
    x = torch.arange(64 * 3, dtype=torch.int32).reshape(64, 3)
    arr = S.device_put(x, MESH, S.P(("data", "model"), None))
    assert arr.shape == (64, 3) and tuple(arr.spec) == (("data", "model"), None)
    assert [sh.index for sh in arr.shards] == list(range(0, 64, 8))
    assert len({sh.data.data_ptr() for sh in arr.shards}) == 8
    for sh in arr.shards:
        assert torch.equal(sh.data, x[sh.index:sh.index + 8])
        assert sh.data.data_ptr() != x.data_ptr()
    # records over "model" only: the two "data" replicas of a block on one
    # device share one tensor
    rep = S.device_put(x, MESH, S.P("model", None))
    assert len({sh.data.data_ptr() for sh in rep.shards}) == 4
    assert rep.shards[6].data is rep.shards[2].data  # (1, 2) and (0, 2)
    # a block of a bit-major [n, B] view stays bit-major
    planes = torch.arange(5 * 64, dtype=torch.uint8).reshape(5, 64).t()
    pa = S.device_put(planes, MESH, S.P("model", None))
    for sh in pa.shards:
        assert sh.data.stride() == (1, 16) and torch.equal(
            sh.data, planes[sh.index:sh.index + 16])
    with pytest.raises(ValueError, match="split"):
        S.device_put(x[:63], MESH, S.P(("data", "model"), None))
    with pytest.raises(ValueError, match="names"):
        S.device_put(x, MESH, S.P("pod"))


# --------------------------------------------------------------------------
# The XOR collectives
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape,axes", [
    ((2, 4), ("data", "model")),   # 8: butterfly over both axes
    ((4,), ("model",)),            # 4: butterfly
    ((3,), ("model",)),            # 3: gather and fold
    ((2, 3), ("data", "model")),   # 6: butterfly then fold
    ((2, 3), ("model",)),          # 3 per group, two groups
])
def test_xor_psum_equals_a_numpy_xor(shape, axes):
    names = ("data", "model")[-len(shape):]
    mesh = S.make_mesh(shape, names, [CPU])
    vals = _words((mesh.size, 5, 7), sum(shape))
    got = C.xor_psum([words_n2t(v) for v in vals], mesh, axes)
    grid = vals.reshape(*shape, 5, 7)
    for i, pos in enumerate(mesh.positions()):
        want = np.zeros((5, 7), np.uint32)
        for g in mesh.group_of(pos, axes):
            want ^= grid[g]
        np.testing.assert_array_equal(words_t2n(got[i]), want)
    with S.mesh_rules(mesh, S.DEFAULT_RULES):  # mesh=None: the active one
        again = C.xor_psum([words_n2t(v) for v in vals], None, axes)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_collectives_refuse_without_a_mesh_or_with_the_wrong_count():
    with pytest.raises(ValueError, match="mesh"):
        C.xor_psum([torch.zeros(2, dtype=torch.int32)], None, "model")
    with pytest.raises(ValueError, match="mesh"):
        C.compressed_psum([torch.zeros(2)], None, "model")
    with pytest.raises(ValueError, match="shards"):
        C.xor_psum([torch.zeros(2, dtype=torch.int32)] * 3, MESH, "model")


@pytest.mark.parametrize("n", [64, 61])
def test_sharded_record_lookup_equals_take(n):
    """Against ``jnp.take`` with clamping: on the mesh from a tensor (61
    rows do not split over 8 and take the plain gather), from a sharded
    store, and off the mesh."""
    packed = _words((n, 5), 13)
    ids = torch.from_numpy(
        np.random.default_rng(14).integers(-3, n + 3, size=(3, 7)))
    want = np.asarray(jnp.take(jnp.asarray(packed),
                               jnp.clip(jnp.asarray(ids.numpy()), 0, n - 1),
                               axis=0))
    t = words_n2t(packed)
    with S.mesh_rules(MESH, XORBFLY):
        np.testing.assert_array_equal(
            words_t2n(C.sharded_record_lookup(t, ids)), want)
        if n % 8 == 0:
            sharded = S.device_put(t, MESH, S.P(("data", "model"), None))
            np.testing.assert_array_equal(
                words_t2n(C.sharded_record_lookup(sharded, ids)), want)
    np.testing.assert_array_equal(
        words_t2n(C.sharded_record_lookup(t, ids)), want)
    if n % 8 == 0:
        with pytest.raises(ValueError, match="records rule"):
            C.sharded_record_lookup(sharded, ids)


# --------------------------------------------------------------------------
# The other collectives
# --------------------------------------------------------------------------
@pytest.mark.parametrize("which,v,rows", [
    ("vocab", 64, 8), ("table", 128, 16), ("vocab", 62, 8), ("table", 128, 3),
])
def test_vocab_and_table_lookups_equal_take(which, v, rows):
    table = _rand((v, 16), v)
    ids = np.random.default_rng(rows).integers(-2, v + 2, size=(rows, 5))
    want = np.asarray(jnp.take(jnp.asarray(table),
                               jnp.clip(jnp.asarray(ids), 0, v - 1), axis=0))
    fn = C.sharded_vocab_lookup if which == "vocab" else C.sharded_table_lookup
    for ctx in (S.mesh_rules(MESH, S.DEFAULT_RULES), torch.no_grad()):
        with ctx:
            got = fn(torch.from_numpy(table), torch.from_numpy(ids))
        np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_int8_is_bit_exact_against_the_reference():
    x = _rand((8, 64), 10, 3.0)
    q, scale = C.quantize_int8(torch.from_numpy(x))
    rq, rscale = RC.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert scale.item() == float(rscale)
    given = np.float32(0.05)
    q2, _ = C.quantize_int8(torch.from_numpy(x), torch.tensor(given))
    rq2, _ = RC.quantize_int8(jnp.asarray(x), jnp.float32(given))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(rq2))
    np.testing.assert_array_equal(
        C.dequantize_int8(q, scale).numpy(),
        np.asarray(RC.dequantize_int8(rq, rscale)))
    zq, zs = C.quantize_int8(torch.zeros(3))
    assert zq.abs().max().item() == 0 and zs.item() > 0


@pytest.mark.parametrize("axes", [("data", "model"), ("model",)])
def test_compressed_psum_is_the_int32_sum_of_the_shared_grid(axes):
    x = _rand((8, 64), 11)
    got = C.compressed_psum([torch.from_numpy(r[None]) for r in x], MESH, axes)
    grid = x.reshape(2, 4, 64)
    for i, pos in enumerate(MESH.positions()):
        members = [grid[g] for g in MESH.group_of(pos, axes)]
        scale = max(float(RC.quantize_int8(jnp.asarray(m))[1]) for m in members)
        payloads = [np.asarray(RC.quantize_int8(jnp.asarray(m),
                                                jnp.float32(scale))[0])
                    for m in members]
        acc = np.sum([p.astype(np.int32) for p in payloads], axis=0)
        exact = acc.astype(np.float32) * np.float32(scale)
        np.testing.assert_array_equal(got[i].numpy()[0], exact)
        want = np.sum(members, axis=0)
        assert np.abs(got[i].numpy()[0] - want).max() < (
            len(members) * scale / 2 + 1e-6)


# --------------------------------------------------------------------------
# Params and launch
# --------------------------------------------------------------------------
def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, S.P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tuple(tree)}


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {RPm._path_str(p): tuple(s) for p, s in flat}


@pytest.fixture(scope="module")
def trees():
    lm_ref_cfg = ref_get_arch("smollm-135m").reduced()
    lm = RT.init_lm(jax.random.key(0), lm_ref_cfg)
    lm_t = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, lm), get_arch("smollm-135m").reduced(),
        device=CPU)
    b4r = RR.bert4rec_init(jax.random.key(1), ref_get_arch("bert4rec").reduced())
    b4r_t = convert.bert4rec_params_from_numpy(
        jax.tree.map(np.asarray, b4r), get_arch("bert4rec").reduced(),
        device=CPU)
    return {"lm": (lm, lm_t), "bert4rec": (b4r, b4r_t)}


@pytest.mark.parametrize("rules", sorted(RULE_SETS))
@pytest.mark.parametrize("model", ["lm", "bert4rec"])
def test_param_specs_equal_the_reference(trees, model, rules):
    mesh, ref_mesh, tr, rr = RULE_SETS[rules]
    ref_tree, tree = trees[model]
    with S.mesh_rules(mesh, tr), RS.mesh_rules(ref_mesh, rr):
        for fn, rfn in ((Pm.generic_param_specs, RPm.generic_param_specs),
                        (Pm.lm_param_specs, RPm.lm_param_specs)):
            if model == "bert4rec" and fn is Pm.lm_param_specs:
                continue
            got = _flat(fn(tree))
            assert got == _ref_flat(rfn(ref_tree))
            assert len(got) > 3
        named = Pm.tree_named_shardings(Pm.generic_param_specs(tree))
        assert all(m is mesh for m, _ in _flat_pairs(named))
    assert Pm.TABLE_ROWS_THRESHOLD == RPm.TABLE_ROWS_THRESHOLD
    with pytest.raises(RuntimeError, match="mesh_rules"):
        Pm.tree_named_shardings(Pm.generic_param_specs(tree))


def _flat_pairs(tree):
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _flat_pairs(v)]
    if isinstance(tree, list):
        return [p for v in tree for p in _flat_pairs(v)]
    return [tree]


def test_production_mesh_needs_its_cards():
    assert launch_mesh.mesh_device_count() == 256
    assert launch_mesh.mesh_device_count(multi_pod=True) == 512
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="CUDA devices"):
            launch_mesh.make_production_mesh(multi_pod=multi)


# --------------------------------------------------------------------------
# Flash-decode
# --------------------------------------------------------------------------
def _decode_inputs(b=4, smax=32, hq=8, hkv=2, dh=16):
    return (_rand((b, 1, hq, dh), 4), _rand((b, smax, hkv, dh), 5),
            _rand((b, smax, hkv, dh), 6))


@pytest.mark.parametrize("length,window,softcap,axes", [
    (17, None, 0.0, ("model",)),
    (17, 5, 0.0, ("model",)),         # chunk 0 lies outside the window
    (17, None, 30.0, ("model",)),
    (5, None, 0.0, ("model",)),       # chunks 1-3 fully masked
    (17, 5, 20.0, ("data", "model")),  # 8 chunks, the batch unsplit
])
def test_flash_decode_equals_the_reference_decode(length, window, softcap,
                                                  axes):
    q, k, v = _decode_inputs()
    want = RL.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(length),
        window=None if window is None else jnp.int32(window),
        attn_softcap=softcap)
    with S.mesh_rules(MESH, S.DEFAULT_RULES):
        got = L.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            length, window=window, attn_softcap=softcap, kv_seq_axes=axes)
    assert got.shape == (4, 1, 8, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FD_TOL)


def test_flash_decode_takes_the_dense_path_when_the_cache_does_not_split():
    q, k, v = _decode_inputs(smax=30)  # 30 % 4 != 0
    args = [torch.from_numpy(a) for a in (q, k, v)]
    dense = L.decode_attention(*args, 17, window=7)
    with S.mesh_rules(MESH, S.DEFAULT_RULES):
        got = flash_decode(*args, 17, axis_names=("model",), window=7)
        absent = flash_decode(*args, 17, axis_names=("pod",), window=7)
    assert torch.equal(got, dense) and torch.equal(absent, dense)
    want = RL.decode_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               jnp.int32(17), window=jnp.int32(7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FD_TOL)


def test_decode_step_on_the_mesh_equals_the_decode_off_it():
    """SmolLM ``reduced()``: prefill, then greedy decode steps with the
    cache's sequence over "model" (flash-decode) against the same steps
    with no mesh; logits within 2e-5 and the same tokens."""
    cfg = get_arch("smollm-135m").reduced()
    model = T.init_lm(torch.Generator().manual_seed(0), cfg, device=CPU)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 9)))

    def run(on_mesh):
        logits, cache = T.prefill(model, cfg, tokens, 16)
        tok = logits.argmax(-1, keepdim=True)
        outs = []
        for pos in range(9, 13):
            if on_mesh:
                with S.mesh_rules(MESH, S.DEFAULT_RULES):
                    logits, cache = T.decode_step(model, cfg, cache, tok, pos)
            else:
                logits, cache = T.decode_step(model, cfg, cache, tok, pos)
            outs.append(logits)
            tok = logits.argmax(-1, keepdim=True)
        return torch.stack(outs)

    plain, sharded = run(False), run(True)
    np.testing.assert_allclose(sharded.numpy(), plain.numpy(), **FD_TOL)
    assert torch.equal(sharded.argmax(-1), plain.argmax(-1))
    assert not torch.equal(sharded, plain)  # flash-decode really ran
