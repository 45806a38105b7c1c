"""The port's cells (``repro_torch.launch.cells``) against the reference's
``repro.launch.cells``: every (arch, shape) built under a 1 x 1 mesh in
both packages (a JAX ``Mesh`` of the CPU device; a mesh of one ``meta``
position), and under the dry run's (16, 16) and (2, 16, 16) meshes (a JAX
``AbstractMesh``; meta positions), has the same kind, skip, model flops,
argument shapes and dtypes, and sanitized sharding specs; the rule
overrides and flops functions agree;
the PIR cell functions answer bit for bit; and reduced cells run on the
CPU equal the reference's cell functions on the same inputs and weights.

Tolerances: the LM prefill at 1e-4 (``test_torch_lm.py``'s LM_TOL), the
recommender and the GCN at 1e-5 (``test_torch_recsys.py``,
``test_torch_gnn.py``); PIR bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, Mesh as JMesh, NamedSharding

from repro.configs import get_arch as ref_get_arch
from repro.dist import sharding as RS
from repro.kernels import ref as ref_kernels
from repro.launch import cells as RC
from repro.train import train_step as RT
from repro_torch import convert
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist import sharding as S
from repro_torch.launch import cells as C

from _torch_parity import words_t2n

CELLS = [(a, sp.name) for a in list_archs() for sp in get_arch(a).SHAPES]
LM_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
PIR_VARIANTS = ("baseline", "bf16", "reshard", "xorbfly")
LM_VARIANTS = ("baseline", "fsdp", "fsdp_dots")


def _spec(arch, name, **over):
    sp = next(s for s in get_arch(arch).SHAPES if s.name == name)
    return ShapeSpec.make(sp.name, sp.kind, **dict(sp.p(), **over))


def _ref_spec(arch, name, **over):
    from repro.configs.base import ShapeSpec as RShapeSpec

    sp = next(s for s in ref_get_arch(arch).SHAPES if s.name == name)
    return RShapeSpec.make(sp.name, sp.kind, **dict(sp.p(), **over))


MESHES = {"1x1": ((1, 1), ("data", "model")),
          "pod_16x16": ((16, 16), ("data", "model")),
          "multipod_2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_mesh(kind="1x1"):
    if kind == "1x1":
        return JMesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1),
                     ("data", "model"))
    return AbstractMesh(*MESHES[kind])


def _port_mesh(device="meta", shape=(1, 1)):
    return S.make_mesh(shape, ("data", "model"), [device])


def _ref_rules(sp, multi_pod=False):
    return dict(RS.DEFAULT_RULES, **RC.rules_for_cell(sp, multi_pod))


def _rules(sp, multi_pod=False):
    return dict(S.DEFAULT_RULES, **C.rules_for_cell(sp, multi_pod))


# ------------------------------------------------------------ flattening
def _ref_leaves(tree, is_leaf=None):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx",
                                                     getattr(p, "name", p))))
                       for p in path)
        out[key] = leaf
    return out


def _port_leaves(tree, leaf=lambda x: False, prefix=""):
    if leaf(tree):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, leaf, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        out = {}
        for k, v in zip(names, tree):
            out.update(_port_leaves(v, leaf, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _dtype_name(x) -> str:
    if isinstance(x, int):
        return "int"
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return jnp.dtype(x.dtype).name


def _build_both(arch, name, mesh):
    sp = _spec(arch, name)
    rsp = _ref_spec(arch, name)
    multi = mesh.startswith("multipod")
    ref_base = RS.MULTIPOD_RULES if multi else RS.DEFAULT_RULES
    base = S.MULTIPOD_RULES if multi else S.DEFAULT_RULES
    with RS.mesh_rules(_ref_mesh(mesh),
                       dict(ref_base, **RC.rules_for_cell(rsp, multi))):
        want = RC.build_cell_sanitized(arch, rsp)
    port_mesh = S.make_mesh(MESHES[mesh][0], MESHES[mesh][1], ["meta"])
    with S.mesh_rules(port_mesh, dict(base, **C.rules_for_cell(sp, multi))):
        got = C.build_cell_sanitized(arch, sp, device="meta")
    return got, want


# ------------------------------------------------------------- the cells
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,name", CELLS)
def test_cell_matches_the_reference(arch, name, mesh):
    got, want = _build_both(arch, name, mesh)
    assert (got.arch, got.shape, got.kind) == (want.arch, want.shape, want.kind)
    assert got.skip_reason == want.skip_reason
    assert got.model_flops == want.model_flops
    assert got.donate_argnums == want.donate_argnums
    if want.skip_reason:
        assert got.fn is None and got.args == ()
        return
    ref_args = _ref_leaves(want.args)
    port_args = _port_leaves(got.args)
    assert set(port_args) == set(ref_args)
    for key, r in ref_args.items():
        p = port_args[key]
        shape = tuple(p.shape) if isinstance(p, torch.Tensor) else ()
        assert shape == tuple(r.shape), key
        if isinstance(p, torch.Tensor):
            assert p.device.type == "meta", key
        if arch == "pir-ct":
            # pinned: the parity kernel's uint8 operands, bf16 in the
            # reference (0/1 either way)
            assert (_dtype_name(p), _dtype_name(r)) == ("uint8", "bfloat16")
        elif isinstance(p, int):
            # the decode position: a Python int (decode_step takes int(pos))
            assert _dtype_name(r) == "int32" and key == "3"
        else:
            assert _dtype_name(p) == _dtype_name(r), key
    ref_sh = _ref_leaves(want.in_shardings,
                         is_leaf=lambda x: isinstance(x, NamedSharding))
    port_sh = _port_leaves(got.in_shardings, leaf=C._is_sharding)
    assert set(port_sh) == set(ref_sh)
    for key, r in ref_sh.items():
        assert tuple(port_sh[key][1]) == tuple(r.spec), key


def test_decode_position_is_an_int_that_attends_over_the_whole_cache():
    with S.mesh_rules(_port_mesh(), _rules(_spec("smollm-135m",
                                                 "decode_32k"))):
        cell = C.build_cell("smollm-135m", _spec("smollm-135m", "decode_32k"),
                            device="meta")
    assert cell.args[3] == 32767 and cell.args[1].k.shape[2] == 32768


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("lm_variant", LM_VARIANTS)
@pytest.mark.parametrize("pir_variant", PIR_VARIANTS)
def test_rules_for_cell_match_the_reference(monkeypatch, multi_pod,
                                            lm_variant, pir_variant):
    monkeypatch.setenv("REPRO_LM_VARIANT", lm_variant)
    monkeypatch.setenv("REPRO_PIR_VARIANT", pir_variant)
    seen = set()
    for arch in list_archs():
        for sp, rsp in zip(get_arch(arch).SHAPES, ref_get_arch(arch).SHAPES):
            if sp.kind in seen:
                continue
            seen.add(sp.kind)
            assert (C.rules_for_cell(sp, multi_pod)
                    == RC.rules_for_cell(rsp, multi_pod)), sp.kind
    assert len(seen) == 11


def test_variants_default_as_the_reference(monkeypatch):
    monkeypatch.delenv("REPRO_LM_VARIANT", raising=False)
    monkeypatch.delenv("REPRO_PIR_VARIANT", raising=False)
    assert C._lm_variant() == RC._lm_variant() == "baseline"
    assert C._pir_variant() == RC._pir_variant() == "xorbfly"


@pytest.mark.parametrize("arch", ["fm", "dlrm-rm2", "dien", "bert4rec"])
def test_recsys_flops_match_the_reference(arch):
    for cfg, rcfg in ((get_arch(arch).CONFIG, ref_get_arch(arch).CONFIG),
                      (get_arch(arch).reduced(), ref_get_arch(arch).reduced())):
        for sp in get_arch(arch).SHAPES:
            for train in (True, False):
                b = sp.p()["batch"]
                assert (C._recsys_flops(cfg, b, train)
                        == RC._recsys_flops(rcfg, b, train))


def test_gnn_flops_match_the_reference():
    cfg = get_arch("gcn-cora").CONFIG
    for sp in get_arch("gcn-cora").SHAPES:
        p = sp.p()
        for train in (True, False):
            args = (p["n_nodes"], p["n_edges"], p["d_feat"], cfg.d_hidden,
                    p["n_classes"])
            assert C._gnn_flops(*args, train) == RC._gnn_flops(*args, train)


def test_build_cell_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sp = _spec("gcn-cora", "molecule")
    with S.mesh_rules(_port_mesh("cpu"), _rules(sp)):
        with pytest.raises(RuntimeError, match="CUDA"):
            C.build_cell("gcn-cora", sp)


def test_building_a_cell_outside_mesh_rules_raises():
    with pytest.raises(RuntimeError, match="mesh_rules"):
        C.build_cell("gcn-cora", _spec("gcn-cora", "molecule"), device="meta")


# ------------------------------------------------------------------- PIR
def _pir_cfg():
    return dataclasses.replace(get_arch("pir-ct").reduced(), n_records=250,
                               record_bytes=16)


@pytest.mark.parametrize("variant", PIR_VARIANTS)
def test_pir_functions_equal_the_xor_fold_bit_for_bit(monkeypatch, variant):
    """The four PIR cell functions on a (2, 4) CPU mesh (records over both
    axes for reshard and xorbfly; n padded to 256 with zero records) equal
    the reference's ``xor_fold_ref`` over the store the planes came from."""
    monkeypatch.setenv("REPRO_PIR_VARIANT", variant)
    sp = _spec("pir-ct", "serve_online")
    cfg = _pir_cfg()
    with S.mesh_rules(_port_mesh("cpu", (2, 4)), _rules(sp)):
        cell = C.build_cell_sanitized("pir-ct", sp, device="cpu", seed=3,
                                      cfg=cfg)
        got = cell.fn(*cell.args)
    masks, planes = cell.args
    n_pad = 256 if variant in ("reshard", "xorbfly") else 250
    assert masks.dtype == planes.dtype == torch.uint8
    assert tuple(masks.shape) == (8, n_pad) and planes.is_contiguous()
    words = C.pir_store_words(cfg, n_pad, "cpu", seed=3)
    assert not bool(words[250:].any())
    want = ref_kernels.xor_fold_ref(jnp.asarray(words_t2n(words)),
                                    jnp.asarray(masks.numpy()))
    np.testing.assert_array_equal(words_t2n(got), np.asarray(want))


def test_pir_planes_are_the_stores_bits_in_rows():
    """Pinned: the planes are uint8 rows of the store's bits (the
    reference's bf16 planes hold the same 0/1)."""
    sp = _spec("pir-ct", "serve_online")
    cfg = _pir_cfg()
    with S.mesh_rules(_port_mesh("cpu"), _rules(sp)):
        cell = C.build_cell("pir-ct", sp, device="cpu", seed=1, cfg=cfg)
    words = C.pir_store_words(cfg, cell.args[1].shape[0], "cpu", seed=1)
    from repro.db import packing as RP

    want = np.asarray(RP.unpack_bits(jnp.asarray(words_t2n(words))))
    np.testing.assert_array_equal(cell.args[1].numpy(), want)


# ------------------------------------------------- reduced cells vs the ref
def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32), **tol)


def test_reduced_lm_prefill_cell_matches_the_reference():
    cfg = get_arch("smollm-135m").reduced()
    rcfg = ref_get_arch("smollm-135m").reduced()
    sp = _spec("smollm-135m", "prefill_32k", seq_len=32, global_batch=2)
    with S.mesh_rules(_port_mesh("cpu"), _rules(sp)):
        cell = C.build_cell_sanitized("smollm-135m", sp, device="cpu", cfg=cfg)
        logits, cache = cell.fn(*cell.args)
    params, tokens = cell.args
    with RS.mesh_rules(_ref_mesh(), _ref_rules(_ref_spec(
            "smollm-135m", "prefill_32k"))):
        want_logits, want_cache = RC._prefill_fn(
            _jax(convert.lm_params_to_numpy(params)),
            jnp.asarray(tokens.numpy()), cfg=rcfg, max_len=32)
    _close(logits, want_logits, LM_TOL)
    _close(cache.k, want_cache.k, LM_TOL)
    _close(cache.v, want_cache.v, LM_TOL)


def test_reduced_recsys_serve_cell_matches_the_reference():
    cfg = get_arch("dlrm-rm2").reduced()
    rcfg = ref_get_arch("dlrm-rm2").reduced()
    sp = _spec("dlrm-rm2", "serve_p99", batch=16)
    with S.mesh_rules(_port_mesh("cpu"), _rules(sp)):
        cell = C.build_cell_sanitized("dlrm-rm2", sp, device="cpu", cfg=cfg)
        got = cell.fn(*cell.args)
    params, batch = cell.args
    with RS.mesh_rules(_ref_mesh(), _ref_rules(_ref_spec("dlrm-rm2",
                                                         "serve_p99"))):
        want = RC._recsys_serve_fn(
            _jax(convert.recsys_params_to_numpy(params)),
            {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, cfg=rcfg)
    assert got.shape == (16,)
    _close(got, want, TOL)


def test_gnn_full_graph_step_matches_the_reference():
    sp = _spec("gcn-cora", "full_graph_sm", n_nodes=300, n_edges=1200,
               d_feat=24)
    with S.mesh_rules(_port_mesh("cpu"), _rules(sp)):
        cell = C.build_cell_sanitized("gcn-cora", sp, device="cpu", seed=2)
        state, metrics = cell.fn(*cell.args)
    old, batch = cell.args
    rcfg = dataclasses.replace(ref_get_arch("gcn-cora").CONFIG, n_classes=7)
    init_fn, step_fn = RT.make_train_step(RT.gnn_full_loss_fn(rcfg),
                                          RT.default_optimizer(rcfg))
    rsp = _ref_spec("gcn-cora", "full_graph_sm")
    with RS.mesh_rules(_ref_mesh(), _ref_rules(rsp)):
        rstate, rmetrics = step_fn(
            init_fn(_jax(convert.gcn_params_to_numpy(old.params))),
            {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    _close(metrics["loss"], rmetrics["loss"], TOL)
    for k in state.params:
        _close(state.params[k]["w"], rstate.params[k]["w"], TOL)
    assert int(state.step) == int(rstate.step) == 1
