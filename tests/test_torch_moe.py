"""The port's MoE block (``repro_torch.models.moe``) on the CPU against the
JAX package's ``repro.models.moe``, with the same inputs (numpy seeds)
and the same weights (the reference's ``moe_init`` carried across as
numpy).

Tolerances: capacities, capacity positions, routing (the top-k experts
and which assignments drop) are compared exactly; outputs at rtol = atol
= 1e-5 in f32 (the two packages' CPU products sum in other orders); the
aux loss at 1e-6 (a mean of f32 probabilities). The mesh branch runs on a
(2, 4) mesh of CPU positions and is held to a composition of the
reference's own ``_moe_local``, called once per (batch block, expert
block) with that block's ``e0`` and the capacity of its local token
count, then summed: the reference's ``shard_map`` semantics without a
mesh of devices."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_arch as ref_get_arch
from repro.dist import params as RPm
from repro.dist import sharding as RS
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.dist import params as Pm
from repro_torch.dist import sharding as S
from repro_torch.models import moe as M

from _torch_parity import CPU

TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = dict(rtol=1e-6, atol=1e-7)
MOE_ARCHS = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
MESH = S.make_mesh((2, 4), ("data", "model"), [CPU])


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _params(cfg, seed):
    ref = RM.moe_init(jax.random.key(seed), cfg.d_model, cfg.d_ff,
                      cfg.n_experts)
    arrays = {k: np.asarray(v) for k, v in ref.items()}
    return ref, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def _ref_routing(params, x, top_k, capacity):
    """The reference's routing decisions, from its own pieces (the lines
    of its ``_moe_local`` before the dispatch)."""
    logits = (x @ params["router"].astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, top_k)
    pos = RM._positions_within_expert(top_e.reshape(-1)).reshape(
        top_e.shape)
    return np.asarray(top_e), np.asarray(pos) < capacity


def test_capacity_equals_the_reference_over_a_sweep():
    for t in (1, 7, 8, 64, 100, 4096, 8192):
        for e, k in ((8, 2), (64, 6), (384, 8)):
            for f in (0.5, 1.0, 1.25, 2.0):
                assert M.moe_capacity(t, e, k, f) == RM.moe_capacity(t, e, k,
                                                                     f)
    # the serving cells of this slice: Moonlight prefill and decode, Kimi
    assert M.moe_capacity(4096, 64, 6, 1.25) == 480
    assert M.moe_capacity(4, 64, 6, 1.25) == 8
    assert M.moe_capacity(4096, 384, 8, 1.25) == 112


@pytest.mark.parametrize("n,e,seed", [(1, 1, 0), (64, 2, 1), (500, 3, 2),
                                      (777, 8, 3), (1000, 64, 4)])
def test_positions_within_expert_equal_the_reference_on_collisions(n, e,
                                                                   seed):
    ids = np.random.default_rng(seed).integers(0, e, size=n).astype(np.int32)
    got = M._positions_within_expert(torch.from_numpy(ids).long())
    want = RM._positions_within_expert(jnp.asarray(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_apply_equals_the_reference(arch, factor):
    cfg = get_arch(arch).reduced()
    ref, params = _params(cfg, seed=3)
    x = _rand((2, 24, cfg.d_model), 5)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=factor)
    y, aux = M.moe_apply(params, torch.from_numpy(x), **kw)
    want_y, want_aux = RM.moe_apply(ref, jnp.asarray(x), **kw)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **AUX_TOL)

    # the same experts, in the same order, and the same drops
    cap = M.moe_capacity(48, cfg.n_experts, cfg.top_k, factor)
    r = M.moe_route(torch.from_numpy(x).reshape(48, -1), params["router"],
                    top_k=cfg.top_k, capacity=cap)
    top_e, keep = _ref_routing(ref, jnp.asarray(x).reshape(48, -1),
                               cfg.top_k, cap)
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if factor < 1:
        assert not keep.all()  # drops happen, and they are the same ones


def test_ties_go_to_the_lower_expert_id():
    # a zero router gives every expert the same probability: the reference
    # (jax.lax.top_k) takes experts 0 .. k-1 for every token
    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    _, params = _params(cfg, seed=0)
    params["router"] = torch.zeros_like(params["router"])
    r = M.moe_route(torch.from_numpy(_rand((5, cfg.d_model), 1)),
                    params["router"], top_k=cfg.top_k, capacity=8)
    assert r.top_e.tolist() == [list(range(cfg.top_k))] * 5


def _per_block_reference(ref, x, cfg, factor):
    """The reference's shard_map branch written out: batch blocks over
    "data" (2), expert blocks over "model" (4)."""
    b_sh, e_sh = 2, 4
    t = x.shape[0]
    t_loc, e_loc = t // b_sh, cfg.n_experts // e_sh
    cap = RM.moe_capacity(t_loc, cfg.n_experts, cfg.top_k, factor)
    ys, auxes = [], []
    for b in range(b_sh):
        xb = jnp.asarray(x[b * t_loc:(b + 1) * t_loc])
        y, aux = 0.0, 0.0
        for e in range(e_sh):
            sl = slice(e * e_loc, (e + 1) * e_loc)
            ye, ae = RM._moe_local(
                xb, ref["router"], ref["w_gate"][sl], ref["w_in"][sl],
                ref["w_out"][sl], e0=e * e_loc, n_experts=cfg.n_experts,
                top_k=cfg.top_k, capacity=cap)
            y, aux = y + ye, aux + ae
        ys.append(np.asarray(y))
        auxes.append(float(aux) / e_sh)
    return np.concatenate(ys), float(np.mean(auxes))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_the_mesh_branch_equals_the_reference_per_block(arch, factor):
    cfg = get_arch(arch).reduced()
    ref, params = _params(cfg, seed=7)
    x = _rand((2, 20, cfg.d_model), 8)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=factor)
    with S.mesh_rules(MESH, S.DEFAULT_RULES):
        y, aux = M.moe_apply(params, torch.from_numpy(x), **kw)
    want_y, want_aux = _per_block_reference(ref, x.reshape(40, -1), cfg,
                                            factor)
    np.testing.assert_allclose(y.numpy().reshape(40, -1), want_y, **TOL)
    np.testing.assert_allclose(float(aux), want_aux, **AUX_TOL)
    # local capacities (from 20 tokens a block) drop other assignments
    # than the global one (40 tokens): the unsharded block differs
    flat, _ = M.moe_apply(params, torch.from_numpy(x), **kw)
    if factor < 1:
        assert not torch.allclose(flat, y, **TOL)


def test_each_position_takes_views_of_its_expert_block():
    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    _, params = _params(cfg, seed=9)
    blocks = M.expert_blocks(params, MESH, ("model",), cfg.n_experts // 4)
    assert len(blocks) == MESH.size
    for i, pos in enumerate(MESH.positions()):
        for name, view in zip(("w_gate", "w_in", "w_out"), blocks[i]):
            whole = params[name]
            lo = whole.data_ptr()
            hi = lo + whole.numel() * whole.element_size()
            assert lo <= view.data_ptr() < hi  # a view, not a copy
            assert torch.equal(view, whole[pos[1] * 2:(pos[1] + 1) * 2])


def test_the_mesh_branch_refuses_what_does_not_divide():
    cfg = get_arch("moonshot-v1-16b-a3b").reduced()
    _, params = _params(cfg, seed=1)
    with S.mesh_rules(MESH, S.DEFAULT_RULES), pytest.raises(ValueError):
        M.moe_apply(params, torch.zeros((3, cfg.d_model)),
                    n_experts=cfg.n_experts, top_k=cfg.top_k)


def test_moe_init_has_the_reference_layout_and_an_f32_router():
    gen = torch.Generator().manual_seed(0)
    got = M.moe_init(gen, 16, 24, 8, torch.bfloat16, device=CPU)
    want = jax.eval_shape(
        lambda: RM.moe_init(jax.random.key(0), 16, 24, 8, jnp.bfloat16))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert float(got["w_out"].float().std()) == pytest.approx(24**-0.5,
                                                               rel=0.2)


def test_moe_weights_carry_across_with_the_router_in_f32():
    ref_cfg = dataclasses.replace(
        ref_get_arch("moonshot-v1-16b-a3b").reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").reduced(),
                              dtype="bfloat16")
    params = RT.init_lm(jax.random.key(2), ref_cfg)
    tree = jax.tree.map(np.asarray, params)
    model = convert.lm_params_from_numpy(tree, cfg, device=CPU)
    moe = model.tree()["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert all(moe[k].dtype == torch.bfloat16
               for k in ("w_gate", "w_in", "w_out"))
    np.testing.assert_array_equal(moe["router"].numpy(),
                                  tree["layers"]["moe"]["router"])
    widened = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                           params)
    back = convert.lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(widened)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, widened)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_specs_of_a_moe_tree_equal_the_reference(arch):
    ref_params = RT.init_lm(jax.random.key(4), ref_get_arch(arch).reduced())
    model = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, ref_params), get_arch(arch).reduced(),
        device=CPU)
    with S.mesh_rules(MESH, S.DEFAULT_RULES), RS.mesh_rules(
            AbstractMesh((2, 4), ("data", "model")), RS.DEFAULT_RULES):
        got = _flat(Pm.lm_param_specs(model))
        flat, _ = jax.tree_util.tree_flatten_with_path(
            RPm.lm_param_specs(ref_params),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = {RPm._path_str(p): tuple(s) for p, s in flat}
    assert got == want
    assert got["layers/moe/w_gate"] == (None, "model", "data")
    assert got["layers/moe/w_out"] == (None, "model", None, "data")
    assert got["layers/moe/router"] == ()
