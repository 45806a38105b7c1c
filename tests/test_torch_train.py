"""The port's training (``repro_torch.train`` and ``models/transformer.py::
train_loss``) against the JAX package on the CPU, at ``reduced()`` sizes
in float32: the same weights (carried across by ``repro_torch.convert``)
and the same numpy batches go through one step of every loss closure in
both packages, and the loss, every gradient and every updated parameter
are compared. Remat, the "dots" policy, loss chunks and microbatches; the
optimizers over several steps on the same trees; the attention
Function's gradient; the chunked Sparse-PIR draws.

Tolerances (float32; the packages' CPU kernels sum in other orders):
the loss 1e-5; gradients and the MoE aux rtol 1e-4, atol 1e-6 (a
gradient is a sum over every position of the batch); the updated
parameters 1e-6 where the reference's gradient is above 1e-6 in size. At
AdamW's first step the update is ≈ g / (|g| + eps): a gradient of ~0 may
come out with either sign in either package, so there each package's
update is held to lr (1 + weight_decay·|p|), the most it can move.
Between two ways of taking the port's own gradient that do the same sums
(remat on or off, the "dots" policy): 0. The optimizers on the same
gradients: 1e-6 over five steps. Checkpoints and a resumed run: 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import list_archs as ref_list_archs
from repro.data import pipeline as ref_pipeline
from repro.models import gnn as RG
from repro.models import layers as RL
from repro.models import recsys as RR
from repro.models import transformer as RT
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data import (
    NeighborSampler, bert4rec_batch, gnn_full_graph, lm_batch,
    molecule_batch, recsys_batch,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import tree_leaves, tree_map

from _torch_parity import CPU

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-6, atol=1e-6)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
LR = 3e-4   # default_optimizer's AdamW
WD = 0.01


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_grads(loss_fn, params, batch):
    return ts.value_and_grad(loss_fn, params, batch)


def _pairs(got, want, path=""):
    """(path, port leaf as numpy, reference leaf as numpy) over the port's
    tree and the reference's pytree of the same layout."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        for k in got:
            yield from _pairs(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            yield from _pairs(g, w, f"{path}/{i}")
    else:
        yield path, got.detach().float().numpy(), np.asarray(want, np.float32)


def _close_trees(got, want, tol):
    for path, g, w in _pairs(got, want):
        np.testing.assert_allclose(g, w, err_msg=path, **tol)


def _close_updates(got, want, start, ref_grads):
    """AdamW's first step: exact where |g_ref| > 1e-6; elsewhere each
    package's update at most lr (1 + wd·|p|)."""
    for (path, g, w), (_, p0, _), (_, _, gr) in zip(
            _pairs(got, want), _pairs(start, want), _pairs(start, ref_grads)):
        big = np.abs(gr) > 1e-6
        np.testing.assert_allclose(g[big], w[big], err_msg=path, **PARAM_TOL)
        bound = LR * (1 + WD * np.abs(p0[~big])) * (1 + 1e-5) + 1e-7
        assert np.all(np.abs(g[~big] - p0[~big]) <= bound), path
        assert np.all(np.abs(w[~big] - p0[~big]) <= bound), path


def _one_step(ref_loss, port_loss, ref_params, port_params, batch,
              microbatches=1):
    """One step of both packages from the same weights and batch: checks
    the loss, the gradients and the updated parameters; returns the
    port's new state."""
    ref_opt_ = ref_ts.AdamW(lr=LR)
    (want_loss, want_m), want_g = jax.value_and_grad(ref_loss, has_aux=True)(
        ref_params, _jnp(batch))
    got_loss, got_m, got_g = _port_grads(port_loss, port_params, batch)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **LOSS_TOL)
    assert sorted(got_m) == sorted(want_m)
    for k in got_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]),
                                   **GRAD_TOL)
    _close_trees(got_g, want_g, GRAD_TOL)

    init_r, step_r = ref_ts.make_train_step(ref_loss, ref_opt_,
                                            microbatches=microbatches)
    state_r, metrics_r = jax.jit(step_r)(init_r(ref_params), _jnp(batch))
    init_p, step_p = ts.make_train_step(port_loss, opt.AdamW(lr=LR),
                                        microbatches=microbatches)
    state_p, metrics_p = step_p(init_p(port_params), batch)
    if microbatches == 1:
        np.testing.assert_allclose(metrics_p["loss"].item(),
                                   got_loss.item(), rtol=0, atol=0)
    np.testing.assert_allclose(metrics_p["loss"].item(),
                               float(metrics_r["loss"]), **LOSS_TOL)
    np.testing.assert_allclose(metrics_p["grad_norm"].item(),
                               float(metrics_r["grad_norm"]), **GRAD_TOL)
    assert int(state_p.step) == int(state_r.step) == 1
    _close_updates(state_p.params, state_r.params, port_params, want_g)
    _close_trees(state_p.opt_state["m"], state_r.opt_state["m"], GRAD_TOL)
    return state_p


# ----------------------------------------------------------------- the LM
def _lm(arch, **over):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), **over)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    params = RT.init_lm(jax.random.key(0), ref_cfg)
    mine = L.as_tree(convert.lm_params_from_numpy(_np(params), cfg,
                                                  device=CPU))
    return ref_cfg, cfg, params, mine


@pytest.mark.parametrize("arch", ["smollm-135m", "moonshot-v1-16b-a3b",
                                  "gemma2-2b"])
def test_one_lm_step_matches_the_reference(arch):
    """Dense, MoE (the aux loss in the loss) and gemma-2 (softcaps and the
    local window, which the sequence of 32 passes at its reduced 16)."""
    ref_cfg, cfg, params, mine = _lm(arch)
    batch = lm_batch(cfg, 4, 32, seed=0, step=0)
    assert np.array_equal(
        batch["tokens"], ref_pipeline.lm_batch(ref_cfg, 4, 32, 0, 0)["tokens"])
    _one_step(ref_ts.lm_loss_fn(ref_cfg), ts.lm_loss_fn(cfg), params, mine,
              {"tokens": batch["tokens"]})


@pytest.mark.parametrize("over", [
    dict(remat=True),
    dict(remat=True, remat_policy="dots"),
    dict(loss_chunk=8),
    dict(remat=True, loss_chunk=8),
], ids=["remat", "remat_dots", "loss_chunk", "remat_loss_chunk"])
def test_remat_and_loss_chunks_match_the_reference(over):
    """Each variant against the reference's same variant; remat (with
    either policy) gives the port's plain gradient bit for bit."""
    ref_cfg, cfg, params, mine = _lm("smollm-135m", **over)
    batch = {"tokens": lm_batch(cfg, 2, 32, seed=1, step=0)["tokens"]}
    want_g = jax.grad(lambda p, b: RT.train_loss(p, ref_cfg, b["tokens"])[0])(
        params, _jnp(batch))
    loss, _, grads = _port_grads(ts.lm_loss_fn(cfg), mine, batch)
    _close_trees(grads, want_g, GRAD_TOL)
    plain = dataclasses.replace(cfg, remat=False, remat_policy="nothing")
    loss0, _, grads0 = _port_grads(ts.lm_loss_fn(plain), mine, batch)
    if cfg.loss_chunk == plain.loss_chunk:
        assert loss.item() == loss0.item()
        for (path, g, w) in _pairs(grads, _np_tree(grads0)):
            np.testing.assert_array_equal(g, w, err_msg=path)
    else:
        _close_trees(grads, _np_tree(grads0), GRAD_TOL)


def _np_tree(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def test_the_dots_policy_keeps_the_matmuls_and_recomputes_the_rest(
        monkeypatch):
    """Under "dots" the backward recomputes fewer ops than under
    "nothing" and as many as the forward ran less its matmuls."""
    from torch.utils.checkpoint import CheckpointPolicy

    calls = []
    orig = T._dots_policy

    def spy(ctx, op, *args, **kwargs):
        decision = orig(ctx, op, *args, **kwargs)
        calls.append((op, decision))
        return decision

    _, cfg, _, mine = _lm("smollm-135m", remat=True, remat_policy="dots")
    batch = {"tokens": lm_batch(cfg, 2, 16, seed=1, step=0)["tokens"]}
    monkeypatch.setattr(T, "_dots_policy", spy)
    _port_grads(ts.lm_loss_fn(cfg), mine, batch)
    saved = [op for op, d in calls if d == CheckpointPolicy.MUST_SAVE]
    assert saved and all(op in T._DOTS for op in saved)
    assert any(d == CheckpointPolicy.PREFER_RECOMPUTE for _, d in calls)


def test_microbatches_match_the_reference():
    ref_cfg, cfg, params, mine = _lm("smollm-135m")
    batch = {"tokens": lm_batch(cfg, 4, 16, seed=2, step=3)["tokens"]}
    init_r, step_r = ref_ts.make_train_step(
        ref_ts.lm_loss_fn(ref_cfg), ref_ts.AdamW(lr=LR), microbatches=2)
    state_r, m_r = jax.jit(step_r)(init_r(params), _jnp(batch))
    init_p, step_p = ts.make_train_step(ts.lm_loss_fn(cfg), opt.AdamW(lr=LR),
                                        microbatches=2)
    state_p, m_p = step_p(init_p(mine), batch)
    assert sorted(m_p) == sorted(m_r)
    for k in m_p:
        np.testing.assert_allclose(m_p[k].item(), float(m_r[k]), **GRAD_TOL)
    # the summed-then-halved gradient is what AdamW's m holds after a step
    _close_trees(state_p.opt_state["m"], state_r.opt_state["m"], GRAD_TOL)
    # (the mean of the two halves' mean losses is the whole batch's: each
    # half has as many target positions)
    _, want_g = jax.value_and_grad(ref_ts.lm_loss_fn(ref_cfg),
                                   has_aux=True)(params, _jnp(batch))
    _close_updates(state_p.params, state_r.params, mine, want_g)
    with pytest.raises(ValueError, match="microbatches"):
        ts.make_train_step(ts.lm_loss_fn(cfg), opt.AdamW(), microbatches=3)[1](
            init_p(mine), batch)


# ------------------------------------------------------ the GCN and recsys
def _gcn(d_feat):
    ref_cfg, cfg = ref_get_arch("gcn-cora").CONFIG, get_arch("gcn-cora").CONFIG
    params = RG.gcn_init(jax.random.key(0), ref_cfg, d_feat)
    mine = L.as_tree(convert.gcn_params_from_numpy(_np(params), cfg,
                                                   device=CPU))
    return ref_cfg, cfg, params, mine


@pytest.mark.parametrize("kind", ["full", "minibatch", "molecule"])
def test_one_gnn_step_matches_the_reference(kind):
    if kind == "full":
        batch = gnn_full_graph(300, 1100, 12, 7, seed=2, pad_to=8)
        fns = (ref_ts.gnn_full_loss_fn, ts.gnn_full_loss_fn)
    elif kind == "minibatch":
        sampler = NeighborSampler.random_graph(400, 6, 10, 5, seed=3)
        batch = sampler.sample(np.arange(8), step=1)
        fns = (ref_ts.gnn_minibatch_loss_fn, ts.gnn_minibatch_loss_fn)
    else:
        batch = molecule_batch(5, 9, 14, 6, 2, seed=0, step=0)
        fns = (ref_ts.gnn_molecule_loss_fn, ts.gnn_molecule_loss_fn)
    ref_cfg, cfg, params, mine = _gcn(batch["feats"].shape[-1])
    _one_step(fns[0](ref_cfg), fns[1](cfg), params, mine, batch)


RECSYS = {"fm": RR.fm_init, "dlrm-rm2": RR.dlrm_init, "dien": RR.dien_init,
          "bert4rec": RR.bert4rec_init}


@pytest.mark.parametrize("arch", list(RECSYS))
def test_one_recsys_step_matches_the_reference(arch):
    ref_cfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    params = RECSYS[arch](jax.random.key(0), ref_cfg)
    if arch == "bert4rec":
        mine = convert.bert4rec_params_from_numpy(_np(params), cfg, device=CPU)
        batch = bert4rec_batch(cfg, 3, seed=1, step=2)
    else:
        mine = convert.recsys_params_from_numpy(_np(params), cfg, device=CPU)
        batch = recsys_batch(cfg, 4, 0, 0)
    _one_step(ref_ts.recsys_loss_fn(ref_cfg), ts.recsys_loss_fn(cfg), params,
              L.as_tree(mine), batch)


# ------------------------------------------------------------ optimizers
def _tree(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (3, 5, 7), "b": (4, 6), "c": (9,), "d": ()}
# the reference's Adafactor takes leaves of one dim or more
FACTORED_SHAPES = {k: s for k, s in SHAPES.items() if s}


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in tree.items()}


@pytest.mark.parametrize("name,kw", [("AdamW", dict(lr=1e-2)),
                                     ("Adafactor", dict(lr=1e-2)),
                                     ("Adafactor", dict(lr=5e-3, decay=0.5))])
def test_optimizers_match_the_reference_over_five_steps(name, kw):
    ref_o, mine = getattr(ref_opt, name)(**kw), getattr(opt, name)(**kw)
    shapes = SHAPES if name == "AdamW" else FACTORED_SHAPES
    p_r = {k: jnp.asarray(v) for k, v in _tree(0, shapes).items()}
    p_t = _torch_tree(_tree(0, shapes))
    s_r, s_t = ref_o.init(p_r), mine.init(p_t)
    assert jax.tree.map(np.shape, s_r) == tree_map(
        lambda t: tuple(t.shape), s_t)
    for step in range(5):
        g = _tree(10 + step, shapes, scale=0.5 + step)
        p_r, s_r, m_r = ref_o.update({k: jnp.asarray(v) for k, v in g.items()},
                                     s_r, p_r)
        p_t, s_t, m_t = mine.update(_torch_tree(g), s_t, p_t)
        _close_trees(p_t, p_r, OPT_TOL)
        _close_trees(s_t, s_r, OPT_TOL)
        np.testing.assert_allclose(m_t["grad_norm"].item(),
                                   float(m_r["grad_norm"]), **OPT_TOL)


def test_adafactor_keeps_big_tensors_in_the_param_dtype():
    """bf16 parameters come back bf16 and the factored state f32, with the
    reference's shapes; the updates agree within bf16 rounding."""
    shapes = {"w": (2, 8, 16), "b": (16,)}
    base = _tree(0, shapes)
    p_r = {k: jnp.asarray(v, jnp.bfloat16) for k, v in base.items()}
    p_t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in base.items()}
    g = _tree(1, shapes)
    new_r, s_r, _ = ref_opt.Adafactor().update(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
        ref_opt.Adafactor().init(p_r), p_r)
    new_t, s_t, _ = opt.Adafactor().update(
        {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()},
        opt.Adafactor().init(p_t), p_t)
    assert {k: v.dtype for k, v in new_t.items()} == {
        "w": torch.bfloat16, "b": torch.bfloat16}
    assert s_t["second"]["w"]["row"].shape == (2, 8)
    assert s_t["second"]["w"]["col"].shape == (2, 16)
    assert s_t["second"]["w"]["row"].dtype == torch.float32
    _close_trees(new_t, new_r, dict(rtol=1e-2, atol=1e-2))
    _close_trees(s_t, s_r, OPT_TOL)


def test_clip_by_global_norm_matches_the_reference():
    g = {"a": np.full((4,), 100.0, np.float32),
         "b": np.full((2,), -100.0, np.float32)}
    clipped, norm = opt.clip_by_global_norm(_torch_tree(g), 1.0)
    want, want_norm = ref_opt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    _close_trees(clipped, want, OPT_TOL)
    assert norm.item() == pytest.approx(float(want_norm), rel=1e-6)
    small = {"a": np.full((3,), 0.1, np.float32)}
    same, _ = opt.clip_by_global_norm(_torch_tree(small), 1.0)
    np.testing.assert_array_equal(same["a"].numpy(), small["a"])
    bf = {"a": torch.full((4,), 100.0, dtype=torch.bfloat16)}
    assert opt.clip_by_global_norm(bf, 1.0)[0]["a"].dtype == torch.bfloat16


def test_error_feedback_compressor_matches_the_reference():
    ref_c, mine = ref_opt.ErrorFeedbackCompressor(True), opt.ErrorFeedbackCompressor(True)
    params = _tree(0, SHAPES)
    e_r = ref_c.init({k: jnp.asarray(v) for k, v in params.items()})
    e_t = mine.init(_torch_tree(params))
    acc = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    for step in range(6):
        g = _tree(20 + step, SHAPES, scale=1e-3)
        gh_r, e_r = ref_c.apply({k: jnp.asarray(v) for k, v in g.items()}, e_r)
        gh_t, e_t = mine.apply(_torch_tree(g), e_t)
        _close_trees(gh_t, gh_r, OPT_TOL)
        _close_trees(e_t, e_r, OPT_TOL)
        for k in acc:
            acc[k] += g[k]
    off = opt.ErrorFeedbackCompressor(False)
    assert off.init(_torch_tree(params)) == {}
    same, err = off.apply(_torch_tree(params), {})
    assert err == {} and torch.equal(same["a"], torch.from_numpy(params["a"]))


def test_default_optimizer_chooses_as_the_reference():
    for arch in ref_list_archs():
        ref_cfg, cfg = ref_get_arch(arch).CONFIG, get_arch(arch).CONFIG
        want, got = ref_ts.default_optimizer(ref_cfg), ts.default_optimizer(cfg)
        assert type(got).__name__ == type(want).__name__, arch
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch


# ---------------------------------------------------- the attention Function
ATTN_CASES = [
    dict(causal=True, window=None, cap=0.0, hq=4, hkv=4),
    dict(causal=True, window=5, cap=0.0, hq=4, hkv=2),
    dict(causal=True, window=None, cap=3.0, hq=6, hkv=2),
    dict(causal=False, window=None, cap=0.0, hq=2, hkv=1),
    dict(causal=True, window=7, cap=2.0, hq=4, hkv=1),
]


@pytest.mark.parametrize("chunk", [2048, 4], ids=["whole", "chunked"])
@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=["causal", "window_gqa", "cap_gqa",
                              "bidirectional_mqa", "all"])
def test_flash_function_gradient_equals_the_plain_path(case, chunk,
                                                       monkeypatch):
    """The Function's forward goes through the launch (here the plain
    version, as on a CPU tensor), its backward through the plain path:
    the gradients equal autograd through the plain path and the
    reference's jax.grad of its gqa_attention."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    launched = []

    def launch(*a, **kw):
        launched.append(1)
        return flash_attention_plain(*a, **kw)

    monkeypatch.setattr(L, "flash_attention_fwd", launch)
    monkeypatch.setattr(L, "ATTN_CHUNK_Q", chunk)
    monkeypatch.setattr(RL, "ATTN_CHUNK_Q", chunk)
    rng = np.random.default_rng(3)
    b, s, d, hq, hkv = 2, 16, 8, case["hq"], case["hkv"]
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    w = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    args = (case["causal"], case["window"], case["cap"], 0)

    def port(fn):
        qt, kt, vt = (torch.from_numpy(x.copy()).requires_grad_()
                      for x in (q, k, v))
        out = fn(qt, L._repeat_kv(kt, hq // hkv), L._repeat_kv(vt, hq // hkv))
        torch.sum(out * torch.from_numpy(w)).backward()
        return out.detach(), [t.grad.numpy() for t in (qt, kt, vt)]

    out, grads = port(lambda *t: L._FlashAttention.apply(*t, *args))
    assert launched == [1]
    plain_out, plain_grads = port(lambda *t: L._plain_attention(*t, *args))
    np.testing.assert_allclose(out.numpy(), plain_out.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(RL.gqa_attention(
        q_, k_, v_, causal=case["causal"], window=case["window"],
        attn_softcap=case["cap"]) * w), argnums=(0, 1, 2))(q, k, v)
    for got, plain, ref in zip(grads, plain_grads, want):
        np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("mode", ["no_grad", "no_input_requires_grad",
                                  "training"])
def test_flash_function_saves_q_k_v_only_for_a_backward(mode, monkeypatch):
    """Serving keeps no more memory than the bare launch: under
    ``no_grad``, or when no input requires grad, the Function's output has
    no grad_fn and autograd packs none of what it saved; in training it
    packs q, k and v, and nothing else."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    monkeypatch.setattr(L, "flash_attention_fwd", flash_attention_plain)
    gen = torch.Generator().manual_seed(0)
    qkv = [torch.randn((1, 8, 2, 4), generator=gen).requires_grad_(
        mode != "no_input_requires_grad") for _ in range(3)]
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.set_grad_enabled(mode != "no_grad"):
            out = L._FlashAttention.apply(*qkv, True, None, 0.0, 0)
    if mode == "training":
        assert out.grad_fn is not None
        assert len(packed) == 3
        assert all(p is t for p, t in zip(packed, qkv))
    else:
        assert out.grad_fn is None
        assert packed == []


# ------------------------------------------------- Sparse-PIR draws in chunks
def test_a_count_within_the_limit_is_one_multinomial_call():
    """Every stream drawn before chunking keeps its bits: a count at or
    below ``MAX_CARD_DRAWS`` is one ``torch.multinomial`` call."""
    from repro_torch.core import sparse

    logits = sparse.parity_weight_logits(6, 0.25)[0]
    probs = torch.tensor(np.exp(logits - logits[np.isfinite(logits)].max()),
                         dtype=torch.float32)
    for count in (1, 1000, 4097):
        got = sparse._categorical(torch.Generator().manual_seed(5), logits,
                                  count)
        want = torch.multinomial(probs, count, replacement=True,
                                 generator=torch.Generator().manual_seed(5))
        assert got.dtype == torch.uint8
        assert torch.equal(got, want.to(torch.uint8))


@pytest.mark.parametrize("limit", [1000, 4096, 7777])
def test_chunked_draws_follow_the_law_and_recover_records(limit, monkeypatch):
    """With ``MAX_CARD_DRAWS`` patched small, a plan of 20 000 x 4 column
    weights is drawn in chunks: the even/odd parities hold, the row
    weights follow the law pinned in tests/test_torch_schemes.py, and the
    retrieve returns the records exactly; the draws were made in
    ceil(80 000 / limit) calls. (The CPU's generator draws with
    replacement one value after another, so there the chunks give the
    one-call stream's bits.)"""
    from repro_torch.core import sparse
    from repro_torch.db import make_synthetic_store

    import math

    n, b, d, theta = 20_000, 4, 4, 0.25
    one_call = sparse.precompute_query_randomness(
        torch.Generator().manual_seed(11), n, d, theta, b)
    monkeypatch.setattr(sparse, "MAX_CARD_DRAWS", limit)
    calls = []
    multinomial = torch.multinomial

    def counted(probs, count, **kw):
        calls.append(count)
        return multinomial(probs, count, **kw)

    monkeypatch.setattr(torch, "multinomial", counted)
    pre = sparse.precompute_query_randomness(
        torch.Generator().manual_seed(11), n, d, theta, b)
    assert calls[:-1] == [limit] * (n * b // limit) + (
        [n * b % limit] if n * b % limit else [])
    assert calls[-1] == b  # the queried columns' odd weights
    assert pre.w_even.dtype == torch.uint8 and pre.w_even.shape == (b, n)
    assert int((pre.w_even % 2).sum()) == 0
    assert int((pre.w_q % 2).min()) == 1
    assert torch.equal(pre.w_even, one_call.w_even)
    m = sparse.gen_query_matrix(torch.Generator().manual_seed(11), n, d,
                                theta, torch.zeros(b, dtype=torch.int32))
    weights = m.to(torch.float64).sum(-1)  # [d, B]
    x = (1 - 2 * theta) ** d
    p_even = theta * (1 - x / (1 - 2 * theta)) / (1 + x)
    sigma_mean = math.sqrt(n * p_even * (1 - p_even) / (d * b))
    assert abs(float(weights.mean()) - p_even * n) < 6 * sigma_mean
    store = make_synthetic_store(n, 8, seed=3, device="cpu")
    q_idx = torch.tensor([0, n - 1, n // 2, 77], dtype=torch.int32)
    out = sparse.retrieve(torch.Generator().manual_seed(2), store, d, theta,
                          q_idx)
    assert torch.equal(out, store.packed[q_idx.long()])
