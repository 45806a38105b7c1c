"""The port's model layers and the LM family's serving (prefill + decode:
SmolLM-135M, gemma-2, Mistral-NeMo, Moonlight and Kimi-K2 at their
``reduced()`` sizes) on the CPU against the JAX package, with the same
inputs (numpy seeds) and the same weights (the reference's ``init_lm``
carried across by ``repro_torch.convert``).

Tolerances: layers 1e-5 (f32; the packages' CPU kernels sum in other
orders), the reduced models' logits and KV cache 1e-4 (two layers of
those differences; for the MoE archs the routing is the same, so no
token changes experts). Configs, shapes and data are compared exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import list_archs as ref_list_archs
from repro.data import pipeline as ref_pipeline
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import get_arch, list_archs
from repro_torch.data import lm_batch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

from _torch_parity import CPU

TOL = dict(rtol=1e-5, atol=1e-5)
LM_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ------------------------------------------------------------------ layers
def test_dense_norms_rope_softcap_match_the_reference():
    x = _rand((2, 5, 3, 16), 0)
    w = {"w": _rand((16, 24), 1, 0.25)}
    _close(L.dense({"w": _t(w["w"])}, _t(x)), RL.dense(w, jnp.asarray(x)))
    scale = {"scale": _rand((16,), 2, 0.1)}
    _close(L.rmsnorm({"scale": _t(scale["scale"])}, _t(x)),
           RL.rmsnorm(scale, jnp.asarray(x)))
    ln = {"scale": _rand((16,), 3), "bias": _rand((16,), 4)}
    _close(L.layernorm({k: _t(v) for k, v in ln.items()}, _t(x)),
           RL.layernorm(ln, jnp.asarray(x)))
    pos = np.broadcast_to(np.arange(5, dtype=np.int32) + 3, (2, 5)).copy()
    _close(L.rope(_t(x), _t(pos), 500.0), RL.rope(jnp.asarray(x), jnp.asarray(pos), 500.0))
    big = x * 40.0
    _close(L.softcap(_t(big), 30.0), RL.softcap(jnp.asarray(big), 30.0))
    assert L.softcap(_t(x), 0.0) is not None
    _close(L._repeat_kv(_t(x), 3), RL._repeat_kv(jnp.asarray(x), 3), dict(rtol=0, atol=0))


def test_mlps_match_the_reference():
    x = _rand((3, 7, 16), 5)
    sw = {k: {"w": _rand(s, i, 0.2)} for i, (k, s) in
          enumerate((("wi", (16, 40)), ("wg", (16, 40)), ("wo", (40, 16))))}
    to_t = lambda tree: jax.tree.map(_t, tree)  # noqa: E731
    _close(L.swiglu(to_t(sw), _t(x)), RL.swiglu(sw, jnp.asarray(x)))
    gm = {f"l{i}": {"w": _rand(s, 10 + i, 0.3)}
          for i, s in enumerate(((16, 64), (64, 16)))}
    for final_act in (False, True):
        _close(L.gelu_mlp(to_t(gm), _t(x), final_act=final_act),
               RL.gelu_mlp(gm, jnp.asarray(x), final_act=final_act))


GQA_CASES = [
    # (b, sq, sk, hq, hkv, d, causal, window, softcap, q_offset)
    (2, 24, 24, 4, 2, 16, True, None, 0.0, 0),     # GQA groups of 2
    (1, 33, 33, 6, 2, 8, True, 7, 0.0, 0),         # window
    (2, 16, 16, 4, 4, 16, False, None, 0.0, 0),    # bidirectional
    (1, 20, 20, 4, 1, 16, True, None, 25.0, 0),    # logit softcap, MQA
    (1, 8, 40, 2, 1, 16, True, 12, 0.0, 32),       # query offset + window
    (1, 4096, 4096, 1, 1, 8, True, None, 0.0, 0),  # chunked at ATTN_CHUNK_Q
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window,cap,off", GQA_CASES)
def test_gqa_attention_matches_the_reference(b, sq, sk, hq, hkv, d, causal,
                                             window, cap, off):
    q = _rand((b, sq, hq, d), 20)
    k = _rand((b, sk, hkv, d), 21)
    v = _rand((b, sk, hkv, d), 22)
    kw = dict(causal=causal, window=window, attn_softcap=cap, q_offset=off)
    got = L.gqa_attention(_t(q), _t(k), _t(v), **kw)
    want = RL.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    assert got.shape == (b, sq, hq, d)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_the_reference(window):
    q = _rand((2, 1, 4, 16), 30)
    kc = _rand((2, 24, 2, 16), 31)
    vc = _rand((2, 24, 2, 16), 32)
    got = L.decode_attention(_t(q), _t(kc), _t(vc), 17, window=window,
                             attn_softcap=20.0)
    want = RL.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(17), window=window, attn_softcap=20.0)
    _close(got, want)


def test_inits_have_the_reference_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    got = {
        "dense": L.dense_init(gen, 8, 12, torch.bfloat16, CPU),
        "rms": L.rmsnorm_init(8, device=CPU),
        "ln": L.layernorm_init(8, device=CPU),
        "emb": L.embedding_init(gen, 10, 8, device=CPU),
        "swiglu": L.swiglu_init(gen, 8, 16, device=CPU),
        "gelu": L.gelu_mlp_init(gen, (8, 32, 8), device=CPU),
    }
    key = jax.random.key(0)
    want = jax.eval_shape(lambda: {  # shapes and dtypes, nothing compiled
        "dense": RL.dense_init(key, 8, 12, jnp.bfloat16),
        "rms": RL.rmsnorm_init(8),
        "ln": RL.layernorm_init(8),
        "emb": RL.embedding_init(key, 10, 8),
        "swiglu": RL.swiglu_init(key, 8, 16),
        "gelu": RL.gelu_mlp_init(key, (8, 32, 8)),
    })
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want)
    assert jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got
    ) == shapes
    assert float(got["emb"]["table"].std()) == pytest.approx(0.02, rel=0.5)


def test_param_tree_holds_the_nested_layout_as_a_module():
    tree = {"a": torch.ones(2), "b": {"c": torch.zeros(3)},
            "d": [{"e": torch.ones(1)}, {"e": torch.zeros(1)}]}
    mod = L.ParamTree(tree)
    assert sorted(n for n, _ in mod.named_parameters()) == [
        "a", "b.c", "d.i0.e", "d.i1.e"]
    assert not any(p.requires_grad for p in mod.parameters())
    back = mod.tree()
    assert isinstance(back["d"], list) and torch.equal(back["b"]["c"], tree["b"]["c"])
    assert L.as_tree(back) is back


# ------------------------------------------------------------------ configs
def test_configs_equal_the_reference_field_by_field():
    for arch in ("smollm-135m", "bert4rec"):
        mine, theirs = get_arch(arch), ref_get_arch(arch)
        assert dataclasses.asdict(mine.CONFIG) == dataclasses.asdict(theirs.CONFIG)
        assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(theirs.reduced())
        assert [(s.name, s.kind, s.params) for s in mine.SHAPES] == \
            [(s.name, s.kind, s.params) for s in theirs.SHAPES]
    cfg, ref_cfg = get_arch("smollm-135m").CONFIG, ref_get_arch("smollm-135m").CONFIG
    assert (cfg.params_dense, cfg.params_active) == \
        (ref_cfg.params_dense, ref_cfg.params_active)
    moe = dataclasses.replace(cfg, moe=True, n_experts=8, top_k=2)
    ref_moe = dataclasses.replace(ref_cfg, moe=True, n_experts=8, top_k=2)
    assert (moe.params_dense, moe.params_active) == \
        (ref_moe.params_dense, ref_moe.params_active)


LM_ARCHS = ("gemma2-2b", "mistral-nemo-12b", "moonshot-v1-16b-a3b",
            "kimi-k2-1t-a32b")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_family_configs_equal_the_reference_field_by_field(arch):
    mine, theirs = get_arch(arch), ref_get_arch(arch)
    assert dataclasses.asdict(mine.CONFIG) == dataclasses.asdict(theirs.CONFIG)
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(theirs.reduced())
    assert [(s.name, s.kind, s.params) for s in mine.SHAPES] == \
        [(s.name, s.kind, s.params) for s in theirs.SHAPES]
    cfg, ref_cfg = mine.CONFIG, theirs.CONFIG
    assert (cfg.params_dense, cfg.params_active) == \
        (ref_cfg.params_dense, ref_cfg.params_active)


def test_registry_has_the_ported_archs_and_names_the_queue_for_the_rest():
    """Every arch of the reference is ported: the registries list the same
    archs in the same order, and an unknown arch still raises."""
    assert list_archs() == ref_list_archs()
    assert {"pir-ct", "smollm-135m", "bert4rec", *LM_ARCHS} < set(list_archs())
    for arch in list_archs():
        assert get_arch(arch).CONFIG.name == arch
    with pytest.raises(KeyError, match="unknown"):
        get_arch("no-such-arch")


def test_lm_batch_equals_the_reference():
    cfg = get_arch("smollm-135m").reduced()
    for seed, step in ((0, 0), (3, 7)):
        np.testing.assert_array_equal(
            lm_batch(cfg, 3, 40, seed, step)["tokens"],
            ref_pipeline.lm_batch(cfg, 3, 40, seed, step)["tokens"])


# ------------------------------------------------------------------ SmolLM
@pytest.fixture(scope="module")
def smollm():
    ref_cfg = ref_get_arch("smollm-135m").reduced()
    cfg = get_arch("smollm-135m").reduced()
    params = RT.init_lm(jax.random.key(0), ref_cfg)
    tree = jax.tree.map(np.asarray, params)
    model = convert.lm_params_from_numpy(tree, cfg, device=CPU)
    tokens = lm_batch(cfg, 2, 16, seed=0, step=0)["tokens"]
    return ref_cfg, cfg, params, tree, model, tokens


def test_weights_round_trip_through_convert(smollm):
    _, cfg, _, tree, model, _ = smollm
    assert isinstance(model, T.TransformerLM) and model.cfg == cfg
    back = convert.lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, tree)))


def test_prefill_then_decode_match_the_reference(smollm):
    ref_cfg, cfg, params, _, model, tokens = smollm
    want_logits, want_cache = RT.prefill(params, ref_cfg, jnp.asarray(tokens), 32)
    logits, cache = T.prefill(model, cfg, tokens, 32)
    assert logits.shape == (2, cfg.vocab)
    assert cache.k.shape == (cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.head_dim)
    _close(logits, want_logits, LM_TOL)
    _close(cache.k, want_cache.k, LM_TOL)
    _close(cache.v, want_cache.v, LM_TOL)

    tok = np.argmax(np.asarray(want_logits), axis=-1)[:, None].astype(np.int32)
    want2, want_cache2 = RT.decode_step(params, ref_cfg, want_cache,
                                        jnp.asarray(tok), 16)
    logits2, cache2 = T.decode_step(model, cfg, cache, tok, 16)
    _close(logits2, want2, LM_TOL)
    # decode writes position 16 into the cache in place and returns it;
    # the values equal the reference's functional update
    assert cache2.k is cache.k and cache2.v is cache.v
    _close(cache2.k, want_cache2.k, LM_TOL)
    _close(cache2.v, want_cache2.v, LM_TOL)


def test_bf16_weights_carry_across_bit_for_bit():
    ref_cfg = dataclasses.replace(ref_get_arch("smollm-135m").reduced(),
                                  dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("smollm-135m").reduced(), dtype="bfloat16")
    params = RT.init_lm(jax.random.key(1), ref_cfg)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                         device=CPU)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(model.tree()))
    widened = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    back = convert.lm_params_to_numpy(model)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, widened)))


def test_prefill_takes_the_nested_tree_as_well_as_the_module(smollm):
    _, cfg, _, _, model, tokens = smollm
    a, _ = T.prefill(model, cfg, tokens, 16)
    b, _ = T.prefill(model.tree(), cfg, torch.from_numpy(tokens), 16)
    assert torch.equal(a, b)


def test_init_lm_has_the_reference_layout(smollm):
    ref_cfg, cfg, params, _, _, _ = smollm
    model = T.init_lm(torch.Generator().manual_seed(0), cfg, device=CPU)
    shapes = jax.tree.map(lambda a: tuple(a.shape), params)
    assert jax.tree.map(lambda t: tuple(t.shape), model.tree()) == shapes
    windows = T._layer_windows(dataclasses.replace(cfg, local_global=True, window=8))
    np.testing.assert_array_equal(
        windows.numpy(),
        np.asarray(RT._layer_windows(dataclasses.replace(ref_cfg, local_global=True, window=8))))


def test_entry_points_default_to_the_card_and_refuse_what_is_not_ported(
        smollm, monkeypatch):
    _, cfg, _, _, model, tokens = smollm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_lm(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_params_from_numpy(convert.lm_params_to_numpy(model), cfg)
    # a MoE config initialises and prefills on the CPU (it raised before
    # the MoE block was ported)
    moe = dataclasses.replace(cfg, moe=True, n_experts=4, top_k=2)
    moe_model = T.init_lm(torch.Generator(), moe, device=CPU)
    assert "moe" in moe_model.tree()["layers"]
    logits, _ = T.prefill(moe_model, moe, tokens, 16)
    assert logits.shape == (2, moe.vocab) and torch.isfinite(logits).all()
    # kv_seq_axes with no mesh active: the dense result, exactly
    q, k, v = (_t(_rand(s, 30 + i)) for i, s in enumerate(
        ((1, 1, 2, 8), (1, 4, 2, 8), (1, 4, 2, 8))))
    assert torch.equal(L.decode_attention(q, k, v, 2, kv_seq_axes=("data",)),
                       L.decode_attention(q, k, v, 2))
    # the reference clamps an out-of-range decode position; the port refuses it
    _, cache = T.prefill(model, cfg, tokens, 16)
    with pytest.raises(ValueError, match="outside"):
        T.decode_step(model, cfg, cache, tokens[:, :1], 16)


# ------------------------------------------------------ the rest of the LMs
@pytest.fixture(scope="module", params=LM_ARCHS)
def lm_arch(request):
    arch = request.param
    ref_cfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    params = RT.init_lm(jax.random.key(3), ref_cfg)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, device=CPU)
    tokens = lm_batch(cfg, 2, 20, seed=1, step=0)["tokens"]
    return arch, ref_cfg, cfg, params, model, tokens


def test_prefill_then_four_decode_steps_match_the_reference(lm_arch):
    """gemma-2's window (8 in ``reduced()``, so 20 tokens are masked by it)
    and caps, Mistral-NeMo's rope base, the MoE archs' routing."""
    _, ref_cfg, cfg, params, model, tokens = lm_arch
    want, want_cache = RT.prefill(params, ref_cfg, jnp.asarray(tokens), 24)
    got, cache = T.prefill(model, cfg, tokens, 24)
    _close(got, want, LM_TOL)
    _close(cache.k, want_cache.k, LM_TOL)
    _close(cache.v, want_cache.v, LM_TOL)
    for pos in range(20, 24):
        tok = np.argmax(np.asarray(want), axis=-1)[:, None].astype(np.int32)
        want, want_cache = RT.decode_step(params, ref_cfg, want_cache,
                                          jnp.asarray(tok), pos)
        got, cache = T.decode_step(model, cfg, cache, tok, pos)
        _close(got, want, LM_TOL)
    _close(cache.k, want_cache.k, LM_TOL)
    _close(cache.v, want_cache.v, LM_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_has_the_reference_layout_and_dtypes(lm_arch, dtype):
    arch, ref_cfg, cfg, _, _, _ = lm_arch
    ref_cfg = dataclasses.replace(ref_cfg, dtype=dtype)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = T.init_lm(torch.Generator().manual_seed(0), cfg, device=CPU)
    want = jax.eval_shape(lambda: RT.init_lm(jax.random.key(0), ref_cfg))
    assert jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        model.tree()) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), want)
    if cfg.moe:
        assert model.tree()["layers"]["moe"]["router"].dtype == torch.float32
