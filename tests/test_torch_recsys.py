"""The port's recommenders against the JAX package on the CPU: FM, DLRM-RM2
and DIEN (configs, batches, weights carried across by
``repro_torch.convert``, scores), ``embedding_bag``, ``bce_loss``,
BERT4Rec's masked-item loss, and the retrieval tower of every family.
Then the private lookups: scores through ``PrivateEmbedding`` (every scheme
for DLRM, Sparse-PIR for FM and DIEN) and through
``ServingPipeline.submit_many`` with its cache, which must give the plain
scores bit for bit, as tests/test_private_models.py checks for the
reference.

Tolerance: 1e-5 against the reference (float32; the packages' CPU kernels
sum in other orders); 0 between the private and the plain port, and
between the port's segment sum and a sequential sum of the same rows
where the sum order is fixed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import pipeline as ref_pipeline
from repro.models import recsys as RR
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import PrivateEmbedding, SparseScheme
from repro_torch.core.accounting import PrivacyBudget
from repro_torch.data import bert4rec_batch, recsys_batch
from repro_torch.db.store import RecordStore
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.serve import BatchScheduler, QueryCache, ServingPipeline

from _torch_parity import CPU

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = {"fm": (RR.fm_init, RR.fm_score, R.fm_score),
         "dlrm-rm2": (RR.dlrm_init, RR.dlrm_score, R.dlrm_score),
         "dien": (RR.dien_init, RR.dien_score, R.dien_score)}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    """(arch, ref cfg, cfg, ref params, numpy tree, port model, batch of 4)."""
    arch = request.param
    ref_cfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    params = ARCHS[arch][0](jax.random.key(0), ref_cfg)
    tree = jax.tree.map(np.asarray, params)
    mine = convert.recsys_params_from_numpy(tree, cfg, device=CPU)
    return arch, ref_cfg, cfg, params, tree, mine, recsys_batch(cfg, 4, 0, 0)


@pytest.mark.parametrize("arch", ["fm", "dlrm-rm2", "dien", "bert4rec"])
def test_configs_equal_the_reference_field_by_field(arch):
    mine, theirs = get_arch(arch), ref_get_arch(arch)
    assert dataclasses.asdict(mine.CONFIG) == dataclasses.asdict(theirs.CONFIG)
    assert dataclasses.asdict(mine.reduced()) == \
        dataclasses.asdict(theirs.reduced())
    assert [(s.name, s.kind, s.params) for s in mine.SHAPES] == \
        [(s.name, s.kind, s.params) for s in theirs.SHAPES]


@pytest.mark.parametrize("seed,step", [(0, 0), (5, 3)])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_recsys_batch_equals_the_reference(arch, seed, step):
    cfg = get_arch(arch).reduced()
    got = recsys_batch(cfg, 6, seed=seed, step=step)
    want = ref_pipeline.recsys_batch(ref_get_arch(arch).reduced(), 6,
                                     seed=seed, step=step)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_recsys_batch_refuses_another_family():
    with pytest.raises(ValueError):
        recsys_batch(get_arch("bert4rec").reduced(), 2, 0, 0)


def test_weights_round_trip_and_init_has_the_reference_layout(model):
    arch, _, cfg, params, tree, mine, _ = model
    back = convert.recsys_params_to_numpy(mine)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, tree)))
    init = {"fm": R.fm_init, "dlrm-rm2": R.dlrm_init,
            "dien": R.dien_init}[arch](_gen(0), cfg, device=CPU)
    assert type(init) is type(mine)
    assert jax.tree.map(lambda t: tuple(t.shape), init.tree()) == \
        jax.tree.map(lambda a: tuple(a.shape), params)
    assert not any(p.requires_grad for p in init.parameters())


def test_convert_refuses_a_tree_of_another_config(model):
    arch, _, cfg, _, tree, _, _ = model
    other = dataclasses.replace(cfg, vocab_per_field=cfg.vocab_per_field + 1)
    with pytest.raises(ValueError, match="config wants"):
        convert.recsys_params_from_numpy(tree, other, device=CPU)
    with pytest.raises(ValueError, match="no FM/DLRM/DIEN"):
        convert.recsys_params_from_numpy(
            tree, get_arch("bert4rec").reduced(), device=CPU)


def test_scores_match_the_reference(model):
    arch, ref_cfg, cfg, params, _, mine, batch = model
    got = ARCHS[arch][2](mine, cfg, batch)
    assert got.shape == (4,)
    want = ARCHS[arch][1](params, ref_cfg, _jnp(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        R.bce_loss(got, batch["label"]).item(),
        float(RR.bce_loss(want, jnp.asarray(batch["label"]))), **TOL)


def test_user_vector_and_retrieval_scores_match_the_reference(model):
    arch, ref_cfg, cfg, params, _, mine, batch = model
    uv = R.user_vector(mine, cfg, batch)
    want = RR.user_vector(params, ref_cfg, _jnp(batch))
    assert uv.shape == (4, cfg.embed_dim)
    np.testing.assert_allclose(uv.numpy(), np.asarray(want), **TOL)
    cand = np.random.default_rng(3).standard_normal(
        (50, cfg.embed_dim)).astype(np.float32)
    np.testing.assert_allclose(
        R.retrieval_scores(uv, torch.from_numpy(cand)).numpy(),
        np.asarray(RR.retrieval_scores(want, jnp.asarray(cand))), **TOL)


@pytest.fixture(scope="module")
def bert4rec():
    ref_cfg = ref_get_arch("bert4rec").reduced()
    cfg = get_arch("bert4rec").reduced()
    params = RR.bert4rec_init(jax.random.key(0), ref_cfg)
    mine = convert.bert4rec_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, device=CPU)
    return ref_cfg, cfg, params, mine


@pytest.mark.parametrize("seq_len", [16, 12])  # 8 chunks; one chunk
def test_bert4rec_masked_xent_matches_the_reference(bert4rec, seq_len):
    ref_cfg, cfg, params, mine = bert4rec
    ref_cfg = dataclasses.replace(ref_cfg, seq_len=seq_len)
    cfg = dataclasses.replace(cfg, seq_len=seq_len)
    batch = bert4rec_batch(cfg, 3, seed=1, step=2)
    got = R.bert4rec_masked_xent(mine, cfg, batch)
    want = RR.bert4rec_masked_xent(params, ref_cfg, _jnp(batch))
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_bert4rec_user_vector_and_retrieval_match_the_reference(bert4rec):
    ref_cfg, cfg, params, mine = bert4rec
    batch = bert4rec_batch(cfg, 3, seed=0, step=0)
    uv = R.user_vector(mine, cfg, batch)
    want = RR.user_vector(params, ref_cfg, _jnp(batch))
    np.testing.assert_allclose(uv.numpy(), np.asarray(want), **TOL)
    cand = mine.tree()["embed"]
    np.testing.assert_allclose(
        R.retrieval_scores(uv, cand).numpy(),
        np.asarray(RR.retrieval_scores(want, params["embed"])), **TOL)


# --------------------------------------------------------------- the bags
def _bags(seed, nnz=40, num_bags=7, vocab=30, dim=5):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((vocab, dim)).astype(np.float32)
    ids = rng.integers(0, vocab, nnz).astype(np.int32)
    # bag 0 heavily duplicated, bag 3 empty, ids past the end dropped
    seg = rng.choice([0, 0, 0, 1, 2, 4, 5, 6, 9], nnz).astype(np.int32)
    return table, ids, seg, num_bags


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_matches_the_reference(combiner):
    table, ids, seg, num_bags = _bags(0)
    got = R.embedding_bag(torch.from_numpy(table), ids, seg, num_bags,
                          combiner)
    want = RR.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(seg), num_bags, combiner)
    assert got.shape == (num_bags, table.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[3].any()
    # the lookup is the caller's: a doubled table doubles every bag
    doubled = R.embedding_bag(torch.from_numpy(table), ids, seg, num_bags,
                              combiner, lookup_fn=lambda t, i: 2 * t[i])
    np.testing.assert_array_equal(doubled.numpy(), 2 * got.numpy())
    with pytest.raises(ValueError, match="combiner"):
        R.embedding_bag(torch.from_numpy(table), ids, seg, num_bags, "max")


def test_segment_sum_matches_the_reference_and_sums_in_row_order():
    rng = np.random.default_rng(4)
    data = rng.standard_normal((200, 3)).astype(np.float32)
    seg = rng.integers(-2, 12, 200).astype(np.int32)
    got = L.segment_sum(torch.from_numpy(data), seg, 10)
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(seg), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # each segment is its rows summed one by one, in their order
    seq = np.zeros((10, 3), np.float32)
    for row, s in zip(data, seg):
        if 0 <= s < 10:
            seq[s] += row
    np.testing.assert_array_equal(got.numpy(), seq)
    with pytest.raises(ValueError, match="segment ids"):
        L.segment_sum(torch.from_numpy(data), seg[:5], 10)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_private_bags_equal_the_plain_bags_bit_for_bit(combiner):
    table, ids, seg, num_bags = _bags(1)
    pe = PrivateEmbedding.create(torch.from_numpy(table), scheme="sparse",
                                 d=4, d_a=2, theta=0.25)
    private = pe.bag_lookup(_gen(2), ids, seg, num_bags, combiner)
    plain = R.embedding_bag(torch.from_numpy(table), ids, seg, num_bags,
                            combiner)
    np.testing.assert_array_equal(private.numpy(), plain.numpy())


# --------------------------------------------------------- private scores
def _private_lookup(scheme, seed=7, **kw):
    """A lookup_fn that fetches every id through ``PrivateEmbedding`` (one
    per table: FM has two)."""
    gen, pes = _gen(seed), {}

    def lookup(table, ids):
        pe = pes.get(table.data_ptr())
        if pe is None:
            pe = pes[table.data_ptr()] = PrivateEmbedding.create(
                table, scheme=scheme, d=4, d_a=2, **kw)
        return pe.lookup(gen, ids)

    return lookup


@pytest.mark.parametrize("arch,scheme,kw", [
    ("dlrm-rm2", "chor", {}),
    ("dlrm-rm2", "sparse", dict(theta=0.25)),
    ("dlrm-rm2", "subset", dict(t=3)),
    ("dlrm-rm2", "direct", dict(p=16)),
    ("fm", "sparse", dict(theta=0.25)),
    ("dien", "sparse", dict(theta=0.25)),
])
def test_private_scores_equal_the_plain_scores_bit_for_bit(arch, scheme, kw):
    cfg = get_arch(arch).reduced()
    init, score = {"fm": (R.fm_init, R.fm_score),
                   "dlrm-rm2": (R.dlrm_init, R.dlrm_score),
                   "dien": (R.dien_init, R.dien_score)}[arch]
    params = init(_gen(0), cfg, device=CPU)
    batch = recsys_batch(cfg, 4, seed=0, step=0)
    plain = score(params, cfg, batch)
    private = score(params, cfg, batch,
                    lookup_fn=_private_lookup(scheme, **kw))
    np.testing.assert_array_equal(private.numpy(), plain.numpy())


def test_private_dlrm_through_the_serving_pipeline_and_its_cache():
    """Each example's 26 ids as one ``submit_many`` request, flushed alone
    (flat bucket 32); the same requests again come from the cache, spend
    their ε all the same, and give the same bits."""
    cfg = get_arch("dlrm-rm2").reduced()
    params = R.dlrm_init(_gen(0), cfg, device=CPU)
    batch = recsys_batch(cfg, 3, seed=1, step=0)
    table = params.tree()["embed"]
    store = RecordStore.from_float_table(table)
    scheme = SparseScheme(d=4, d_a=2, theta=0.25)
    budget = PrivacyBudget(epsilon_limit=1e6)
    pipe = ServingPipeline(
        store, scheme, scheduler=BatchScheduler(max_batch=32),
        cache=QueryCache(scheme, store.n, max_entries=1024),
        default_budget=lambda: budget, seed=42, device=CPU)

    def lookup(tbl, ids):
        assert tbl is table
        rows = []
        for j, row in enumerate(ids.tolist()):
            assert pipe.submit_many(f"user{j}", row)
            rows.append(pipe.flush()[f"user{j}"])
        raw = np.ascontiguousarray(np.stack(rows))   # [B, k, 4·dim] bytes
        return torch.from_numpy(raw.view(np.float32)).reshape(
            *ids.shape, tbl.shape[1])

    plain = R.dlrm_score(params, cfg, batch)
    first = R.dlrm_score(params, cfg, batch, lookup_fn=lookup)
    lookups = 3 * cfg.n_sparse
    assert pipe.metrics["queries"] == lookups
    assert pipe.metrics["batches"] == 3
    assert pipe.metrics["padded"] == 3 * (32 - cfg.n_sparse)
    again = R.dlrm_score(params, cfg, batch, lookup_fn=lookup)
    assert pipe.metrics["cache_hits"] == lookups
    assert pipe.metrics["batches"] == 3
    np.testing.assert_array_equal(first.numpy(), plain.numpy())
    np.testing.assert_array_equal(again.numpy(), plain.numpy())
    assert budget.spent_epsilon == pytest.approx(
        2 * lookups * scheme.privacy(store.n)[0])
